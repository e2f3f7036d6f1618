"""The frontend's kernels: K1, the fused log-mel (windowed DFT + power + mel
+ dB in one pass), and K6, the fused preemphasis + signal extension.

K1 replaces ``lightning_asr_tpu/ops/frontend_pallas.py:194`` ``_mel_kernel``
(wrapper ``mel_from_extended``), the ``"default"`` frontend tier that
``train.py`` selects and that ``AsrTranslator`` rebuilds from the checkpoint.

Per frame t of row b (hop 160, n_fft 512, F = 257 bins, 64 mels):

    spec[f] = Σ_n bf16(q[b, t·hop + n]) · bf16(W[f, n])   (fp32 sums)
    power   = re² + im²                                    (fp32, two roundings)
    mel[m]  = Σ_f bf16(power[f]) · bf16(fb[f, m])          (fp32 sums)
    out     = 10·log10(max(mel, amin))

Products of bf16 values are exact in fp32, so the kernel differs from the
plain version only in the order of the fp32 sums.

What bounds it on the H100: the DFT over the window's non-zero samples,
2·514·320 flops a frame (4.2 GFLOP for 8 rows of 16 s), against ~12 MB of
signal in and log-mels out; at the bf16 tensor-core rate the flops take
~4 µs and the bytes ~3.5 µs, so the work is compute-bound, reaches its
bound only on the tensor cores, and everything between the signal and the
log-mel must stay on chip.

What the design does about it (``csrc/mel.cu``): frames are the M dimension
of ``mma.sync`` m16n8k16, the table's columns the N, the frame's samples
the K.  One block per (row, 64 frames) stages its samples once, rounded to
bf16, one hop-wide chunk per shared-memory row; frame t starts at chunk t,
so ``ldmatrix`` reads the A fragments straight from the overlapping signal
(no im2col copy), and each warp keeps its 16 frames' fragments of the
first 20 steps in registers (a longer window reloads the rest each pass).
K runs only over the samples the window leaves non-zero, [96, 416) for the
default config (``kernel_layout``): the skipped table rows are exactly 0,
37.5% of the DFT.  The table interleaves 8 cos columns with the 8 -sin
columns of the same bins, so re and im of one (frame, bin) meet in one
thread's registers and the power is taken there; it streams through shared
memory in passes of 16 bins with ``cp.async`` double buffering, each pass
feeding 64 frames.  The bf16 power tile stays in shared memory and the mel
projection, bins padded to FP = 272 and mels to a multiple of 16, runs on
the tensor cores too; only the (64, n_mels) log-mel tile is written.  The
layout takes any hop that is a multiple of 16 samples.

K6 replaces ``lightning_asr_tpu/ops/frontend_pallas.py::_kernel`` (wrapper
``extend_preemph``): preemphasis (c = float32(0.97), the first sample
against ``prev_samples`` or nothing), the per-row zero-pad + reflect
extension around each true length, and the zero tail the frames read, as
one write of the extended signal.  Its plain version is the composition
``_extend_signal(_preemphasis(...))`` zero-extended to ``out_total``.  What
bounds it: bytes, one read of the waves and one write of q (~68 MB for 32
rows of 16.7 s: ~20 µs); it does two flops a sample.  The design
(``csrc/extend.cu``): one thread per output sample, a gather from the raw
row, so nothing is written twice and no intermediate reaches device memory.
The multiply and the subtract round separately, as PyTorch's two ops do:
the result equals the plain version bit for bit, so K1's bf16 roundings see
the same signal.  The TPU kernel's 128-lane alignment of the tail is TPU
layout and has no counterpart here.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Optional

import numpy as np
import torch

from .frontend import (MelFrontendConfig, _extend_signal, _frame_dft, _preemphasis,
                       dft_filters, mel_filterbank, pad_for_frames)
from .kernel_build import SMEM_LIMIT

_LOCK = threading.Lock()
_TILE_FRAMES = 64           # frames a block (csrc/mel.cu MT)
_PASS_COLS = 32             # table columns a pass: cos and -sin of 16 bins (NP)
_ROW_PAD = 8                # bf16 elements padding each shared-memory row (PAD)
_STEP = 16                  # samples (bins, mels) a tensor-core step: mma's k16


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Round to bf16 (nearest even) and back: the operand rounding of the
    tier's bf16 multiplies."""
    return x.to(torch.bfloat16).to(torch.float32)


def mel_from_extended_plain(q: torch.Tensor, cfg: MelFrontendConfig, T: int) -> torch.Tensor:
    """Plain PyTorch version of K1: the same chunk order, with bf16-rounded
    operands multiplied in float32 (their products are exact there)."""
    q = pad_for_frames(q, cfg, T)
    filters = _bf16(torch.from_numpy(dft_filters(cfg)).to(q.device))
    spec = _frame_dft(_bf16(q), filters, cfg, T)            # (B, T, 2F) fp32
    F = cfg.n_freqs
    power = spec[..., :F] ** 2 + spec[..., F:] ** 2
    fb = _bf16(torch.from_numpy(mel_filterbank(cfg)).to(q.device))
    mel = torch.matmul(_bf16(power), fb)
    return 10.0 * torch.log10(torch.clamp(mel, min=cfg.amin))


@functools.lru_cache(maxsize=8)
def window_range(cfg: MelFrontendConfig):
    """[n_lo, n_hi): the frame samples whose DFT table rows are not all
    zero, widened to whole 16-sample steps; [96, 416) for the default
    config (the periodic Hann window's first sample is 0 too).  Running the
    DFT over this range alone is exact: every skipped product is 0."""
    nz = np.flatnonzero(np.any(dft_filters(cfg) != 0, axis=0))
    return int(nz[0]) // _STEP * _STEP, _round_up(int(nz[-1]) + 1, _STEP)


@functools.lru_cache(maxsize=8)
def kernel_layout(cfg: MelFrontendConfig):
    """(n_lo, K, FP, NM) of the kernel's layout: the window's first sample,
    its length in samples, the bins and the mels padded to multiples of 16.
    Raises ValueError on a hop the kernel does not take: frame t starts at
    sample t·hop, and its 16-sample steps must stay 16-byte aligned within
    one hop-wide chunk."""
    if cfg.hop_length % _STEP:
        raise ValueError(f"the log-mel kernel needs hop_length % {_STEP} == 0, got {cfg.hop_length}")
    n_lo, n_hi = window_range(cfg)
    return n_lo, n_hi - n_lo, _round_up(cfg.n_freqs, _STEP), _round_up(cfg.n_mels, _STEP)


@functools.lru_cache(maxsize=8)
def _device_tables(cfg: MelFrontendConfig, device: torch.device):
    """(wt, fbt) in the kernel's layouts, bf16.  wt (2·FP, K + 8): the DFT
    table over the window's samples [n_lo, n_lo + K), one row a column of
    the product; rows 16g .. 16g+7 hold the cos of bins 8g .. 8g+7 and rows
    16g+8 .. 16g+15 their -sin, so pass p is the contiguous rows 32p ..
    32p+31.  fbt (NM, FP + 8): the filterbank transposed.  Bins past F,
    samples past n_fft, mels past n_mels and the 8 pad elements of each row
    are zero."""
    n_lo, K, FP, NM = kernel_layout(cfg)
    F = cfg.n_freqs
    filt = torch.from_numpy(dft_filters(cfg))[:, n_lo:n_lo + K]        # (2F, <= K)
    wt = torch.zeros((FP // 8, 2, 8, K + _ROW_PAD), dtype=torch.float32)
    for part in range(2):                                              # cos, -sin
        rows = torch.zeros((FP, K), dtype=torch.float32)
        rows[:F, :filt.shape[1]] = filt[part * F:(part + 1) * F]
        wt[:, part, :, :K] = rows.reshape(FP // 8, 8, K)
    fbt = torch.zeros((NM, FP + _ROW_PAD), dtype=torch.float32)
    fbt[:cfg.n_mels, :F] = torch.from_numpy(mel_filterbank(cfg)).t()
    return (wt.reshape(2 * FP, K + _ROW_PAD).to(torch.bfloat16).to(device).contiguous(),
            fbt.to(torch.bfloat16).to(device).contiguous())


def smem_bytes(cfg: MelFrontendConfig) -> int:
    """Dynamic shared memory of one block, the one statement of csrc/mel.cu's
    layout size: the tile's samples in hop-wide chunks, two table passes (or
    the filterbank), the power tile."""
    n_lo, K, FP, NM = kernel_layout(cfg)
    hop = cfg.hop_length
    chunks = _TILE_FRAMES + (n_lo + K - 1) // hop - n_lo // hop
    table = max(2 * _PASS_COLS * (K + _ROW_PAD), NM * (FP + _ROW_PAD))
    return 2 * (chunks * (hop + _ROW_PAD) + table + _TILE_FRAMES * (FP + _ROW_PAD))


def mel_from_extended(q: torch.Tensor, cfg: MelFrontendConfig, T: int) -> torch.Tensor:
    """(B, Lq) extended, preemphasized float32 signal -> (B, T, n_mels)
    log-mel dB.  Frame t reads q[:, t·hop : t·hop + n_fft]; samples past Lq
    count as zero.  A CPU tensor runs the plain version; a CUDA tensor
    launches the kernel or raises."""
    if q.dim() != 2 or q.dtype != torch.float32:
        raise ValueError(f"q must be a 2-D float32 tensor, got {tuple(q.shape)} {q.dtype}")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    if T < 1 or q.shape[0] < 1 or q.shape[1] < 1:
        raise ValueError(f"need T >= 1 and a non-empty q, got T={T}, q {tuple(q.shape)}")
    if q.device.type == "cpu":
        return mel_from_extended_plain(q, cfg, T)
    if q.device.type != "cuda":
        raise ValueError(f"mel_from_extended runs on cpu or cuda, not {q.device}")
    n_lo, K, FP, _ = kernel_layout(cfg)
    smem = smem_bytes(cfg)
    if smem > SMEM_LIMIT:
        raise ValueError(f"config needs {smem} B of shared memory per block (> {SMEM_LIMIT})")

    from .kernel_build import library

    fn = library("mel").lasr_log_mel
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
                   + [ctypes.c_int] * 5 + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    B, Lq = q.shape
    wt, fbt = _device_tables(cfg, q.device)
    out = torch.empty((B, T, cfg.n_mels), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), B, Lq, T, wt.data_ptr(), fbt.data_ptr(), out.data_ptr(),
             cfg.hop_length, n_lo, K, FP, cfg.n_mels, float(cfg.amin), smem, q.device.index,
             stream)
    if err != 0:
        raise RuntimeError(f"log-mel kernel launch failed: CUDA error {err}")
    with _LOCK:
        mel_from_extended.launches += 1
    return out


mel_from_extended.launches = 0


def extend_preemph_plain(waves: torch.Tensor, wave_lens: torch.Tensor,
                         prev_samples: Optional[torch.Tensor], cfg: MelFrontendConfig,
                         out_total: int) -> torch.Tensor:
    """Plain PyTorch version of K6: preemphasis, then the extension, then
    zeros up to ``out_total`` samples."""
    q = _extend_signal(_preemphasis(waves, prev_samples, cfg.preemph), wave_lens, cfg)
    if out_total > q.shape[1]:
        q = torch.cat([q, q.new_zeros((q.shape[0], out_total - q.shape[1]))], dim=1)
    return q


def extend_preemph(waves: torch.Tensor, wave_lens: torch.Tensor,
                   prev_samples: Optional[torch.Tensor], cfg: MelFrontendConfig,
                   out_total: int) -> torch.Tensor:
    """K6: (B, S) float32 waves (after wire expansion and dither), (B,)
    true lengths in [0, S], optional (B,) samples preceding each row
    -> (B, out_total) float32 extended, preemphasized signal;
    ``out_total >= S + 2·pad + n_fft``.  Rows of L <= n_fft//2 + pad samples
    lie outside the reference's support.  A CPU tensor runs the plain
    version; a CUDA tensor launches the kernel or raises."""
    if waves.dim() != 2 or waves.dtype != torch.float32 or not waves.is_contiguous():
        raise ValueError(f"waves must be a contiguous 2-D float32 tensor, got "
                         f"{tuple(waves.shape)} {waves.dtype}")
    B, S = waves.shape
    if tuple(wave_lens.shape) != (B,):
        raise ValueError(f"wave_lens must be ({B},), got {tuple(wave_lens.shape)}")
    if prev_samples is not None:
        if tuple(prev_samples.shape) != (B,):
            raise ValueError(f"prev_samples must be ({B},), got {tuple(prev_samples.shape)}")
        prev_samples = prev_samples.to(device=waves.device, dtype=torch.float32).contiguous()
    if out_total < S + 2 * cfg.pad + cfg.n_fft:
        raise ValueError(f"out_total {out_total} < S + 2·pad + n_fft = {S + 2 * cfg.pad + cfg.n_fft}")
    if waves.device.type == "cpu":
        return extend_preemph_plain(waves, wave_lens, prev_samples, cfg, out_total)
    if waves.device.type != "cuda":
        raise ValueError(f"extend_preemph runs on cpu or cuda, not {waves.device}")
    lens = wave_lens.to(device=waves.device, dtype=torch.int32).contiguous()

    from .kernel_build import library

    fn = library("extend").lasr_extend_preemph
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int,
                                                                ctypes.c_void_p]
    out = torch.empty((B, out_total), dtype=torch.float32, device=waves.device)
    if B:
        stream = torch.cuda.current_stream(waves.device).cuda_stream
        err = fn(waves.data_ptr(), lens.data_ptr(),
                 None if prev_samples is None else prev_samples.data_ptr(),
                 out.data_ptr(), B, S, out_total, cfg.n_fft // 2, cfg.pad, float(cfg.preemph),
                 waves.device.index, stream)
        if err != 0:
            raise RuntimeError(f"extend_preemph kernel launch failed: CUDA error {err}")
        with _LOCK:
            extend_preemph.launches += 1
    return out


extend_preemph.launches = 0
