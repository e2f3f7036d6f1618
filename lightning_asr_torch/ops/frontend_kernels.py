"""The frontend's kernels: K1, the fused log-mel (windowed DFT + power + mel
+ dB in one pass), and K6, the fused preemphasis + signal extension.

Replaces ``lightning_asr_tpu/ops/frontend_pallas.py::_mel_kernel`` (wrapper
``mel_from_extended``), the ``"default"`` frontend tier that
``train.py`` selects and that ``AsrTranslator`` rebuilds from the checkpoint.

Per frame t of row b (hop 160, n_fft 512, F = 257 bins, 64 mels):

    spec[f] = Σ_n bf16(q[b, t·hop + n]) · bf16(W[f, n])   (fp32 sums, 4 hop chunks)
    power   = re² + im²                                    (fp32)
    mel[m]  = Σ_f bf16(power[f]) · bf16(fb[f, m])          (fp32 sums)
    out     = 10·log10(max(mel, amin))

What bounds it on the H100: the DFT, 2·514·512 flops a frame (6.7 GFLOP for
8 rows of 16 s), against ~12 MB of signal in and log-mels out; at bf16
tensor-core rate the flops take ~7 µs and the bytes ~4 µs, so the work is
compute-bound and everything between the signal and the log-mel must stay
on chip.

What the design does about it (``csrc/mel.cu``): one block per (row, tile of
32 frames) stages the tile's samples, rounded to bf16, in shared memory
once; frame t is read at offset t·hop, so the overlapping frames are never
copied.  The DFT matrix (512 × 2·320 bf16, bins padded to the block's
64-bin chunk) streams from L2 with coalesced loads; each thread keeps a
4-frame × 2-bin (re, im) register tile, so one load feeds two FMAs.  The
tile's power (32 × 257 fp32) stays in shared memory for the mel projection;
only the (32, 64) log-mel tile is written.  Products of bf16-rounded values
are exact in fp32, so scalar FMAs give the tier's bf16-multiply /
fp32-accumulate numerics; tensor cores (``mma.sync``/``wgmma``) are the
next step for speed.

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

import torch

from .frontend import (MelFrontendConfig, _extend_signal, _frame_dft, _preemphasis,
                       dft_filters, mel_filterbank, pad_for_frames)
from .kernel_build import SMEM_LIMIT

_LOCK = threading.Lock()
_TILE_FRAMES = 32           # frames per block (csrc/mel.cu TT)
_BIN_CHUNK = 64             # bins per block pass (csrc/mel.cu: 32 lanes × 2)


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
def _device_tables(cfg: MelFrontendConfig, device: torch.device):
    """(wt, fb) in the kernel's layouts: wt (n_fft, 2·FP) bf16 holds the cos
    rows then the -sin rows transposed, bins zero-padded to FP (a multiple of
    the 64-bin chunk) so that a warp's loads are aligned and coalesced; fb
    (F, n_mels) bf16."""
    F, FP = cfg.n_freqs, _round_up(cfg.n_freqs, _BIN_CHUNK)
    filt = torch.from_numpy(dft_filters(cfg))               # (2F, n_fft)
    wt = torch.zeros((cfg.n_fft, 2 * FP), dtype=torch.float32)
    wt[:, :F] = filt[:F].t()
    wt[:, FP : FP + F] = filt[F:].t()
    fb = torch.from_numpy(mel_filterbank(cfg))
    return (wt.to(torch.bfloat16).to(device).contiguous(),
            fb.to(torch.bfloat16).to(device).contiguous())


def smem_bytes(cfg: MelFrontendConfig) -> int:
    """Dynamic shared memory of one block: the tile's samples + its power."""
    span = (_TILE_FRAMES - 1) * cfg.hop_length + cfg.n_fft
    return 4 * (span + _TILE_FRAMES * cfg.n_freqs)


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
    smem = smem_bytes(cfg)
    if smem > SMEM_LIMIT:
        raise ValueError(f"config needs {smem} B of shared memory per block (> {SMEM_LIMIT})")

    from .kernel_build import library

    lib = library("mel")
    fn = lib.lasr_log_mel
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    B, Lq = q.shape
    wt, fb = _device_tables(cfg, q.device)
    out = torch.empty((B, T, cfg.n_mels), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), B, Lq, T, wt.data_ptr(), wt.shape[1] // 2,
             fb.data_ptr(), out.data_ptr(), cfg.hop_length, cfg.n_fft,
             cfg.n_freqs, cfg.n_mels, float(cfg.amin), smem, q.device.index, stream)
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
