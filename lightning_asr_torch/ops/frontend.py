"""Batched log-mel frontend with torchaudio semantics (port of
``lightning_asr_tpu/ops/frontend.py``).

Pipeline, per utterance: optional dither, preemphasis 0.97, zero pad 32 +
reflect pad n_fft//2 around the TRUE length, windowed DFT (n_fft 512, hop
160, periodic Hann 320 centred), power, 64-bin HTK mel, ``10·log10(max(·,
1e-10))``; then per-utterance normalization with the unbiased std.

The DFT runs as hop-aligned frame matmuls: frame t covers hop-chunks t..t+3
of the extended signal, so ``spec[t] = Σ_j chunk[t+j] @ filters[:, j·hop :
(j+1)·hop]ᵀ``.  The ``"highest"`` and ``"high"`` tiers run it in float32;
the ``"default"`` (training) tier goes to the fused log-mel kernel
(``ops/frontend_kernels.py``), whose bf16-multiply / fp32-accumulate
numerics are the tier's definition.

Layouts: waves (B, S), features (B, T, n_mels).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..parallel.mesh import draw

PRECISIONS = ("highest", "high", "default")


@dataclass(frozen=True)
class MelFrontendConfig:
    sample_rate: int = 16000
    n_fft: int = 512
    win_length: int = 320        # 0.02 s at 16 kHz
    hop_length: int = 160        # win // 2
    n_mels: int = 64
    pad: int = 32                # constant zero pad (Spectrogram `pad=`)
    preemph: float = 0.97
    dither: float = 1e-5
    f_min: float = 0.0
    f_max: Optional[float] = None  # defaults to sr/2
    amin: float = 1e-10
    precision: str = "highest"

    def __post_init__(self):
        if self.precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}, got {self.precision!r}")

    @property
    def fmax(self) -> float:
        return self.f_max if self.f_max is not None else self.sample_rate / 2.0

    @property
    def n_freqs(self) -> int:
        return self.n_fft // 2 + 1

    @classmethod
    def from_dict(cls, d: dict) -> "MelFrontendConfig":
        """Rebuild from a checkpoint-hparams dict (unknown keys ignored, so
        old checkpoints and future fields stay loadable)."""
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


def mel_num_frames(num_samples, cfg: MelFrontendConfig = MelFrontendConfig()):
    """Frame count for a signal of `num_samples` samples (int or tensor):
    1 + (num_samples + 2*pad + 2*(n_fft//2) - n_fft) // hop."""
    return 1 + (num_samples + 2 * cfg.pad + 2 * (cfg.n_fft // 2) - cfg.n_fft) // cfg.hop_length


def hann_window(win_length: int) -> np.ndarray:
    """Periodic Hann window, torch.hann_window(periodic=True)."""
    n = np.arange(win_length, dtype=np.float64)
    return (0.5 * (1.0 - np.cos(2.0 * math.pi * n / win_length))).astype(np.float64)


def mel_filterbank(cfg: MelFrontendConfig) -> np.ndarray:
    """HTK-scale triangular filterbank, no norm — torchaudio
    ``create_fb_matrix`` semantics. Shape (n_freqs, n_mels)."""
    all_freqs = np.linspace(0.0, cfg.sample_rate // 2, cfg.n_freqs, dtype=np.float64)

    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + f / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)

    m_pts = np.linspace(hz_to_mel(cfg.f_min), hz_to_mel(cfg.fmax), cfg.n_mels + 2)
    f_pts = mel_to_hz(m_pts)

    f_diff = f_pts[1:] - f_pts[:-1]                      # (n_mels+1,)
    slopes = f_pts[None, :] - all_freqs[:, None]         # (n_freqs, n_mels+2)
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    return fb.astype(np.float32)


def dft_filters(cfg: MelFrontendConfig) -> np.ndarray:
    """Windowed DFT as filters: (2*n_freqs, n_fft) float32.
    Rows [0, n_freqs) are cos (real part), [n_freqs, 2*n_freqs) are -sin
    (imag part).  The win_length window is centred in the n_fft frame the
    way torch.stft pads it."""
    n_fft, win, n_freqs = cfg.n_fft, cfg.win_length, cfg.n_freqs
    w = np.zeros(n_fft, dtype=np.float64)
    left = (n_fft - win) // 2
    w[left : left + win] = hann_window(win)
    n = np.arange(n_fft, dtype=np.float64)
    k = np.arange(n_freqs, dtype=np.float64)
    ang = 2.0 * math.pi * k[:, None] * n[None, :] / n_fft
    cos_f = np.cos(ang) * w[None, :]
    sin_f = -np.sin(ang) * w[None, :]
    return np.concatenate([cos_f, sin_f], axis=0).astype(np.float32)


def expand_wire(waves: torch.Tensor) -> torch.Tensor:
    """Expand a host wire format to float32: int16 PCM (/32768) or uint8
    mu-law (closed-form G.711 inverse); anything else is cast."""
    if waves.dtype == torch.int16:
        return waves.to(torch.float32) * (1.0 / 32768.0)
    if waves.dtype == torch.uint8:
        y = (waves.to(torch.float32) - 128.0) * (1.0 / 127.0)
        return torch.sign(y) * (torch.exp(y.abs() * np.float32(np.log(256.0)))
                                - 1.0) * (1.0 / 255.0)
    return waves.to(torch.float32)


def _preemphasis(waves: torch.Tensor, prev_samples: Optional[torch.Tensor],
                 coeff: float) -> torch.Tensor:
    """y'[t] = y[t] - c*y[t-1]; the first sample subtracts `prev_samples`
    (the raw sample preceding a crop) or nothing."""
    prev = torch.cat([torch.zeros_like(waves[:, :1]), waves[:, :-1]], dim=1)
    if prev_samples is not None:
        prev[:, 0] = prev_samples
    return waves - coeff * prev


def _extend_signal(waves: torch.Tensor, wave_lens: torch.Tensor,
                   cfg: MelFrontendConfig) -> torch.Tensor:
    """Per-sample (zero-pad `pad` | reflect-pad n_fft//2) extension of a
    padded batch: for a row of true length L, z = [pad zeros | y[:L] | pad
    zeros] reflected by n_fft//2 at both ends (reflect excludes the edge).

    Output (B, S + 2*pad + n_fft).  Samples past each row's length are
    masked first.  Needs L > n_fft//2 + pad (shorter utterances are outside
    the reference's support as well)."""
    B, S = waves.shape
    half, pad = cfg.n_fft // 2, cfg.pad
    out_len = S + 2 * pad + cfg.n_fft
    lens = wave_lens.to(device=waves.device, dtype=torch.int64)

    idx = torch.arange(S, device=waves.device)
    y = torch.where(idx[None, :] < lens[:, None], waves, torch.zeros((), dtype=waves.dtype,
                                                                      device=waves.device))
    q = torch.zeros((B, out_len), dtype=waves.dtype, device=waves.device)

    # head: q[j] = y[half - pad - j] where the mirror lands in the signal;
    # pad=0 shifts the window by one (reflect excludes the boundary sample)
    n_head = min(half - pad + 1, half)
    head_start = (half - pad + 1) - n_head
    q[:, :n_head] = torch.flip(y[:, head_start : half - pad + 1], dims=(1,))
    q[:, half + pad : half + pad + S] = y

    # tail at j = L + 2*pad + half + w, w in [0, half): the end mirror gives
    # y[L + pad - 2 - w] for w >= pad - 1 and a zero-pad sample before that
    tail_zeros = max(pad - 1, 0)
    w = torch.arange(tail_zeros, half, device=waves.device)
    src = (lens[:, None] + pad - 2 - w[None, :]).clamp(0, S - 1)
    dst = lens[:, None] + 2 * pad + half + w[None, :]
    q.scatter_(1, dst, torch.gather(y, 1, src))
    return q


def _frame_dft(q: torch.Tensor, filters: torch.Tensor, cfg: MelFrontendConfig,
               T: int) -> torch.Tensor:
    """(B, >=(T+n_chunks)*hop) signal, (2F, n_fft) filters -> (B, T, 2F)
    spectrum, summed over hop-wide chunks in chunk order, in the dtype given."""
    B = q.shape[0]
    hop, n_fft = cfg.hop_length, cfg.n_fft
    n_chunks = -(-n_fft // hop)
    qf = q[:, : (T + n_chunks) * hop].reshape(B, T + n_chunks, hop)
    spec = None
    for j in range(n_chunks):
        w = filters[:, j * hop : min((j + 1) * hop, n_fft)]   # (2F, <=hop)
        xj = qf[:, j : j + T, : w.shape[1]]
        part = torch.matmul(xj, w.t())
        spec = part if spec is None else spec + part
    return spec


def pad_for_frames(q: torch.Tensor, cfg: MelFrontendConfig, T: int) -> torch.Tensor:
    """Zero-extend the extended signal to the (T + n_chunks)·hop samples the
    chunked frame matmuls read."""
    needed = (T + -(-cfg.n_fft // cfg.hop_length)) * cfg.hop_length
    if q.shape[1] < needed:
        q = torch.cat([q, q.new_zeros((q.shape[0], needed - q.shape[1]))], dim=1)
    return q


def extended_batch(
    waves: torch.Tensor,
    wave_lens: torch.Tensor,
    cfg: MelFrontendConfig,
    generator: Optional[torch.Generator] = None,
    prev_samples: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, int]:
    """The signal the mel stage reads: wire expansion, dither (with a
    generator), then preemphasis, the per-row extension and the zero tail the
    frames need in one pass (kernel K6, ``ops/frontend_kernels.py``).
    Returns (q (B, max(S + 2·pad + n_fft, (T + n_chunks)·hop)) float32, T)."""
    from .frontend_kernels import extend_preemph

    waves = expand_wire(waves).contiguous()
    if generator is not None and cfg.dither > 0:
        waves = waves + cfg.dither * draw(waves.shape, generator, waves.device, normal=True)
    S_ext = waves.shape[1] + 2 * cfg.pad + cfg.n_fft
    T = (S_ext - cfg.n_fft) // cfg.hop_length + 1
    needed = (T + -(-cfg.n_fft // cfg.hop_length)) * cfg.hop_length
    q = extend_preemph(waves, wave_lens, prev_samples, cfg, max(S_ext, needed))
    return q, T


def log_mel_spectrogram(
    waves: torch.Tensor,
    wave_lens: torch.Tensor,
    cfg: MelFrontendConfig = MelFrontendConfig(),
    generator: Optional[torch.Generator] = None,
    prev_samples: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched log-mel frontend.

    Args:
      waves: (B, S) padded waveforms (float32, int16 or mu-law uint8).
      wave_lens: (B,) true sample counts.
      generator: enables dithering (training); serving passes none.
      prev_samples: optional (B,) raw sample preceding each crop window.

    Returns:
      mels: (B, T, n_mels) float32 log-mel (dB), un-normalized.
      mel_lens: (B,) int32 valid frame counts.
    """
    q, T = extended_batch(waves, wave_lens, cfg, generator, prev_samples)
    mel_lens = mel_num_frames(wave_lens.to(device=q.device, dtype=torch.int64), cfg).to(torch.int32)

    if cfg.precision == "default":
        from .frontend_kernels import mel_from_extended

        return mel_from_extended(q, cfg, T), mel_lens

    filters, fbank = _tables(cfg, q.device)
    spec = _frame_dft(q, filters, cfg, T)                  # (B, T, 2F) fp32
    F = cfg.n_freqs
    power = spec[..., :F] ** 2 + spec[..., F:] ** 2
    mel = torch.matmul(power, fbank)
    return 10.0 * torch.log10(torch.clamp(mel, min=cfg.amin)), mel_lens


@functools.lru_cache(maxsize=8)
def _tables(cfg: MelFrontendConfig, device: torch.device):
    """(DFT filters, mel filterbank) float32 on ``device``, uploaded once:
    a step uploads nothing, so a captured CUDA graph can hold it."""
    return (torch.from_numpy(dft_filters(cfg)).to(device),
            torch.from_numpy(mel_filterbank(cfg)).to(device))


def normalize_features(feats: torch.Tensor, feat_lens: torch.Tensor) -> torch.Tensor:
    """Per-utterance (x - mean)/std over *valid* frames with torch's unbiased
    (N-1) std, zeroing padded frames afterwards."""
    B, T, F = feats.shape
    lens = feat_lens.to(feats.device)
    mask = (torch.arange(T, device=feats.device)[None, :] < lens[:, None]).to(feats.dtype)
    n = (lens.to(feats.dtype) * F)[:, None, None]
    m3 = mask[:, :, None]
    mean = torch.sum(feats * m3, dim=(1, 2), keepdim=True) / n
    var = torch.sum(((feats - mean) * m3) ** 2, dim=(1, 2), keepdim=True) / torch.clamp(n - 1.0, min=1.0)
    out = (feats - mean) / torch.sqrt(torch.clamp(var, min=1e-20))
    return out * m3
