"""Plain float32 reference of the log-mel frontend, SpecAugment and the
per-utterance normalization (torchaudio's ``Spectrogram`` + HTK
``MelScale`` semantics, as the reference project's ``AudioProcessor``
computes them).

Per row of true length L: int16 / 32768, dither (``dither`` x N(0, 1) from
the step's generator, drawn for the whole padded batch), preemphasis
y[t] - 0.97 y[t-1], zero pad ``pad`` each side, reflect pad n_fft // 2,
frames of n_fft every ``hop`` samples over the padded batch width, a
periodic Hann window of ``win_length`` centred in the frame, |rfft|^2,
the HTK mel filters (no norm), 10 log10(max(., amin)).  Valid frames:
1 + (L + 2 pad) // hop.

Random draws come from a ``torch.Generator`` in the order a train step
makes them: the dither (B, S) normal, then SpecAugment's (4, B) uniform.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .model import round_fp8


def hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)


def mel_filters(fe: dict) -> np.ndarray:
    """(n_fft // 2 + 1, n_mels) HTK triangular filters without norm."""
    sr, n_fft, n_mels = fe["sample_rate"], fe["n_fft"], fe["n_mels"]
    freqs = np.linspace(0.0, sr // 2, n_fft // 2 + 1)
    f_pts = mel_to_hz(np.linspace(hz_to_mel(fe.get("f_min", 0.0)), hz_to_mel(sr / 2.0),
                                  n_mels + 2))
    fb = np.zeros((freqs.size, n_mels))
    for m in range(n_mels):
        lo, c, hi = f_pts[m], f_pts[m + 1], f_pts[m + 2]
        fb[:, m] = np.maximum(0.0, np.minimum((freqs - lo) / (c - lo), (hi - freqs) / (hi - c)))
    return fb.astype(np.float32)


def frames_of(samples, fe: dict):
    """Mel frames of ``samples`` samples (int or tensor)."""
    return 1 + (samples + 2 * fe["pad"]) // fe["hop_length"]


def _dft(frames: torch.Tensor, win: torch.Tensor, n_fft: int, precision: str) -> torch.Tensor:
    """|DFT|^2 of windowed frames: ``rfft`` in float32, or with
    ``precision="fp8"`` the windowed-DFT table and the frames rounded to
    float8 before their float32 product (the control)."""
    if precision != "fp8":
        spec = torch.fft.rfft(frames * win, dim=-1)
        return spec.real ** 2 + spec.imag ** 2
    k = torch.arange(n_fft // 2 + 1, dtype=torch.float64)
    ang = 2.0 * math.pi * torch.arange(n_fft, dtype=torch.float64)[:, None] * k[None, :] / n_fft
    table = torch.cat([torch.cos(ang), -torch.sin(ang)], dim=1) * win.double().cpu()[:, None]
    spec = round_fp8(frames) @ round_fp8(table.float().to(frames.device))
    F = n_fft // 2 + 1
    return spec[..., :F] ** 2 + spec[..., F:] ** 2


def log_mel(waves: torch.Tensor, lens: torch.Tensor, fe: dict, generator=None,
            precision: str = "fp32"):
    """(B, S) int16 or float32 waves, (B,) lengths -> (feats (B, T, n_mels)
    float32, frames (B,) int64), T = 1 + (S + 2 pad) // hop.  ``precision``
    "fp8" rounds the DFT's and the mel filters' operands to float8 (the
    control of a frontend whose products the configuration states in
    bf16)."""
    dev = waves.device
    x = waves.to(torch.float32) / 32768.0 if waves.dtype == torch.int16 else waves.float()
    B, S = x.shape
    if generator is not None and fe["dither"] > 0:
        x = x + fe["dither"] * torch.randn((B, S), generator=generator, device=dev,
                                           dtype=torch.float32)
    lens = lens.to(device=dev, dtype=torch.int64)
    idx = torch.arange(S, device=dev)
    x = torch.where(idx[None, :] < lens[:, None], x, torch.zeros((), device=dev))
    x = x - fe["preemph"] * torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)
    pad, half, hop, n_fft = fe["pad"], fe["n_fft"] // 2, fe["hop_length"], fe["n_fft"]
    # z = [pad zeros | y[:L] | pad zeros], reflected by n_fft // 2 at both
    # ends (the edge sample not repeated), zeros after, over the batch width
    zlen = lens + 2 * pad
    T = 1 + (S + 2 * pad) // hop
    width = (T - 1) * hop + n_fft
    j = torch.arange(width, device=dev)[None, :] - half        # index into z
    j = torch.where(j < 0, -j, j)
    j = torch.where(j >= zlen[:, None], 2 * (zlen[:, None] - 1) - j, j)
    inside = (j >= pad) & (j < pad + lens[:, None]) \
        & (torch.arange(width, device=dev)[None, :] < zlen[:, None] + 2 * half)
    src = (j - pad).clamp(0, S - 1)
    ext = torch.where(inside, torch.gather(x, 1, src), torch.zeros((), device=dev))
    frames = ext.unfold(1, n_fft, hop)                          # (B, T, n_fft)
    win = torch.zeros(n_fft, dtype=torch.float64)
    left = (n_fft - fe["win_length"]) // 2
    n = torch.arange(fe["win_length"], dtype=torch.float64)
    win[left: left + fe["win_length"]] = 0.5 * (1.0 - torch.cos(2.0 * math.pi * n
                                                                  / fe["win_length"]))
    power = _dft(frames, win.to(device=dev, dtype=torch.float32), n_fft, precision)
    fb = torch.from_numpy(mel_filters(fe)).to(dev)
    mel = round_fp8(power) @ round_fp8(fb) if precision == "fp8" else power @ fb
    return 10.0 * torch.log10(torch.clamp(mel, min=fe["amin"])), frames_of(lens, fe)


def spec_augment(feats: torch.Tensor, frames: torch.Tensor, generator, freq_mask, time_mask):
    """One frequency band and one time band a row zeroed.  Widths: an int is
    absolute, a float a share (of n_mels, or of the row's valid frames);
    the draws (4, B): freq width, freq start, time width, time start; each
    product truncated to an integer in float32."""
    B, T, Fm = feats.shape
    dev = feats.device
    u_fw, u_fx, u_tw, u_tx = torch.rand((4, B), generator=generator, device=dev,
                                        dtype=torch.float32)
    f_ext = torch.full((B,), float(Fm), device=dev)
    t_ext = frames.to(device=dev, dtype=torch.float32)
    def width(extent, param):            # a float: a share of the extent; an int: absolute
        return extent * param if isinstance(param, float) else torch.full_like(extent,
                                                                             float(param))

    f_par, t_par = width(f_ext, freq_mask), width(t_ext, time_mask)
    w_f, w_t = (u_fw * f_par).to(torch.int64), (u_tw * t_par).to(torch.int64)
    x_f = (u_fx * (f_ext - w_f.float())).to(torch.int64)
    x_t = (u_tx * (t_ext - w_t.float())).to(torch.int64)
    fi, ti = torch.arange(Fm, device=dev)[None, :], torch.arange(T, device=dev)[None, :]
    fband = (fi >= x_f[:, None]) & (fi < (x_f + w_f)[:, None])
    tband = (ti >= x_t[:, None]) & (ti < (x_t + w_t)[:, None])
    return feats * (~(fband[:, None, :] | tband[:, :, None])).float()


def normalize(feats: torch.Tensor, frames: torch.Tensor) -> torch.Tensor:
    """(x - mean) / std over each row's valid frames and every mel bin
    (the unbiased std), pad frames zeroed."""
    B, T, Fm = feats.shape
    m = (torch.arange(T, device=feats.device)[None, :] < frames[:, None].to(feats.device))
    m = m.float()[:, :, None]
    n = (frames.to(feats.device).float() * Fm)[:, None, None]
    mean = (feats * m).sum(dim=(1, 2), keepdim=True) / n
    var = (((feats - mean) * m) ** 2).sum(dim=(1, 2), keepdim=True) / (n - 1).clamp(min=1)
    return (feats - mean) / var.clamp(min=1e-20).sqrt() * m


def features(waves, lens, fe: dict, generator=None, augment=None, precision: str = "fp32"):
    """A step's model input: (normalized feats (B, T, n_mels), percents (B,)
    = valid frames / T).  ``augment`` = (freq_mask, time_mask) applies
    SpecAugment from ``generator``; ``precision`` as ``log_mel``'s, where
    the configuration states the frontend's products in bf16."""
    feats, frames = log_mel(waves, lens, fe, generator,
                            precision if fe.get("precision") == "default" else "fp32")
    if augment is not None:
        feats = spec_augment(feats, frames, generator, *augment)
    feats = normalize(feats, frames)
    T = torch.full((), feats.shape[1], dtype=torch.float32, device=feats.device)
    return feats, frames.to(torch.float32) / T
