"""Training-time augmentation on log-mels (port of
``lightning_asr_tpu/ops/augment.py``: ``spec_augment`` and ``cutout``).

  * ``spec_augment``: ONE random frequency band and ONE random time band per
    sample, zeroed across the other axis.  A float width parameter is
    proportional to the sample's true extent (time: its valid frame count,
    frequency: n_mels), an int one is absolute; a band's start is drawn
    from ``U(0, extent - width)``.  Masked cells are set to 0 dB before
    normalization, like the reference.
  * ``cutout``: ``rect_masks`` random rectangles per sample.

Random draws come from a ``torch.Generator``, or are handed in as
``uniforms`` so that a test can feed both packages the same numbers:
``jax.random`` and ``torch.Generator`` cannot give the same bits.  Given
the same uniforms the masks are the reference's bit for bit: widths and
starts are float32 products truncated to int32 on both sides.

``wave_crop`` (the in-graph random crop of ``device_cache`` mode) is not
ported yet.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def _band_mask(size: int, start: torch.Tensor, width: torch.Tensor) -> torch.Tensor:
    """(B, size) boolean mask, True inside [start, start+width)."""
    idx = torch.arange(size, device=start.device)[None, :]
    return (idx >= start[:, None]) & (idx < (start + width)[:, None])


def _draw(uniforms, shape, generator, device) -> torch.Tensor:
    if uniforms is not None:
        u = torch.as_tensor(uniforms, dtype=torch.float32, device=device)
        if tuple(u.shape) != shape:
            raise ValueError(f"uniforms must have shape {shape}, got {tuple(u.shape)}")
        return u
    if generator is None:
        raise ValueError("augmentation needs a torch.Generator or explicit uniforms")
    return torch.rand(shape, generator=generator, device=device, dtype=torch.float32)


def spec_augment(feats: torch.Tensor, feat_lens: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 freq_mask: Union[int, float] = 27, time_mask: Union[int, float] = 0.07,
                 uniforms: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Batched SpecAugment on (B, T, F) log-mels.

    ``uniforms`` (4, B) in [0, 1), in the reference's key order: freq width,
    freq start, time width, time start."""
    B, T, F = feats.shape
    u_fw, u_fx, u_tw, u_tx = _draw(uniforms, (4, B), generator, feats.device)
    f_extent = torch.full((B,), F, dtype=torch.float32, device=feats.device)
    f_param = f_extent * freq_mask if isinstance(freq_mask, float) \
        else torch.full((B,), freq_mask, dtype=torch.float32, device=feats.device)
    t_extent = feat_lens.to(device=feats.device, dtype=torch.float32)
    t_param = t_extent * time_mask if isinstance(time_mask, float) \
        else torch.full((B,), time_mask, dtype=torch.float32, device=feats.device)

    w_f = (u_fw * f_param).to(torch.int32)
    w_t = (u_tw * t_param).to(torch.int32)
    x_f = (u_fx * (f_extent - w_f.to(torch.float32))).to(torch.int32)
    x_t = (u_tx * (t_extent - w_t.to(torch.float32))).to(torch.int32)

    fmask = _band_mask(F, x_f, w_f)[:, None, :]   # (B, 1, F)
    tmask = _band_mask(T, x_t, w_t)[:, :, None]   # (B, T, 1)
    return feats * (~(fmask | tmask)).to(feats.dtype)


def cutout(feats: torch.Tensor, generator: Optional[torch.Generator] = None,
           rect_masks: int = 5, rect_freq: int = 50, rect_time: int = 120,
           uniforms: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Zero ``rect_masks`` random rectangles per sample.  ``uniforms``
    (rect_masks, 4, B): freq width, time width, freq start, time start."""
    B, T, F = feats.shape
    u = _draw(uniforms, (rect_masks, 4, B), generator, feats.device)
    out = feats
    for i in range(rect_masks):
        u_wf, u_wt, u_xf, u_xt = u[i]
        w_f = (u_wf * rect_freq).to(torch.int32)
        w_t = (u_wt * rect_time).to(torch.int32)
        x_f = (u_xf * (F - w_f)).to(torch.int32)
        x_t = (u_xt * (T - w_t)).to(torch.int32)
        fmask = _band_mask(F, x_f, w_f)[:, None, :]
        tmask = _band_mask(T, x_t, w_t)[:, :, None]
        out = out * (~(fmask & tmask)).to(out.dtype)
    return out
