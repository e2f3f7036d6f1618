"""Training-time augmentation (port of ``lightning_asr_tpu/ops/augment.py``:
``sub_sequence_crop``, ``wave_crop``, ``spec_augment``, ``cutout`` and
``sample_aug``).

  * ``sub_sequence_crop``: the reference's crop window on the host, from a
    ``np.random.Generator`` (the same draws as the JAX package's, so the
    same window): ``target = int(len · U(w, 1))``, ``offset = int(U(0, len -
    target))``; returns (offset, max(target - offset, 1)).

  * ``wave_crop``: the reference's random waveform crop (``sub_secquence``)
    on the device, for ``device_cache`` training, whose cached batches hold
    uncropped waves: ``target = int(len · U(w, 1))``, ``offset = int(U(0,
    len - target))``, the crop window ``[offset, target)`` shifted to start
    at 0, and the sample before it returned for the preemphasis.

  * ``spec_augment``: ONE random frequency band and ONE random time band per
    sample, zeroed across the other axis.  A float width parameter is
    proportional to the sample's true extent (time: its valid frame count,
    frequency: n_mels), an int one is absolute; a band's start is drawn
    from ``U(0, extent - width)``.  Masked cells are set to 0 dB before
    normalization, like the reference.
  * ``cutout``: ``rect_masks`` random rectangles per sample.
  * ``sample_aug``: random dropout of mel cells: with p = U(0, prob), a
    cell is kept where ``round(U · 0.5 / (1 - p)) < 0.5``.

Random draws come from a ``torch.Generator`` (in a data-parallel step,
this rank's rows of the global batch's draw: ``parallel/mesh.py::draw``),
or are handed in as ``uniforms`` so that a test can feed both packages the
same numbers:
``jax.random`` and ``torch.Generator`` cannot give the same bits.  Given
the same uniforms the masks are the reference's bit for bit: widths and
starts are float32 products truncated to int32 on both sides.

On the mu-law wire ``wave_crop`` fills past the new length with code 128
(silence) and returns the sample before the crop decoded, where the JAX
package fills with code 0 (about -1.0) and returns the raw code (ROADMAP.md
§C1): an intended deviation.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..parallel.mesh import draw
from .frontend import expand_wire


def sub_sequence_crop(length: int, rng: np.random.Generator,
                      weight: float = 0.98) -> Tuple[int, int]:
    """The reference's crop window of a ``length``-sample wave: (offset,
    new_length), the slice ``wave[offset: offset + new_length]`` (the
    reference slices ``x[location:target_length]``)."""
    target_length = int(length * rng.uniform(weight, 1.0))
    location = int(rng.uniform(0, length - target_length))
    return location, max(target_length - location, 1)


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
    return draw(shape, generator, device, axis=-1)


def wave_crop(waves: torch.Tensor, wave_lens: torch.Tensor,
              generator: Optional[torch.Generator] = None, weight: float = 0.98,
              uniforms: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """The reference's random crop of (B, S) waves on their device.

    ``uniforms`` = (scale (B,) in [weight, 1), u (B,) in [0, 1)), the JAX
    package's two draws; without them both come from ``generator``.
    Returns ``(waves, new_lens, prev_samples)``: each row shifted left by
    its offset and filled past its new length with silence (0, or code 128
    on the mu-law wire), and the float sample before the crop (0 at offset
    0), as the host loader gives them."""
    B, S = waves.shape
    dev = waves.device
    if uniforms is None:
        if generator is None:
            raise ValueError("wave_crop needs a torch.Generator or explicit uniforms")
        u = draw((2, B), generator, dev, axis=-1)
        scale = torch.maximum(u[0] * (1.0 - weight) + weight,
                              torch.full((), weight, device=dev))
        uniforms = (scale, u[1])
    scale, u_off = (torch.as_tensor(a, dtype=torch.float32, device=dev) for a in uniforms)
    lens_f = wave_lens.to(device=dev, dtype=torch.float32)
    target = torch.floor(lens_f * scale).to(torch.int32)
    offset = torch.floor(u_off * (lens_f - target.to(torch.float32))).to(torch.int32)
    new_len = torch.clamp(target - offset, min=1)

    silence = 128 if waves.dtype == torch.uint8 else 0
    idx = torch.arange(S, device=dev)[None, :]
    src = (idx + offset[:, None].to(torch.int64)).clamp(max=S - 1)
    shifted = torch.gather(waves, 1, src)
    shifted = torch.where(idx < new_len[:, None], shifted,
                          torch.full((), silence, dtype=waves.dtype, device=dev))
    prev = expand_wire(torch.gather(waves, 1, (offset[:, None] - 1).clamp(min=0).to(torch.int64)))[:, 0]
    prev = torch.where(offset > 0, prev, torch.zeros((), dtype=torch.float32, device=dev))
    return shifted, new_len, prev


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


def sample_aug(feats: torch.Tensor, generator: Optional[torch.Generator] = None,
               prob: float = 0.4, uniforms: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
               ) -> torch.Tensor:
    """Random dropout of mel cells.  ``uniforms`` = (u_p (), u (feats'
    shape)) in [0, 1): the JAX package's draws, p = u_p · prob; without them
    both come from ``generator``."""
    if uniforms is None:
        if generator is None:
            raise ValueError("sample_aug needs a torch.Generator or explicit uniforms")
        u_p = torch.rand((), generator=generator, device=feats.device)   # one p for the batch
        u = draw(tuple(feats.shape), generator, feats.device)
    else:
        u_p, u = (torch.as_tensor(a, dtype=torch.float32, device=feats.device) for a in uniforms)
        if tuple(u.shape) != tuple(feats.shape) or u_p.dim() != 0:
            raise ValueError(f"uniforms must be a scalar and {tuple(feats.shape)}")
    p = u_p * prob
    mask = torch.round(u * (0.5 / (1.0 - p)))
    return feats * (mask < 0.5).to(feats.dtype)
