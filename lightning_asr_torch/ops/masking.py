"""Length and percentage masking helpers (port of
``lightning_asr_tpu/ops/masking.py``).

The reference carries sequence lengths as fractions of the padded length
("input_percentages") and recovers frame counts at each masking point as
``int(T · percent)``; these helpers convert between the two and reproduce
that recovery in float32, so masks and CTC lengths match to the frame.
"""

from __future__ import annotations

import torch


def percents_from_lengths(lengths: torch.Tensor, padded_len: int) -> torch.Tensor:
    """(B,) int lengths -> (B,) float32 fractions of ``padded_len``."""
    return lengths.to(torch.float32) / torch.tensor(padded_len, dtype=torch.float32)


def lengths_from_percents(percents: torch.Tensor, padded_len: int) -> torch.Tensor:
    """The reference's recovery ``int(T · percent)``, truncated in float32."""
    t = torch.tensor(padded_len, dtype=torch.float32, device=percents.device)
    return (t * percents.to(torch.float32)).to(torch.int32)


def length_mask(lengths: torch.Tensor, padded_len: int, dtype=torch.float32) -> torch.Tensor:
    """(B,) int lengths -> (B, padded_len) mask, 1 for t < length."""
    t = torch.arange(padded_len, device=lengths.device)[None, :]
    return (t < lengths[:, None]).to(dtype)


def mask_padding(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Zero the frames t >= length of x (B, T, ...)."""
    mask = length_mask(lengths, x.shape[1], x.dtype)
    return x * mask.reshape(mask.shape + (1,) * (x.ndim - 2))
