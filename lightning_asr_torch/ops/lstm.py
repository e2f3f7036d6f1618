"""Length-masked (bi)LSTM — packed-sequence equivalent (port of
``lightning_asr_tpu/ops/lstm.py``).

Output frames at t >= lengths[b] are exactly zero, and the backward
direction starts its recurrence at each row's true last frame, as cuDNN's
BiLSTM over ``pack_padded_sequence`` inputs does.  Gate order and math
follow torch.nn.LSTM: gates [i, f, g, o], both b_ih and b_hh applied.

The input projection for all frames and both directions is one matmul
here; the recurrence is kernel K2 (``ops/lstm_kernels.py``).  The function
is differentiable: autograd takes ``dx``, ``dW_ih`` and the biases'
gradients through that matmul (as the JAX package leaves them to XLA,
``lstm_pallas.py:416``), and the recurrence's backward is kernel K3.

``fuse_directions=True`` is the JAX package's batch-stacked layout
(``LASR_LSTM_FUSED_BIDIR=1``, ``lstm_pallas.py:449-461``): both directions
become the 2B time-major rows of one recurrence, kernels K7 and K8, the
reverse rows holding the time-flipped projections with ``valid = (T-1-t) <
len``; their outputs are flipped back.  The function is the same.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .lstm_kernels import lstm_core, lstm_core_stacked


class LSTMWeights(NamedTuple):
    w_ih: torch.Tensor  # (4H, in)
    w_hh: torch.Tensor  # (4H, H)
    b_ih: torch.Tensor  # (4H,)
    b_hh: torch.Tensor  # (4H,)


def lstm(x: torch.Tensor, lengths: torch.Tensor, forward: LSTMWeights,
         backward: Optional[LSTMWeights] = None, fuse_directions: bool = False) -> torch.Tensor:
    """(B, T, in) float32 -> (B, T, H), or (B, T, 2H) when bidirectional."""
    dirs = [forward] if backward is None else [forward, backward]
    B, T, _ = x.shape
    H = forward.w_hh.shape[1]
    w_ih = torch.cat([w.w_ih for w in dirs], dim=0)              # (D·4H, in)
    b_ih = torch.cat([w.b_ih for w in dirs])
    b_hh = torch.cat([w.b_hh for w in dirs])
    xproj = torch.matmul(x, w_ih.t()) + b_ih + b_hh              # (B, T, D·4H)
    lengths = lengths.to(device=x.device, dtype=torch.int32)
    if fuse_directions and backward is not None:
        return _stacked(xproj.reshape(B, T, 2, 4 * H), lengths, forward.w_hh, backward.w_hh)
    return lstm_core(xproj.reshape(B, T, len(dirs), 4 * H).contiguous(), lengths,
                     torch.stack([w.w_hh for w in dirs]).contiguous())


def stack_directions(a: torch.Tensor) -> torch.Tensor:
    """(B, T, 2, F) per-direction values -> (T, 2B, F) stacked rows: rows
    [0, B) the forward direction, rows [B, 2B) the reverse direction on the
    flipped time axis (``lstm_pallas.py`` ``prep``)."""
    return torch.cat([a[:, :, 0].transpose(0, 1),
                      torch.flip(a[:, :, 1], dims=(1,)).transpose(0, 1)], dim=1)


def unstack_directions(s: torch.Tensor) -> torch.Tensor:
    """The inverse of ``stack_directions``: (T, 2B, F) -> (B, T, 2, F)."""
    B = s.shape[1] // 2
    return torch.stack([s[:, :B].transpose(0, 1),
                        torch.flip(s[:, B:], dims=(0,)).transpose(0, 1)], dim=2)


def stacked_valid(T: int, lengths: torch.Tensor) -> torch.Tensor:
    """(T, 2B) float32 validity of the stacked rows: t < len forward,
    T-1-t < len reverse."""
    t_idx = torch.arange(T, device=lengths.device)[:, None]
    return torch.cat([t_idx < lengths[None, :], (T - 1 - t_idx) < lengths[None, :]],
                     dim=1).to(torch.float32)


def _stacked(xproj: torch.Tensor, lengths: torch.Tensor, w_hh_f: torch.Tensor,
             w_hh_b: torch.Tensor) -> torch.Tensor:
    """(B, T, 2, 4H) projections -> (B, T, 2H) through K7 / K8 on the
    stacked rows, their outputs flipped back (``lstm_pallas.py`` ``post``)."""
    B, T = xproj.shape[:2]
    h = lstm_core_stacked(stack_directions(xproj).contiguous(), stacked_valid(T, lengths),
                          w_hh_f.contiguous(), w_hh_b.contiguous())
    return unstack_directions(h).reshape(B, T, -1)
