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
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .lstm_kernels import lstm_core


class LSTMWeights(NamedTuple):
    w_ih: torch.Tensor  # (4H, in)
    w_hh: torch.Tensor  # (4H, H)
    b_ih: torch.Tensor  # (4H,)
    b_hh: torch.Tensor  # (4H,)


def lstm(x: torch.Tensor, lengths: torch.Tensor, forward: LSTMWeights,
         backward: Optional[LSTMWeights] = None) -> torch.Tensor:
    """(B, T, in) float32 -> (B, T, H), or (B, T, 2H) when bidirectional."""
    dirs = [forward] if backward is None else [forward, backward]
    B, T, _ = x.shape
    H = forward.w_hh.shape[1]
    w_ih = torch.cat([w.w_ih for w in dirs], dim=0)              # (D·4H, in)
    b_ih = torch.cat([w.b_ih for w in dirs])
    b_hh = torch.cat([w.b_hh for w in dirs])
    xproj = torch.matmul(x, w_ih.t()) + b_ih + b_hh              # (B, T, D·4H)
    return lstm_core(xproj.reshape(B, T, len(dirs), 4 * H).contiguous(),
                     lengths.to(device=x.device, dtype=torch.int32),
                     torch.stack([w.w_hh for w in dirs]).contiguous())
