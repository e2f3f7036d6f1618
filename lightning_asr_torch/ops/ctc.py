"""CTC lattice helpers shared by the kernel path (``ops/ctc_kernels.py``,
K4 and K5) and its plain versions; the semantics are those of
``lightning_asr_tpu/ops/ctc.py``.

Blank may be any index (the reference uses the LAST one), per-sample losses
are un-normalized ``-log p(y|x)`` (``reduction='none'``), and the training
step takes their batch mean with no division by target length.  States are
the 2L+1 blank-interleaved extended labels.  The sentinel is the finite
``NEG_INF = -1e30``, so an impossible alignment gives a large finite loss,
not ``inf``.
"""

from __future__ import annotations

import torch

NEG_INF = -1.0e30


def extended_labels(targets: torch.Tensor, blank_id: int) -> torch.Tensor:
    """(B, L) labels -> (B, 2L+1) blank-interleaved extended states."""
    B, L = targets.shape
    ext = torch.full((B, 2 * L + 1), blank_id, dtype=torch.int64, device=targets.device)
    ext[:, 1::2] = targets.to(torch.int64)
    return ext


def shift_right(x: torch.Tensor, n: int = 1) -> torch.Tensor:
    """(B, S) -> x shifted by +n along S, NEG_INF in the first n states."""
    return torch.cat([torch.full_like(x[:, :n], NEG_INF), x[:, :-n]], dim=1)


def lse3(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    m = torch.maximum(torch.maximum(a, b), c)
    return m + torch.log(torch.exp(a - m) + torch.exp(b - m) + torch.exp(c - m))
