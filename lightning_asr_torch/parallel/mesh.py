"""The row layout of a data-parallel batch (port of the data axis of
``lightning_asr_tpu/parallel/mesh.py`` and of its trainer's process-major
check, ``training/trainer.py:229-253``).

A global batch of G rows (the batcher pads G to a multiple of the world W)
is split over W ranks of R = G / W rows each:

  * with one micro-batch, rank r holds the global rows [r·R, (r+1)·R): the
    JAX package's process-major ``data`` axis, which its trainer checks at
    init and which here is the layout itself (``local_rows``);
  * with k micro-batches (``accumulate_grad_batches``) of m = G / k rows,
    rank r holds the rows i·m + r·(m/W) + j for i < k and j < m/W, so that
    its i-th local slice of R/k rows is its share of global micro-batch i:
    the rows [i·m, (i+1)·m) that the JAX step gives that micro-batch.

``RowShard`` names this rank's rows of the batch that a train step is
working on.  Inside ``row_shard(shard)``:

  * every random draw of the step (``draw``: the device crop, dither,
    SpecAugment, cutout, dropout) is made for all ``total`` rows and the rank
    keeps its own, so a global row gets the numbers a one-process run on the
    global batch gives it, whatever W;
  * train-mode BatchNorm takes its statistics over the global rows
    (``models/layers.py::MaskedBatchNorm``), as the JAX SPMD step does.

Outside it (``row_shard(None)``, the default) both are the one-process
computation, bit for bit.

With tensor parallelism (``parallel/distributed.py``'s (W / T) x T layout)
the rows split over the data group: W is the data size and r the data
index, and the T ranks of a model group hold the same rows, draw the same
numbers and take the same statistics.  A draw over channels (dropout's)
is made for every channel too and each rank keeps its block
(``models/layers.py::dropout``), so a row and channel get the numbers that
one process gives them, whatever W and T.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch


def local_rows(total: int, rank: int, world: int, micro_batches: int = 1) -> np.ndarray:
    """The global rows that ``rank`` of ``world`` holds of a batch of
    ``total`` rows split into ``micro_batches``, in local order (ascending)."""
    if total % (world * micro_batches):
        raise ValueError(f"a batch of {total} rows does not split over {world} ranks "
                         f"x {micro_batches} micro-batches")
    micro = total // micro_batches
    share = micro // world
    rows = np.arange(micro_batches)[:, None] * micro + rank * share + np.arange(share)[None, :]
    return rows.reshape(-1)


@dataclass(frozen=True)
class RowShard:
    rows: torch.Tensor      # (R,) int64: the global row of each local row
    total: int              # rows of the global batch
    world: int              # ranks that split it (the data group's)


_CURRENT: Optional[RowShard] = None


@contextlib.contextmanager
def row_shard(shard: Optional[RowShard]):
    """Make ``shard`` the rows that draws and BatchNorm statistics refer
    to; ``None`` is the one-process computation."""
    global _CURRENT
    previous, _CURRENT = _CURRENT, shard
    try:
        yield shard
    finally:
        _CURRENT = previous


def current_shard() -> Optional[RowShard]:
    return _CURRENT


def draw(shape: Sequence[int], generator: Optional[torch.Generator], device,
         axis: int = 0, normal: bool = False) -> torch.Tensor:
    """``torch.rand`` (``torch.randn`` with ``normal``) float32 of ``shape``
    from ``generator``.  Inside ``row_shard`` the batch axis ``axis`` holds
    this rank's rows of one draw for all the global rows."""
    fn = torch.randn if normal else torch.rand
    shard = _CURRENT
    if shard is None:
        return fn(tuple(shape), generator=generator, device=device, dtype=torch.float32)
    full = list(shape)
    if full[axis] != shard.rows.numel():
        raise ValueError(f"a draw of shape {tuple(shape)} has {full[axis]} rows on axis {axis}; "
                         f"this rank holds {shard.rows.numel()}")
    full[axis] = shard.total
    out = fn(tuple(full), generator=generator, device=device, dtype=torch.float32)
    return out.index_select(axis, shard.rows.to(out.device))
