"""Tensor parallelism (port of ``lightning_asr_tpu/parallel/tp.py`` and of
the tp paths of its trainer): the conv trunk's channels split over the T
ranks of a model group, in a (W / T) x T process layout
(``parallel/distributed.py``).

The JAX package annotates shardings and lets GSPMD insert the collectives.
Here the layout is written out, Megatron's way:

  * ``tp_spec`` decides leaf by leaf, on the port's names, what the JAX
    ``tp_spec`` decides on the flax paths: the conv kernels of
    ``pointwise_conv``, ``depthwise_conv``, ``reside_conv``, ``last_conv``
    and ``first_cnn`` split their output channel (torch's axis 0 of
    ``(out, in, k)``; flax's last axis of ``(k, in, out)``), and their
    biases with them; the BatchNorms ``bn``, ``reside_bn``, ``last_bn`` and
    ``first_bn`` split scale, bias, mean and variance.  A leaf whose axis
    does not divide by T stays whole, as does everything else: the context
    BiLSTM, SE's Dense layers, ``feature_mapping``, the decoder and the
    LSTM head.  The per-tensor NovoGrad momentum follows its parameter (it
    is keyed by the parameter's name); its scalar moments stay whole.
  * the activation layout follows from it: inside ``model_parallel`` a
    trunk activation of C channels holds this rank's contiguous block of
    C / T channels when T divides C (the JAX package's
    ``shard_trunk_activations``), else all C.  Depthwise convs and
    BatchNorms run on the block; a product that reads every input channel
    (a pointwise, residual or epilog conv, SE's Dense layers, the BiLSTM,
    the decoder) reads the gathered activation (``full``), and a
    column-parallel one writes this rank's block of its outputs.
  * three autograd Functions carry the gradients, Megatron's set:
    ``gather_channels`` (forward: the all-gather; backward: this rank's
    slice, with no communication), ``copy_to_model_group`` (forward: the
    identity; backward: a sum over the model group), put in front of every
    column-parallel product, whose input gradient is a partial sum on each
    rank, and ``split_channels`` (forward: this rank's slice of a whole
    activation, with no communication; backward: the all-gather).  A
    gathered activation also feeds replicated compute, whose gradient is
    the same on every rank and must not be summed: that is why the sum sits
    in ``copy_to_model_group`` and not in the gather's backward.
  * the all-gather keeps the data-parallel rule (only ``all_reduce`` and
    ``broadcast``), so one code path runs on NCCL, on gloo over CUDA
    tensors and on gloo on the CPU: each rank writes its block into a
    zero-filled buffer and the buffer is summed over the model group as
    integers (int32, or bytes where the size is not a multiple of 4; gloo
    sums no int16).  An integer sum with zeros is the identity on every
    bit pattern; a float sum is not (-0.0 + 0.0 is +0.0).

An encoder whose class says ``tensor_parallel = False`` (the port's own
``conformer_ctc_large``) has no layout: ``model_shard`` refuses it in a
model group of more than one rank.

Outside ``model_parallel`` (the default) every helper returns its input, so
a model runs exactly as it does without this module.  The scope is entered
by the train and eval steps and left when they return, so a tensor-parallel
trainer leaves no layout behind for a later forward in the same process
(the JAX trainer's ``tp_mesh_scope``).

State: ``shard_state`` slices a whole train state (parameters, BatchNorm
statistics, optimizer state, anything keyed by parameter names) to this
rank's blocks; ``gather_state`` makes it whole again, for checkpoints.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import time
from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Sequence

import torch

from . import distributed

# immediate-parent module names whose conv weights and biases split on the
# output channel; 'decoder' and 'feature_mapping' are deliberately absent
CONV_PARENTS = frozenset({"pointwise_conv", "depthwise_conv", "reside_conv", "last_conv",
                          "first_cnn"})
# BatchNorms whose (C,) scale, bias, mean and variance split with the trunk;
# 'head_bn' is absent (it follows the replicated head BiLSTM)
BN_PARENTS = frozenset({"bn", "reside_bn", "last_bn", "first_bn"})
# gathers, their bytes and (with TIMING on) their milliseconds, since the
# last reset; the card's smoke reads them
STATS = {"gathers": 0, "bytes": 0, "ms": 0.0}
TIMING = False


def tp_spec(name: str, shape: Sequence[int], tp: int) -> Optional[int]:
    """The axis along which leaf ``name`` (a parameter or buffer name of the
    port, e.g. ``encoder.block1.sep_last.pointwise_conv.weight``) of
    ``shape`` splits over ``tp`` ranks, or None where it stays whole."""
    parts = name.split(".")
    parent = parts[-2] if len(parts) >= 2 else ""
    if not shape or shape[0] % tp:
        return None
    if parent in CONV_PARENTS and len(shape) in (1, 3):
        return 0
    if parent in BN_PARENTS and len(shape) == 1:
        return 0
    return None


def specs(shapes: Mapping[str, Sequence[int]], tp: int) -> Dict[str, int]:
    """{name: axis} of the leaves of ``shapes`` (whole shapes) that split
    over ``tp`` ranks."""
    out = {}
    for name, shape in shapes.items():
        axis = tp_spec(name, tuple(shape), tp)
        if axis is not None:
            out[name] = axis
    return out


def model_specs(model: torch.nn.Module, tp: int) -> Dict[str, int]:
    """``specs`` of a model's parameters and buffers (the module holds the
    whole tensors)."""
    return specs({k: tuple(t.shape) for k, t in itertools.chain(model.named_parameters(),
                                                                 model.named_buffers())}, tp)


@dataclass(frozen=True)
class ModelShard:
    index: int                      # this rank's place in its model group
    size: int                       # ranks of the model group (T)
    specs: Mapping[str, int]        # the leaves that split, and their axis


def model_shard(model: torch.nn.Module) -> Optional[ModelShard]:
    """This rank's ``ModelShard`` of ``model`` in the process group's layout,
    None when the model group is this rank alone."""
    size = distributed.model_size()
    if size == 1:
        return None
    encoder = getattr(model, "encoder", None)
    if not getattr(encoder, "tensor_parallel", True):
        raise ValueError(f"train.tp={size}: the {encoder.name} encoder has no "
                         "tensor-parallel layout; train it with train.tp=1")
    return ModelShard(distributed.model_index(), size, model_specs(model, size))


_CURRENT: Optional[ModelShard] = None


@contextlib.contextmanager
def model_parallel(shard: Optional[ModelShard]):
    """Make ``shard`` the layout that the model's helpers follow; None is
    the one-process computation.  The previous layout comes back on exit."""
    global _CURRENT
    previous, _CURRENT = _CURRENT, shard
    try:
        yield shard
    finally:
        _CURRENT = previous


def current() -> Optional[ModelShard]:
    return _CURRENT


def sharded(channels: int) -> bool:
    """Whether an activation of ``channels`` channels is split here."""
    shard = _CURRENT
    return shard is not None and channels % shard.size == 0


# --- the collectives ---

def _all_gather(x: torch.Tensor, dim: int, shard: ModelShard) -> torch.Tensor:
    """The model group's blocks of ``x`` along ``dim``, in rank order: an
    integer all-reduce of a zero-filled buffer holding this rank's block."""
    x = x.contiguous()
    n = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = n * shard.size
    buf = x.new_zeros(shape)
    buf.narrow(dim, shard.index * n, n).copy_(x)
    flat = buf.view(-1)
    ints = flat.view(torch.int32) if flat.numel() * flat.element_size() % 4 == 0 \
        else flat.view(torch.uint8)
    STATS["gathers"] += 1
    STATS["bytes"] += buf.numel() * buf.element_size()
    if TIMING:
        if buf.is_cuda:
            torch.cuda.synchronize(buf.device)
        t0 = time.perf_counter()
    distributed.all_reduce_(ints, "model")
    if TIMING:
        if buf.is_cuda:
            torch.cuda.synchronize(buf.device)
        STATS["ms"] += 1e3 * (time.perf_counter() - t0)
    return buf


def _block(x: torch.Tensor, dim: int, shard: ModelShard) -> torch.Tensor:
    n = x.shape[dim] // shard.size
    return x.narrow(dim, shard.index * n, n)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, shard):
        ctx.dim, ctx.shard = dim, shard
        return _all_gather(x, dim, shard)

    @staticmethod
    def backward(ctx, grad):
        return _block(grad, ctx.dim, ctx.shard).contiguous(), None, None


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return distributed.all_reduce_(grad.contiguous().clone(), "model")


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, shard):
        ctx.dim, ctx.shard = dim, shard
        return _block(x, dim, shard).clone(memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, grad):
        return _all_gather(grad, ctx.dim, ctx.shard), None, None


def gather_channels(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """The whole tensor from this rank's block along ``dim`` (inside
    ``model_parallel``); its gradient is this rank's slice of the whole
    tensor's."""
    return _Gather.apply(x, dim, _CURRENT)


def copy_to_model_group(x: torch.Tensor) -> torch.Tensor:
    """x; its gradient is summed over the model group."""
    return _Copy.apply(x)


def split_channels(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """This rank's block of a whole tensor along ``dim``; its gradient is
    gathered."""
    return _Split.apply(x, dim, _CURRENT)


# --- the layout helpers the model calls (each the identity outside the scope) ---

def full(x: torch.Tensor, channels: int, dim: int = 1) -> torch.Tensor:
    """All ``channels`` channels of an activation in the trunk's layout."""
    return gather_channels(x, dim) if sharded(channels) else x


def own(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """A whole activation in the trunk's layout: this rank's block where its
    channel count splits."""
    return split_channels(x, dim) if sharded(x.shape[dim]) else x


def column_input(x: torch.Tensor, out_channels: int) -> torch.Tensor:
    """The whole input of a product whose ``out_channels`` outputs may split
    (``copy_to_model_group`` when they do)."""
    return copy_to_model_group(x) if sharded(out_channels) else x


def own_block(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim``, without gradient
    bookkeeping (a random draw made for every channel)."""
    return _block(x, dim, _CURRENT) if sharded(x.shape[dim]) else x


def model_sum(name: str, x: torch.Tensor) -> torch.Tensor:
    """Σ over the model group of ``x``, a partial sum over the split leaf
    ``name``; ``x`` itself where ``name`` is whole here."""
    shard = _CURRENT
    if shard is None or name not in shard.specs:
        return x
    return distributed.all_reduce_(x.clone(), "model")


def norm(name: str, x: torch.Tensor) -> torch.Tensor:
    """The L2 norm of the whole leaf ``name`` from this rank's ``x``."""
    shard = _CURRENT
    if shard is None or name not in shard.specs:
        return torch.linalg.vector_norm(x)
    return torch.sqrt(model_sum(name, torch.sum(x * x)))


def global_sum_of_squares(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """Σ of the squares of every element of the whole tensors of ``tree``
    (keyed by parameter names), in float32: the split leaves' squares
    summed over the model group (one all-reduce), the whole ones once."""
    shard = _CURRENT
    split = [torch.sum(t.to(torch.float32) ** 2) for k, t in tree.items() if k in shard.specs]
    total = sum(torch.sum(t.to(torch.float32) ** 2) for k, t in tree.items()
                if k not in shard.specs)
    if split:
        total = total + distributed.all_reduce_(torch.stack(split).sum(), "model")
    return total


# --- whole and split states ---

def _map_named(tree, fn):
    """``tree`` with ``fn(name, tensor)`` applied to every tensor held in a
    dict under a name (dicts, NamedTuples, tuples, lists and dataclasses
    are walked; other tensors are kept)."""
    if isinstance(tree, dict):
        return {k: fn(k, v) if torch.is_tensor(v) else _map_named(v, fn) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_named(v, fn) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_named(v, fn) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: _map_named(getattr(tree, f.name), fn)
                                            for f in dataclasses.fields(tree)})
    return tree


def shard_state(tree, shard: Optional[ModelShard]):
    """This rank's blocks of the whole tensors of ``tree`` (a train state,
    a state_dict, ...): every leaf that ``shard.specs`` names and whose
    shape is its parameter's (a scalar moment keyed by the same name stays
    whole)."""
    if shard is None:
        return tree

    def cut(name, t):
        axis = shard.specs.get(name)
        if axis is None or t.dim() == 0:
            return t
        return _block(t, axis, shard).clone(memory_format=torch.contiguous_format)

    return _map_named(tree, cut)


def gather_state(tree, shard: Optional[ModelShard]):
    """The whole tensors of a state that ``shard_state`` split: a collective
    over the model group (every rank of it calls it)."""
    if shard is None:
        return tree

    def whole(name, t):
        axis = shard.specs.get(name)
        if axis is None or t.dim() == 0:
            return t
        return _all_gather(t.detach(), axis, shard)

    return _map_named(tree, whole)


def reset_stats() -> None:
    STATS.update(gathers=0, bytes=0, ms=0.0)
