"""Train and eval steps (port of ``lightning_asr_tpu/training/steps.py``):
frontend + model + CTC + optimizer, one call per batch.

A train step consumes raw waveform batches (int16, mu-law or float32 wire)
and performs: dither, preemphasis, log-mel (the "default" tier through
kernel K1), SpecAugment, per-utterance normalization, the QuartzNet forward
in train mode (batch statistics, dropout; the BiLSTM through kernels K2 and
K3), the CTC loss as the batch mean of per-sample ``-log p`` (kernels K4
and K5), the backward, the NovoGrad update with its schedule, and the NaN
guard.

The state is functional, as in the JAX package: ``AsrTrainState`` holds
dicts of tensors, and a step returns a new state without changing the old
one.  The model module supplies only the computation: ``functional_call``
runs it on the state's parameters and on a copy of its BatchNorm
statistics, which train-mode BatchNorm updates in place.

NaN guard (the reference documents NaN loss as a real failure mode): when
the loss is non-finite, parameters, BatchNorm statistics and optimizer state
all keep their old values and ``nan_count`` rises; ``step`` rises on every
call.  The guard is ``torch.where`` over new and old tensors on the device,
so a step makes no host round trip.

Random draws (dither, SpecAugment, dropout) come from the
``torch.Generator`` passed to the step, on the batch's device; they cannot
give ``jax.random``'s bits, so parity tests run with them off or hand the
same numbers to both sides.

``data_parallel=True`` makes the step one rank's share of a global step
(port of the JAX step jitted over a ``data``-sharded batch): the batch holds
this rank's rows (``parallel/mesh.py``); the random draws are this rank's
rows of the global batch's; train-mode BatchNorm takes the global batch's
statistics; the loss is the mean over the global rows, pad rows included
(every rank holds as many rows, so the mean of the ranks' means); and one
all-reduce of the flattened gradient, the loss beside it, divided by the
world, comes before clipping, the NaN guard and NovoGrad, so that every
rank takes the same decision and the same update.  With one rank it gives
the bits of the step without it.

In a tensor-parallel layout (``parallel/distributed.py``, ``parallel/tp.py``)
the same flag makes the step one rank's share of a dp x tp step: the state
holds this rank's blocks of the split leaves (``tp.shard_state``), the
batch the rows of its data group, and the model runs inside
``tp.model_parallel``; a split leaf's gradient (this rank's block) is
averaged over the data group, and a whole leaf's, with the loss, over
every rank: the ranks of a model group compute it alike, but on the card
not always to the same bits (cuDNN's weight gradients), and a whole leaf
must stay the same on all of them.  The gradient norm, the per-tensor
NovoGrad's norms and clipping read the whole tensors' (the split leaves'
squares summed over the model group).  The eval step runs the same split
forward; its outputs are whole on every rank.

``crop=True`` applies the reference's random wave crop on the device
(``ops/augment.py::wave_crop``, the ``device_cache`` mode of the trainer,
whose cached batches hold uncropped waves); its two draws a row come first
from the step's generator.

The SSL paths have steps of their own: ``make_dual_train_step`` /
``make_dual_eval_step`` (wav2vec2 features and a mel stream computed here
from the raw waves in ``batch``'s ``raw_waves``; SpecAugment and
normalization on the mel stream, cutout on the features) and
``make_raw_ssl_train_step`` / ``make_raw_ssl_eval_step`` (raw waves into
``SSLRetrainAsrModel``, which holds the trainable wav2vec2 encoder and its
cutout); their train steps take ``data_parallel`` as ``make_train_step``
does (no model groups: the SSL entry points split rows only).

On the card ``make_train_step``'s step runs as one CUDA graph per batch
shape (``training/graphs.py``): a shape's first call runs eagerly and then
records the step, later calls replay it; the CPU, ``data_parallel`` and
``accum_steps > 1`` stay eager, as do the dual and raw-SSL steps.

Each train step marks its phases with the spans of ``training/profiler.py``:
``train_step`` around the call, and inside it ``features`` (the supervised
step's frontend), ``forward`` and ``backward`` (once a micro-batch),
``all_reduce`` (``data_parallel``) and ``update`` (clipping, NovoGrad, the
NaN guard and the step's metrics); these open where the step runs as
written, eagerly or while it is recorded (the span ``capture``).  A replay
is the span ``replay``.  Outside a ``tracing`` block a span is one read of
a module global.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch
import torch.utils._pytree as pytree
from torch.func import functional_call

from ..ops.augment import cutout, spec_augment, wave_crop
from ..ops.ctc_kernels import ctc_loss
from ..ops.frontend import MelFrontendConfig, log_mel_spectrogram, normalize_features
from ..optim.novograd import GradientTransformation, apply_updates, global_norm
from ..parallel import distributed, tp
from ..parallel.mesh import RowShard, local_rows, row_shard
from ..utils.device import resolve_device
from .graphs import GraphedStep
from .profiler import span

Tensors = Dict[str, torch.Tensor]


@dataclass
class AsrTrainState:
    step: torch.Tensor          # () int32
    params: Tensors
    batch_stats: Tensors
    opt_state: Any
    nan_count: torch.Tensor     # () int32


# a pytree node, so that the graphed step flattens a state (training/graphs.py)
pytree.register_pytree_node(AsrTrainState, lambda s: (list(vars(s).values()), list(vars(s))),
                            lambda values, names: AsrTrainState(**dict(zip(names, values))),
                            serialized_type_name=f"{__name__}.AsrTrainState")


def create_train_state(model: torch.nn.Module, optimizer: GradientTransformation) -> AsrTrainState:
    """A state from the module's current weights (``reset_parameters`` or a
    loaded checkpoint), on the module's device.  A buffer outside the
    state_dict (the Conformer's position table) stays the module's own."""
    params = {k: p.detach().clone() for k, p in model.named_parameters()}
    persistent = model.state_dict(keep_vars=True)
    stats = {k: b.detach().clone() for k, b in model.named_buffers() if k in persistent}
    dev = next(iter(params.values())).device
    return AsrTrainState(step=torch.zeros((), dtype=torch.int32, device=dev), params=params,
                         batch_stats=stats, opt_state=optimizer.init(params),
                         nan_count=torch.zeros((), dtype=torch.int32, device=dev))


def _keep(finite: torch.Tensor, new, old):
    """``new`` where ``finite``, else ``old``, over tensors, dicts and
    NamedTuples of them."""
    if isinstance(new, torch.Tensor):
        return torch.where(finite, new, old)
    if isinstance(new, dict):
        return {k: _keep(finite, v, old[k]) for k, v in new.items()}
    if isinstance(new, tuple):
        kept = [_keep(finite, a, b) for a, b in zip(new, old)]
        return type(new)(*kept) if hasattr(new, "_fields") else type(new)(kept)
    raise TypeError(f"cannot guard a {type(new).__name__}")


def _guarded_update(state: AsrTrainState, optimizer: GradientTransformation, loss, grads,
                    new_stats, log_probs, out_lens):
    """Optimizer update + NaN-skip guard + step metrics (the ``update``
    span)."""
    with span("update"):
        updates, new_opt_state = optimizer.update(grads, state.opt_state, state.params)
        new_params = apply_updates(state.params, updates)
        finite = torch.isfinite(loss)
        new_state = AsrTrainState(
            step=state.step + 1,
            params=_keep(finite, new_params, state.params),
            batch_stats=_keep(finite, new_stats, state.batch_stats),
            opt_state=_keep(finite, new_opt_state, state.opt_state),
            nan_count=state.nan_count + (~finite).to(torch.int32),
        )
        metrics = {
            "loss": loss,
            "grad_norm": global_norm(grads),
            "finite": finite,
            "preds": torch.argmax(log_probs, dim=-1).to(torch.int32),
            "pred_lens": out_lens,
        }
    return new_state, metrics


def _features(batch: dict, frontend: MelFrontendConfig, from_features: bool, normalize: bool,
              generator: Optional[torch.Generator], augment: Optional[str] = None,
              freq_mask=27, time_mask=0.07, crop_weight: Optional[float] = None):
    """(feats (B, T, F), percents (B,)) of a batch, without gradient; with a
    ``crop_weight`` the waves are cropped first (``wave_crop``)."""
    with torch.no_grad():
        if from_features:
            feats, feat_lens = batch["waves"], batch["wave_lens"]
        else:
            waves, wave_lens, prev = batch["waves"], batch["wave_lens"], batch.get("prev_samples")
            if crop_weight is not None:
                waves, wave_lens, prev = wave_crop(waves, wave_lens, generator, crop_weight)
            feats, feat_lens = log_mel_spectrogram(
                waves, wave_lens, frontend,
                generator=generator if frontend.dither > 0 else None,
                prev_samples=prev)
        if augment == "specaugment":
            feats = spec_augment(feats, feat_lens, generator, freq_mask, time_mask)
        elif augment == "cutout":
            feats = cutout(feats, generator, rect_masks=5, rect_freq=150, rect_time=100)
        if normalize:
            feats = normalize_features(feats, feat_lens)
        T = torch.full((), feats.shape[1], dtype=torch.float32, device=feats.device)
        return feats, feat_lens.to(device=feats.device, dtype=torch.float32) / T


def _loss_and_grads(model: torch.nn.Module, blank_id: int, params: Tensors, stats: Tensors,
                    inputs: tuple, targets, target_lens, generator):
    """The model in train mode on ``inputs`` (its positional arguments; the
    generator goes by keyword) and the batch mean of the CTC losses: (loss,
    gradients, new BatchNorm statistics, log-probs, out_lens); the spans
    ``forward`` and ``backward``."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    new_stats = {k: v.clone() for k, v in stats.items()}
    with torch.enable_grad():
        with span("forward"):
            log_probs, out_lens = functional_call(model, {**leaves, **new_stats}, inputs,
                                                  {"generator": generator})
            loss = torch.mean(ctc_loss(log_probs, out_lens, targets, target_lens, blank_id))
        with span("backward"):
            grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads)), new_stats, log_probs.detach(), out_lens


def _rank_shards(rows: int, device, accum_steps: int):
    """This rank's ``RowShard`` of a step's batch of ``rows`` local rows, and
    of each of its ``accum_steps`` micro-batches (over the data group)."""
    rank, world = distributed.data_index(), distributed.data_size()
    total = rows * world
    whole = RowShard(torch.as_tensor(local_rows(total, rank, world, accum_steps), device=device),
                     total, world)
    share = rows // accum_steps
    micro = RowShard(torch.arange(rank * share, (rank + 1) * share, device=device),
                     share * world, world)
    return whole, micro


def _mean_over(group: str, tensors: list) -> list:
    """``tensors`` averaged over the ranks of ``group``: one all-reduce of
    one flat buffer."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    flat = distributed.all_reduce_(flat, group) / distributed.group_size(group)
    return list(torch.split(flat, [t.numel() for t in tensors]))


def _mean_over_ranks(loss: torch.Tensor, grads: Tensors):
    """(loss, gradients) averaged over the ranks (the module docstring): one
    flat all-reduce over the data group, and with model groups one more
    over the world for the whole leaves and the loss (the ``all_reduce``
    span)."""
    shard = tp.current()
    split = [] if shard is None else [k for k in grads if k in shard.specs]
    whole = [k for k in grads if k not in split]
    with span("all_reduce"):
        means = _mean_over("data" if shard is None else "world",
                           [grads[k] for k in whole] + [loss])
        if split:
            means[len(whole):len(whole)] = _mean_over("data", [grads[k] for k in split])
    out = dict(zip(whole + split, means))
    return means[len(whole) + len(split)].reshape(()), {k: out[k].view(grads[k].shape)
                                                        for k in grads}


def _rows_loss_and_grads(data_parallel: bool, batch: dict, fn: Callable):
    """``fn()``'s (loss, grads, stats, log_probs, out_lens) for a step of one
    batch (no micro-batches).  With ``data_parallel`` ``fn`` runs inside
    ``row_shard`` of the rank's rows (global draws and BatchNorm
    statistics), and the loss and gradients are then averaged over the
    ranks."""
    whole = _rank_shards(batch["waves"].shape[0], batch["waves"].device, 1)[0] \
        if data_parallel else None
    with row_shard(whole):
        loss, grads, *rest = fn()
    if data_parallel:
        loss, grads = _mean_over_ranks(loss, grads)
    return (loss, grads, *rest)


def _eval_outputs(model: torch.nn.Module, state: AsrTrainState, inputs: tuple, batch: dict,
                  blank_id: int) -> dict:
    """The model in eval mode on ``inputs``: per-sample CTC losses,
    log-probs, argmax and out_lens."""
    model.eval()
    with torch.no_grad():
        log_probs, out_lens = functional_call(model, {**state.params, **state.batch_stats},
                                              inputs)
        losses = ctc_loss(log_probs, out_lens, batch["targets"], batch["target_lens"], blank_id)
    return {"losses": losses, "log_probs": log_probs,
            "preds": torch.argmax(log_probs, dim=-1).to(torch.int32), "pred_lens": out_lens}


def make_train_step(
    model: torch.nn.Module,
    optimizer: GradientTransformation,
    blank_id: int,
    frontend: MelFrontendConfig = MelFrontendConfig(),
    augment=True,
    freq_mask=27,
    time_mask=0.07,
    from_features: bool = False,
    normalize: bool = True,
    crop: bool = False,
    crop_weight: float = 0.98,
    accum_steps: int = 1,
    data_parallel: bool = False,
) -> Callable:
    """Build ``train_step(state, batch, generator=None) -> (state,
    metrics)``.

    ``batch`` holds ``waves`` (B, S), ``wave_lens`` (B,), ``targets`` (B, L)
    and ``target_lens`` (B,), optionally ``prev_samples`` (B,); with
    ``from_features`` the waves are (B, T, F) features and the lengths
    frame counts (the SSL path, with ``augment='cutout'`` and no
    normalization).  ``augment`` True/'specaugment' applies SpecAugment,
    'cutout' the rectangles, None/False nothing.  ``crop`` crops the waves
    on the device first (``wave_crop`` with ``crop_weight``).  ``generator``
    feeds the crop, dither, augmentation and dropout.

    ``accum_steps`` > 1 splits the batch into that many micro-batches, run
    in order: BatchNorm statistics carry from one to the next, the summed
    gradients and losses are divided by the count, and the optimizer
    updates once.  The batch size must divide by ``accum_steps``.
    ``data_parallel`` (the module docstring) needs a process group
    (``parallel/distributed.py``); with it, micro-batch i is this rank's
    i-th slice of rows, its share of global micro-batch i, and in a layout
    of model groups the state is this rank's blocks (``tp.shard_state``).

    On a CUDA model this turns TF32 off for float32 matmuls and convolutions
    (``resolve_device``): the CTC gradient's one-hot scatter to classes and
    NovoGrad's segment sums are float32 matmuls that TF32 would round to 10
    mantissa bits.  A caller must not turn TF32 back on while it trains.

    On the card, without ``data_parallel`` and with ``accum_steps`` 1, the
    step replays one CUDA graph per batch shape and generator object
    (``training/graphs.py``; ``train_step.graphs`` holds them and counts
    each call's route): the eager step's bits on the same state, batch and
    generator state (under cuDNN's deterministic algorithms, as two eager
    calls need; the Conformer's under PyTorch's, ``training/graphs.py``), a
    fresh state and metrics each call."""
    if crop and from_features:
        raise ValueError("crop=True crops waveforms; a from_features batch holds features")
    resolve_device(next(model.parameters()).device)
    augment = "specaugment" if augment is True else (augment or None)
    shard = tp.model_shard(model) if data_parallel else None

    def grad_fn(params, stats, feats, percents, targets, target_lens, generator):
        return _loss_and_grads(model, blank_id, params, stats, (feats, percents), targets,
                               target_lens, generator)

    def train_step(state: AsrTrainState, batch: dict,
                   generator: Optional[torch.Generator] = None):
        with span("train_step"), tp.model_parallel(shard):
            return graphed(state, batch, generator)

    def _train_step(state: AsrTrainState, batch: dict, generator: Optional[torch.Generator]):
        model.train()
        B = batch["waves"].shape[0]
        if B % accum_steps:
            raise ValueError(f"batch size {B} must divide by accum_steps={accum_steps}")
        whole = micro = None
        if data_parallel:
            whole, micro = _rank_shards(B, batch["waves"].device, accum_steps)
        with row_shard(whole), span("features"):
            feats, percents = _features(batch, frontend, from_features, normalize, generator,
                                        augment, freq_mask, time_mask,
                                        crop_weight if crop else None)
        targets, target_lens = batch["targets"], batch["target_lens"]
        if accum_steps <= 1:
            with row_shard(whole):
                loss, grads, new_stats, log_probs, out_lens = grad_fn(
                    state.params, state.batch_stats, feats, percents, targets, target_lens,
                    generator)
        else:
            mb = B // accum_steps
            stats, grad_sum, loss_sum, lps, ols = state.batch_stats, None, 0.0, [], []
            for i in range(accum_steps):
                sl = slice(i * mb, (i + 1) * mb)
                with row_shard(micro):
                    loss_i, g, stats, lp, ol = grad_fn(state.params, stats, feats[sl],
                                                       percents[sl], targets[sl],
                                                       target_lens[sl], generator)
                grad_sum = g if grad_sum is None else {k: grad_sum[k] + v for k, v in g.items()}
                loss_sum = loss_sum + loss_i
                lps.append(lp)
                ols.append(ol)
            loss = loss_sum / accum_steps
            grads = {k: v / accum_steps for k, v in grad_sum.items()}
            new_stats, log_probs, out_lens = stats, torch.cat(lps), torch.cat(ols)
        if data_parallel:
            loss, grads = _mean_over_ranks(loss, grads)
        return _guarded_update(state, optimizer, loss, grads, new_stats, log_probs, out_lens)

    graphed = GraphedStep(_train_step, "data_parallel" if data_parallel else
                          "accum_steps" if accum_steps > 1 else None)
    train_step.graphs = graphed
    return train_step


def make_eval_step(model: torch.nn.Module, blank_id: int,
                   frontend: MelFrontendConfig = MelFrontendConfig(),
                   from_features: bool = False, normalize: bool = True,
                   data_parallel: bool = False) -> Callable:
    """``eval_step(state, batch) -> {losses, log_probs, preds, pred_lens}``:
    the forward in eval mode (running statistics, no dropout, no dither or
    augmentation) and per-sample CTC losses.  Pins float32 precision on a
    CUDA model as ``make_train_step`` does.  ``data_parallel`` in a layout
    of model groups: the state is this rank's blocks, and the forward runs
    split (the outputs are whole)."""
    resolve_device(next(model.parameters()).device)
    shard = tp.model_shard(model) if data_parallel else None

    def eval_step(state: AsrTrainState, batch: dict) -> dict:
        with tp.model_parallel(shard):
            return _eval_outputs(model, state, _features(batch, frontend, from_features,
                                                         normalize, None), batch, blank_id)

    return eval_step


def _dual_inputs(batch: dict, mel_frontend: MelFrontendConfig,
                 generator: Optional[torch.Generator], augment: bool, freq_mask=27,
                 time_mask=0.07) -> tuple:
    """(wav2vec2 features, mel stream, percents) of a dual batch, without
    gradient: the log-mel of ``raw_waves`` at ``mel_frontend`` (dithered when
    training), then in training SpecAugment on it and cutout on the
    features, in that order of draws; the mel stream normalized."""
    with torch.no_grad():
        w2v, w2v_lens = batch["waves"], batch["wave_lens"]
        mel, mel_lens = log_mel_spectrogram(
            batch["raw_waves"], batch["raw_wave_lens"], mel_frontend,
            generator=generator if augment and mel_frontend.dither > 0 else None)
        if augment:
            mel = spec_augment(mel, mel_lens, generator, freq_mask, time_mask)
        mel = normalize_features(mel, mel_lens)
        if augment:
            w2v = cutout(w2v, generator, rect_masks=5, rect_freq=150, rect_time=100)
        T = torch.full((), w2v.shape[1], dtype=torch.float32, device=w2v.device)
        return w2v, mel, w2v_lens.to(device=w2v.device, dtype=torch.float32) / T


def make_dual_train_step(model: torch.nn.Module, optimizer: GradientTransformation,
                         blank_id: int, mel_frontend: MelFrontendConfig, freq_mask=27,
                         time_mask=0.07, data_parallel: bool = False) -> Callable:
    """``train_step(state, batch, generator)`` of ``DualStreamAsrModel``:
    ``batch`` holds the features (``waves``, ``wave_lens``), ``raw_waves``
    (B, S) float32, ``raw_wave_lens``, ``targets`` and ``target_lens``.  Pins
    float32 precision on a CUDA model as ``make_train_step`` does.
    ``data_parallel`` as in ``make_train_step``: the mel stream's dither and
    SpecAugment, the cutout and dropout draw the global rows, BatchNorm
    takes the global statistics, and the loss and gradients are averaged
    over the ranks before the update."""
    resolve_device(next(model.parameters()).device)

    def train_step(state: AsrTrainState, batch: dict,
                   generator: Optional[torch.Generator] = None):
        def loss_and_grads():
            inputs = _dual_inputs(batch, mel_frontend, generator, True, freq_mask, time_mask)
            return _loss_and_grads(model, blank_id, state.params, state.batch_stats, inputs,
                                   batch["targets"], batch["target_lens"], generator)

        with span("train_step"):
            model.train()
            return _guarded_update(state, optimizer,
                                   *_rows_loss_and_grads(data_parallel, batch, loss_and_grads))

    return train_step


def make_dual_eval_step(model: torch.nn.Module, blank_id: int,
                        mel_frontend: MelFrontendConfig) -> Callable:
    resolve_device(next(model.parameters()).device)

    def eval_step(state: AsrTrainState, batch: dict) -> dict:
        return _eval_outputs(model, state, _dual_inputs(batch, mel_frontend, None, False),
                             batch, blank_id)

    return eval_step


def make_raw_ssl_train_step(model: torch.nn.Module, optimizer: GradientTransformation,
                            blank_id: int, data_parallel: bool = False) -> Callable:
    """``train_step(state, batch, generator)`` of ``SSLRetrainAsrModel``: the
    raw ``waves`` and ``wave_lens`` go to the model, which draws its cutout
    and dropout from ``generator``.  ``data_parallel`` as in
    ``make_dual_train_step``."""
    resolve_device(next(model.parameters()).device)

    def train_step(state: AsrTrainState, batch: dict,
                   generator: Optional[torch.Generator] = None):
        def loss_and_grads():
            return _loss_and_grads(model, blank_id, state.params, state.batch_stats,
                                   (batch["waves"], batch["wave_lens"]), batch["targets"],
                                   batch["target_lens"], generator)

        with span("train_step"):
            model.train()
            return _guarded_update(state, optimizer,
                                   *_rows_loss_and_grads(data_parallel, batch, loss_and_grads))

    return train_step


def make_raw_ssl_eval_step(model: torch.nn.Module, blank_id: int) -> Callable:
    resolve_device(next(model.parameters()).device)

    def eval_step(state: AsrTrainState, batch: dict) -> dict:
        return _eval_outputs(model, state, (batch["waves"], batch["wave_lens"]), batch, blank_id)

    return eval_step
