"""Trainer: data, model, optimizer, checkpoints, loggers and the profiler
together (port of ``lightning_asr_tpu/training/trainer.py``).

The reference's ``pl.Trainer`` use: an epoch loop with a per-step LR
schedule, validation every N epochs (``val_loss``, ``val_wer``), top-3 +
last checkpoints on ``val_wer``, resume, per-batch decoded samples in the
log, a simple profiler report, and a final test pass; with the JAX
package's additions: ``ReduceLROnPlateau`` through a learning rate held in
the optimizer state, ``limit_train_batches`` / ``limit_val_batches``,
``accumulate_grad_batches`` (micro-batches of one batch),
``device_cache`` (train batches resident on the card after epoch 0, the
crop in the step), and a background thread that assembles the next batches
and copies them to the device while the current step runs.  The SSL path's
knobs: ``from_features`` (batches of features in place of waves),
``normalize``, ``augment="cutout"``, ``batch.extra`` copied beside the
batch, and the hooks ``on_train_epoch_end`` and ``on_resume`` for the
pseudo-labeling trainers.

Random draws of a step (crop, dither, SpecAugment, dropout) come from one
generator on the model's device, reseeded from (seed, step) before every
step, so a run resumed from a checkpoint draws what an uninterrupted run
draws.

In a data-parallel process group (``parallel/distributed.py``) each rank
runs this loop on its rows of the same global batches (the datamodule
shards them; ``parallel/mesh.py``) with the data-parallel step: the
parameters, BatchNorm statistics and optimizer state are broadcast from
rank 0 at init and at resume and stay equal on every rank after; the eval
loop all-reduces its sums, so every rank reads the same metrics and the
plateau and early stopping step alike; rank 0 alone logs, prints and writes
checkpoints (the caller gives the other ranks no loggers).  The JAX
trainer's ahead-of-time compile and coordination barrier before a new
shape's first step (``training/trainer.py:402-450`` there) work around
XLA's compile deadline for a collective's first exchange; an eager step has
no compile to wait for, so nothing here stands for them.

In a layout of model groups (tensor parallelism, ``parallel/tp.py``) the
state that rank 0 broadcasts is whole, and each rank then keeps its blocks
of the split leaves (``tp.shard_state``); the steps run split; the eval
sums still run over every rank (the ranks of a model group hold the same
rows, so each sum and each count holds them T times, and the ratios are
the data group's, the same on every rank); the model group that holds
rank 0 gathers the state before rank 0 writes a checkpoint, so a
checkpoint holds whole tensors, as a data-parallel one does; a restore
reads whole tensors (migrating a fused NovoGrad state to the per-tensor
one) and slices them.
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import time
from pathlib import Path
from typing import Callable, Optional, Union

import numpy as np
import torch

from ..data.datamodule import AsrDataModule
from ..data.pipeline import Batch, prefetch
from ..decoding.greedy import greedy_decode_to_strings
from ..metrics.wer import WER
from ..ops.frontend import MelFrontendConfig
from ..optim.novograd import InjectHyperparamsState
from ..parallel import distributed, tp
from .checkpoint import CheckpointManager
from .loggers import BaseLogger, MultiLogger
from .profiler import SimpleProfiler, span, tracing
from .steps import AsrTrainState, create_train_state, make_eval_step, make_train_step

logger = logging.getLogger(__name__)
_END = object()


def _waited(items, name: str):
    """``items``, each wait for the next one (the last for the end) in the
    span ``name``."""
    it = iter(items)
    while True:
        with span(name):
            item = next(it, _END)
        if item is _END:
            return
        yield item


def _resolve_batch_limit(limit, batcher) -> Optional[int]:
    """Lightning's ``limit_{train,val}_batches``: a float < 1.0 is a share of
    the loader's batches, an int a count (0 turns the loop off), 1.0 or
    None everything."""
    if limit is None:
        return None
    if isinstance(limit, float):
        if limit >= 1.0:
            return None
        if limit <= 0.0:
            return 0
        return max(int(round(len(batcher) * limit)), 1)
    return max(int(limit), 0)


def _compute_dtype_name(model) -> str:
    dtype = getattr(model, "dtype", None)
    return "float32" if dtype is None else str(dtype).replace("torch.", "")


class Trainer:
    def __init__(
        self,
        model: torch.nn.Module,
        optimizer,
        datamodule: AsrDataModule,
        total_epochs: int = 100,
        check_val_every_n_epoch: int = 1,
        log_every_n_steps: int = 10,
        sample_log_every_n_batches: int = 50,
        train_wer_every_n_steps: int = 10,
        run_dir: Union[str, Path] = "outputs/run",
        loggers: Optional[BaseLogger] = None,
        lr_schedule: Optional[Callable] = None,
        frontend: MelFrontendConfig = MelFrontendConfig(),
        augment=True,
        freq_mask=27,
        time_mask=0.07,
        normalize: bool = True,
        checkpoint_top_k: int = 3,
        seed: int = 0,
        hparams: Optional[dict] = None,
        from_features: bool = False,
        callbacks: Optional[list] = None,
        plateau=None,
        plateau_monitor: str = "val_loss",
        device_cache: bool = False,
        accumulate_grad_batches: int = 1,
        limit_train_batches=1.0,
        limit_val_batches=1.0,
    ):
        """The trainer runs on the model's device.  ``device_cache=True``
        keeps every train batch of epoch 0 on the device; later epochs replay
        them in a reshuffled order with no host work, and the reference's
        random crop runs in the step on the uncropped waves, so every replay
        epoch draws new crops.  Epoch 0 fixes which utterances share a
        batch."""
        self.model = model
        self.optimizer = optimizer
        self.dm = datamodule
        self.vocab = datamodule.vocab
        self.device = next(model.parameters()).device
        self.total_epochs = total_epochs
        self.check_val_every_n_epoch = check_val_every_n_epoch
        self.log_every_n_steps = log_every_n_steps
        self.sample_log_every_n_batches = sample_log_every_n_batches
        self.train_wer_every_n_steps = train_wer_every_n_steps
        self.run_dir = Path(run_dir)
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self.loggers = loggers or MultiLogger([])
        self.lr_schedule = lr_schedule
        self.frontend = frontend
        self.seed = seed
        # everything inference needs rides in the checkpoint, so that
        # AsrTranslator rebuilds the training pipeline; explicit hparams win
        self.hparams = dict(hparams or {})
        self.hparams.setdefault("frontend", dataclasses.asdict(frontend))
        self.hparams.setdefault("compute_dtype", _compute_dtype_name(model))
        # AsrTranslator reads these two from the checkpoint
        self.hparams.setdefault("normalize", bool(normalize))
        self.hparams.setdefault("from_features", bool(from_features))
        self.generator = torch.Generator(device=self.device)
        self.profiler = SimpleProfiler()
        self.wer = WER(self.vocab.labels, self.vocab.use_cer)
        self.checkpoints = CheckpointManager(self.run_dir / "checkpoints", checkpoint_top_k)
        self.epoch = 0
        self.global_step = 0          # host-side mirror of state.step (no sync a step)
        self.epoch_stats: list = []
        self.callbacks = list(callbacks or [])
        self.should_stop = False
        self.plateau = plateau
        self.plateau_monitor = plateau_monitor
        self.limit_train_batches = limit_train_batches
        self.limit_val_batches = limit_val_batches
        self.device_cache = device_cache
        self._epoch_cache: Optional[list] = None       # [(Batch, device batch)]
        self.data_parallel = distributed.current() is not None
        self.primary = distributed.is_primary()
        self.model_shard = tp.model_shard(model)       # None without model groups
        # train batches hold this rank's share of each micro-batch
        datamodule.micro_batches = int(accumulate_grad_batches)
        crop_in_step = device_cache and getattr(datamodule, "crop", False) and not from_features
        if crop_in_step:
            datamodule.crop = False   # cached batches hold uncropped waves
        self._train_step = make_train_step(
            model, optimizer, self.vocab.blank_id, frontend, augment=augment,
            freq_mask=freq_mask, time_mask=time_mask, from_features=from_features,
            normalize=normalize, crop=crop_in_step,
            crop_weight=getattr(datamodule, "crop_weight", 0.98),
            accum_steps=int(accumulate_grad_batches), data_parallel=self.data_parallel)
        self._eval_step = make_eval_step(model, self.vocab.blank_id, frontend,
                                         from_features=from_features, normalize=normalize,
                                         data_parallel=self.data_parallel)

    # ------------------------------------------------------------------
    def init_state(self) -> AsrTrainState:
        """The whole state from the module's weights, rank 0's on every
        rank."""
        distributed.broadcast_(dict(itertools.chain(self.model.named_parameters(),
                                                    self.model.named_buffers())))
        return create_train_state(self.model, self.optimizer)

    def _device_batch(self, batch: Batch) -> dict:
        arrays = {"waves": batch.waves, "wave_lens": batch.wave_lens,
                  "prev_samples": batch.prev_samples, "targets": batch.targets,
                  "target_lens": batch.target_lens, **(batch.extra or {})}
        cuda = self.device.type == "cuda"
        return {k: (torch.from_numpy(v).pin_memory() if cuda else torch.from_numpy(v))
                .to(self.device, non_blocking=cuda) for k, v in arrays.items()}

    def full_state(self, state: AsrTrainState) -> AsrTrainState:
        """The whole tensors of this rank's ``state``: a collective over the
        model group (the state itself without model groups)."""
        return tp.gather_state(state, self.model_shard)

    def _seeded(self, step: int) -> torch.Generator:
        """The step's generator, a function of (seed, step) alone."""
        return self.generator.manual_seed(self.seed * 1_000_003 + step)

    # ------------------------------------------------------------------
    def fit(self, resume: Optional[str] = None,
            initial_state: Optional[AsrTrainState] = None) -> AsrTrainState:
        """Train from ``initial_state``, a checkpoint (``resume``) or the
        module's weights; the spans of the steps and of the data wait go to
        ``self.profiler``, whose table ends the fit."""
        with tracing(self.profiler):
            return self._fit(resume, initial_state)

    def _fit(self, resume: Optional[str], initial_state: Optional[AsrTrainState]) -> AsrTrainState:
        state = initial_state if initial_state is not None else self.init_state()
        start_epoch = 0
        if resume:
            state, meta = self.checkpoints.restore(state, resume)
        if resume or initial_state is not None:
            distributed.broadcast_(state)
        state = tp.shard_state(state, self.model_shard)
        if resume:
            start_epoch = int(meta.get("epoch", -1)) + 1
            if self.plateau is not None:
                saved = meta.get("trainer", {}).get("plateau")
                if saved:
                    self.plateau.load_state_dict(saved)
                elif isinstance(state.opt_state, InjectHyperparamsState):
                    # no controller state saved: keep at least the lr
                    self.plateau.lr = float(state.opt_state.hyperparams["learning_rate"])
                    logger.warning("checkpoint has no plateau controller state; resumed lr=%g "
                                   "but best/patience counters restart", self.plateau.lr)
            logger.info("resumed from %s at epoch %d", resume, start_epoch)
        self.global_step = int(state.step)
        if resume:
            self.on_resume(state, start_epoch)

        self.loggers.log_hyperparams(self.hparams)
        logger.info("model parameters: %.2fM", sum(p.numel() for p in self.model.parameters()) / 1e6)
        for cb in self.callbacks:
            cb.on_fit_start(self, state)
        for epoch in range(start_epoch, self.total_epochs):
            self.epoch = epoch
            for cb in self.callbacks:
                cb.on_train_epoch_start(self, state, epoch)
            state = self._train_epoch(state, epoch)
            if (epoch + 1) % self.check_val_every_n_epoch == 0:
                val_metrics = self.validate(state)
                self.loggers.log_metrics(val_metrics, self.global_step)
                # the plateau steps before the save, so that a resumed run
                # trains on with the lr and counters of the run that went on
                # (the JAX trainer saves first: ROADMAP.md §C8)
                if self.plateau is not None:
                    new_lr = self.plateau.step(val_metrics.get(self.plateau_monitor))
                    state = self._set_lr(state, new_lr)
                    self.loggers.log_metrics({"lr": new_lr}, self.global_step)
                with self.profiler.profile("checkpoint"):
                    # the model group of rank 0 gathers; rank 0 writes
                    whole = self.full_state(state) if distributed.data_index() == 0 else state
                    self.checkpoints.save(
                        whole, epoch, val_metrics, self.hparams,
                        trainer_meta=({"plateau": self.plateau.state_dict()}
                                      if self.plateau is not None else None))
                for cb in self.callbacks:
                    cb.on_validation_end(self, state, epoch, val_metrics)
            if self.should_stop:
                logger.info("stopping early at epoch %d", epoch)
                break
        for cb in self.callbacks:
            cb.on_fit_end(self, state)
        if self.primary:
            print(self.profiler.summary())
        return state

    def _set_lr(self, state: AsrTrainState, lr: float) -> AsrTrainState:
        """The state with its runtime learning rate set to ``lr``."""
        opt = state.opt_state
        if not isinstance(opt, InjectHyperparamsState):
            logger.warning("plateau scheduling needs novograd_with_runtime_lr; skipping")
            return state
        value = torch.tensor(float(lr), dtype=torch.float32, device=opt.count.device)
        return dataclasses.replace(state, opt_state=opt._replace(
            hyperparams={**opt.hyperparams, "learning_rate": value}))

    def on_resume(self, state, start_epoch) -> None:
        """Hook for subclasses, called once after a checkpoint is restored."""

    def on_train_epoch_end(self, state, epoch) -> None:
        """Hook for subclasses, called after each train epoch, before the
        callbacks' and the validation."""

    def _device_iter(self, batcher, limit: Optional[int] = None):
        """(host batch, device batch) pairs; decode, assembly and the copy to
        the device run in the prefetch thread.  ``limit`` caps the source,
        so the thread ends when an epoch is cut short."""
        def gen():
            it = iter(batcher)
            if limit is not None:
                it = itertools.islice(it, limit)
            for batch in it:
                yield batch, self._device_batch(batch)

        return prefetch(gen(), self.dm.prefetch_depth)

    def _device_cached_iter(self, epoch: int, batcher=None, limit: Optional[int] = None):
        """Epoch 0 stages batches and keeps them; later epochs replay them in
        a reshuffled order, grouped by shape (a stable sort keeps the shuffle
        within a shape)."""
        if self._epoch_cache is None:
            cache = []
            for batch, dev_batch in self._device_iter(batcher or self.dm.train_dataloader(epoch),
                                                      limit):
                cache.append((batch, dev_batch))
                yield batch, dev_batch
            self._epoch_cache = cache
        else:
            order = np.random.default_rng(self.seed + 7919 * epoch).permutation(len(self._epoch_cache))
            order = sorted(order, key=lambda i: self._epoch_cache[i][0].waves.shape[1])
            for i in order:
                yield self._epoch_cache[i]

    def _decode(self, metrics: dict, n: int):
        return greedy_decode_to_strings(metrics["preds"].cpu().numpy(),
                                        metrics["pred_lens"].cpu().numpy(),
                                        self.vocab.labels, self.vocab.blank_id)[:n]

    def _train_epoch(self, state: AsrTrainState, epoch: int) -> AsrTrainState:
        if self.device_cache and self._epoch_cache is not None:
            batch_iter = self._device_cached_iter(epoch)
        else:
            batcher = self.dm.train_dataloader(epoch)
            limit = _resolve_batch_limit(self.limit_train_batches, batcher)
            batch_iter = (self._device_cached_iter(epoch, batcher, limit) if self.device_cache
                          else self._device_iter(batcher, limit))
        t_epoch = time.monotonic()
        audio_seconds, losses = 0.0, []
        first_step = self.global_step + 1
        for i, (batch, dev_batch) in enumerate(_waited(batch_iter, "train_data_wait")):
            state, metrics = self._train_step(state, dev_batch, self._seeded(self.global_step))
            audio_seconds += batch.audio_seconds
            losses.append(metrics["loss"])
            self.global_step += 1
            step = self.global_step
            if step % self.log_every_n_steps == 0:
                with self.profiler.profile("train_logging"):
                    log = {"train_loss": float(metrics["loss"]),
                           "grad_norm": float(metrics["grad_norm"]),
                           "nan_count": float(state.nan_count), "epoch": epoch}
                    if self.lr_schedule is not None:
                        log["lr"] = float(self.lr_schedule(step - 1))
                    if step % max(self.train_wer_every_n_steps, 1) == 0 and batch.size:
                        refs = self.wer.decode_reference(batch.targets, batch.target_lens)
                        log["train_wer"] = WER(self.vocab.labels, self.vocab.use_cer).update(
                            self._decode(metrics, batch.size), refs)
                    self.loggers.log_metrics(log, step)
            if self.primary and i % self.sample_log_every_n_batches == 0 and batch.size:
                refs = self.wer.decode_reference(batch.targets, batch.target_lens)
                logger.info("pred: %s", self._decode(metrics, 1)[0])
                logger.info("true: %s", refs[0])
            for cb in self.callbacks:
                cb.on_train_batch_end(self, state, metrics, batch, i)

        # one read of the losses ends the epoch: every step has run by then
        loss_values = torch.stack(losses).tolist() if losses else []
        dt = time.monotonic() - t_epoch
        self.epoch_stats.append({
            "epoch": epoch, "batches": len(losses), "first_step": first_step, "wall_sec": dt,
            "audio_sec": audio_seconds, "audio_sec_per_sec": audio_seconds / max(dt, 1e-9),
            "losses": loss_values,
            "loss_mean": float(np.mean(loss_values)) if loss_values else float("nan")})
        logger.info("epoch %d: %d batches, %.1fs, %.1f audio-sec/sec", epoch, len(losses), dt,
                    audio_seconds / max(dt, 1e-9))
        self.on_train_epoch_end(state, epoch)
        for cb in self.callbacks:
            cb.on_train_epoch_end(self, state, epoch)
        return state

    # ------------------------------------------------------------------
    def _eval_loop(self, state: AsrTrainState, batcher, tag: str,
                   limit: Optional[int] = None) -> dict:
        metric = WER(self.vocab.labels, self.vocab.use_cer)
        batch_wers, losses = [], []
        for i, (batch, dev_batch) in enumerate(self._device_iter(batcher, limit)):
            n = batch.size
            with self.profiler.profile(f"{tag}_step"):
                out = self._eval_step(state, dev_batch)
                losses.extend(out["losses"][:n].cpu().tolist())
            if n == 0:                     # a rank's share of the tail: pad rows only
                continue
            hyps = self._decode(out, n)
            refs = self.wer.decode_reference(batch.targets[:n], batch.target_lens[:n])
            batch_wers.append(metric.update(hyps, refs))
            if self.primary and i % self.sample_log_every_n_batches == 0:
                logger.info("[%s] pred: %s", tag, hyps[0])
                logger.info("[%s] true: %s", tag, refs[0])
        if self.data_parallel:
            # the JAX trainer's cross-process reduction (its trainer.py:596-610,
            # the reference's torchmetrics dist_reduce_fx="sum"): sums of
            # errors, words, losses and batch WERs and their counts over the
            # ranks, in float64, then the same three ratios on every rank
            # (the ranks of a model group hold the same rows: each sum counts
            # them all, and so does each count)
            tot = distributed.all_reduce_(torch.tensor(
                [metric.scores, metric.words, float(np.sum(losses)), float(len(losses)),
                 float(np.sum(batch_wers)), float(len(batch_wers))],
                dtype=torch.float64, device=self.device)).tolist()
            ratio = lambda a, b: a / b if b else float("inf")  # noqa: E731
            return {f"{tag}_loss": ratio(tot[2], tot[3]), f"{tag}_wer": ratio(tot[4], tot[5]),
                    f"{tag}_wer_corpus": ratio(tot[0], tot[1])}
        return {
            f"{tag}_loss": float(np.mean(losses)) if losses else float("inf"),
            # the reference logs the epoch mean of batch WERs
            f"{tag}_wer": float(np.mean(batch_wers)) if batch_wers else float("inf"),
            # corpus WER: all errors over all words
            f"{tag}_wer_corpus": metric.compute(),
        }

    def validate(self, state: AsrTrainState) -> dict:
        batcher = self.dm.val_dataloader()
        metrics = self._eval_loop(state, batcher, "val",
                                  _resolve_batch_limit(self.limit_val_batches, batcher))
        logger.info("validation: %s", metrics)
        return metrics

    def test(self, state: AsrTrainState) -> dict:
        metrics = self._eval_loop(state, self.dm.test_dataloader(), "test")
        logger.info("test: %s", metrics)
        self.loggers.log_metrics(metrics, self.global_step)
        return metrics
