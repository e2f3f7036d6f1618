"""Trainer callbacks (port of ``lightning_asr_tpu/training/callbacks.py``):
the hook interface, a step-cadence learning-rate monitor, and early
stopping.  Checkpointing and the per-log-step lr are built into the
trainer."""

from __future__ import annotations

import logging
from typing import Optional

logger = logging.getLogger(__name__)


class Callback:
    """Base callback: override any subset of hooks."""

    def on_fit_start(self, trainer, state) -> None: ...
    def on_train_epoch_start(self, trainer, state, epoch: int) -> None: ...
    def on_train_batch_end(self, trainer, state, metrics: dict, batch, batch_idx: int) -> None: ...
    def on_train_epoch_end(self, trainer, state, epoch: int) -> None: ...
    def on_validation_end(self, trainer, state, epoch: int, metrics: dict) -> None: ...
    def on_fit_end(self, trainer, state) -> None: ...


class LearningRateMonitor(Callback):
    """Log the scheduled lr every ``every_n_steps`` steps (the reference's
    ``LearningRateMonitor(logging_interval='step')``)."""

    def __init__(self, every_n_steps: int = 1):
        self.every_n_steps = every_n_steps

    def on_train_batch_end(self, trainer, state, metrics, batch, batch_idx):
        step = trainer.global_step
        if trainer.lr_schedule is not None and step % self.every_n_steps == 0:
            trainer.loggers.log_metrics({"lr": float(trainer.lr_schedule(step - 1))}, step)


class EarlyStopping(Callback):
    """Stop when the monitored metric has not improved for more than
    ``patience`` validations."""

    def __init__(self, monitor: str = "val_wer", patience: int = 20, mode: str = "min"):
        self.monitor = monitor
        self.patience = patience
        self.mode = mode
        self.best: Optional[float] = None
        self.bad = 0

    def on_validation_end(self, trainer, state, epoch, metrics):
        value = metrics.get(self.monitor)
        if value is None:
            return
        if self.best is None or (value < self.best if self.mode == "min" else value > self.best):
            self.best = value
            self.bad = 0
        else:
            self.bad += 1
            if self.bad > self.patience:
                logger.info("early stopping at epoch %d (%s=%.4f, best=%.4f)",
                            epoch, self.monitor, value, self.best)
                trainer.should_stop = True
