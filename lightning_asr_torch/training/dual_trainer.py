"""Trainer for the dual-stream SSL model (port of
``lightning_asr_tpu/training/dual_trainer.py``): the dual train and eval
steps (wav2vec2 features + the 20 ms mel stream computed on the device)
with the SSL pseudo-labeling loop."""

from __future__ import annotations

from ..models.dual_stream import DUAL_MEL_CONFIG
from .ssl_trainer import SSLTrainer
from .steps import make_dual_eval_step, make_dual_train_step


class DualSSLTrainer(SSLTrainer):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._train_step = make_dual_train_step(self.model, self.optimizer, self.vocab.blank_id,
                                                DUAL_MEL_CONFIG, data_parallel=self.data_parallel)
        self._eval_step = make_dual_eval_step(self.model, self.vocab.blank_id, DUAL_MEL_CONFIG)
