"""Trainer for the SSL retrain mode (port of
``lightning_asr_tpu/training/retrain_trainer.py``): raw-wave batches
(``AsrDataModule``), the wav2vec2 feature encoder trained inside the model,
the SSL pseudo-labeling loop."""

from __future__ import annotations

from .ssl_trainer import SSLTrainer
from .steps import make_raw_ssl_eval_step, make_raw_ssl_train_step


class SSLRetrainTrainer(SSLTrainer):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._train_step = make_raw_ssl_train_step(self.model, self.optimizer,
                                                   self.vocab.blank_id,
                                                   data_parallel=self.data_parallel)
        self._eval_step = make_raw_ssl_eval_step(self.model, self.vocab.blank_id)
