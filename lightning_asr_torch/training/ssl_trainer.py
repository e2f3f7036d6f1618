"""SSL training with pseudo-labeling (port of
``lightning_asr_tpu/training/ssl_trainer.py``), the reference's
``SSLLightingModule`` loop:

  * the model takes wav2vec2 features (``AsrModel(feature_in=512)``,
    ``feature_mapping`` 512 -> 64 before QuartNet12-context);
  * train-time augmentation is cutout, and the features are not normalized;
  * at the end of an epoch with ``epoch >= pseudo_start_epoch`` and
    ``epoch % pseudo_every_n_epochs == 0``, the unlabeled pool is decoded
    greedily, each utterance scored (``confidence_scores``), those at or
    under the threshold with a non-empty text injected as training data;
    the next epoch's loader draws from them.

In a data-parallel process group each rank decodes its rows of each pool
batch, and the kept (path, text) pairs are gathered batch by batch in rank
order, which is the global row order (``parallel/mesh.py``): every rank
holds one process's pool in one process's order (the pool loader's bucket
plan), whose order the next epoch's shuffle reads.  Every rank injects the
same list (checked by a digest), and the pool counts each utterance once.
"""

from __future__ import annotations

import hashlib
import json
import logging

from ..parallel import distributed
from ..ssl_codec.confidence import confidence_scores
from .trainer import Trainer

logger = logging.getLogger(__name__)


class SSLTrainer(Trainer):
    def __init__(self, *args, pseudo_start_epoch: int = 300, pseudo_every_n_epochs: int = 7,
                 pseudo_confidence_threshold: float = 0.01,
                 pseudo_confidence_measure: str = "ref", **kwargs):
        kwargs.setdefault("from_features", True)
        kwargs.setdefault("augment", "cutout")
        kwargs.setdefault("normalize", False)
        if distributed.data_size() > 1 and kwargs.get("accumulate_grad_batches", 1) > 1:
            # the SSL batchers lay out a rank's rows for one micro-batch
            raise ValueError("accumulate_grad_batches > 1 is not supported in SSL training "
                             "over several ranks")
        super().__init__(*args, **kwargs)
        self.pseudo_start_epoch = pseudo_start_epoch
        self.pseudo_every_n_epochs = pseudo_every_n_epochs
        self.pseudo_confidence_threshold = pseudo_confidence_threshold
        self.pseudo_confidence_measure = pseudo_confidence_measure

    def on_train_epoch_end(self, state, epoch) -> None:
        if epoch < self.pseudo_start_epoch or epoch % self.pseudo_every_n_epochs != 0:
            return
        if not getattr(self.dm, "unlabeled_entries", None):
            return
        logger.info("pseudo-labeling pass at epoch %d", epoch)
        self._pseudo_pass(state)

    def on_resume(self, state, start_epoch) -> None:
        """The injected pseudo set lives in the datamodule, not in the
        checkpoint: when a scheduled pass fired before ``start_epoch``, run
        one now with the restored weights, so that the resumed run trains on
        pseudo labels as the uninterrupted one did."""
        every = self.pseudo_every_n_epochs
        if not any(e % every == 0 for e in range(self.pseudo_start_epoch, start_epoch)):
            return
        if not getattr(self.dm, "unlabeled_entries", None):
            return
        logger.info("pseudo-labeling refresh on resume at epoch %d", start_epoch)
        self._pseudo_pass(state)

    def _pseudo_pass(self, state) -> None:
        kept, total = [], 0
        for batch, dev_batch in self._device_iter(self.dm.pseudo_train_dataloader()):
            n = batch.size
            mine = []
            if n:                          # else a rank's share of the tail: pad rows only
                out = self._eval_step(state, dev_batch)
                texts = self._decode(out, n)
                conf = confidence_scores(out["log_probs"][:n].cpu().numpy(),
                                         out["pred_lens"][:n].cpu().numpy(),
                                         self.vocab.blank_id, self.pseudo_confidence_measure)
                mine = [(path, text) for path, text, c in zip(batch.paths, texts, conf)
                        if c <= self.pseudo_confidence_threshold and text.strip()]
            for rows, pairs in distributed.all_gather_object((n, mine)):   # [(n, mine)] alone
                total += rows
                kept.extend(pairs)
        if distributed.data_size() > 1:
            digest = hashlib.sha256(json.dumps(kept).encode()).hexdigest()
            if len(set(distributed.all_gather_object(digest))) != 1:
                raise RuntimeError("the ranks' pseudo-label pools differ")
        if distributed.is_primary():
            logger.info("pseudo-labeling: kept %d / %d (%.1f%%)", len(kept), total,
                        100.0 * len(kept) / max(total, 1))
        self.loggers.log_metrics({"pseudo_kept": len(kept), "pseudo_total": total},
                                 self.global_step)
        if kept:
            # durations from the unlabeled manifest: a feature-only corpus
            # has no wav on disk to read them from
            durs = {e.audio_filepath: e.duration for e in self.dm.unlabeled_entries}
            self.dm.inject_pseudo_datasets(
                [(p, t, durs[p]) if p in durs else (p, t) for p, t in kept])
