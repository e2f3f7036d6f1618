"""CTC confidence scores for pseudo-label filtering (port of
``lightning_asr_tpu/ssl_codec/confidence.py``), in numpy as there.

An utterance scores the negated mean of its per-frame max log-probs over the
valid frames, with the reference's constants (the sum starts at -1e-5, the
count's denominator gets +1e-6), against which its pseudo-label threshold
(keep <= 0.01) was calibrated.

The reference means to skip blank frames but compares the argmax with the
class count V+1, which no argmax reaches, so its skip never fires; that is
the default here too.  Passing ``blank_id`` skips the blank frames.

``confidence_scores`` picks one of four measures (lower is more confident
for each, so one threshold convention covers them); ``seq_sum_logprob``
keeps the reference's one-utterance (index, log-probs, length) protocol.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def sum_logprob(log_probs: np.ndarray, lengths: np.ndarray,
                blank_id: Optional[int] = None) -> np.ndarray:
    """(B, T, C) log-probs + (B,) valid lengths -> (B,) confidence scores
    (lower = more confident)."""
    log_probs = np.asarray(log_probs)
    lengths = np.asarray(lengths)
    B, T, C = log_probs.shape
    am = log_probs.argmax(axis=-1)
    mx = log_probs.max(axis=-1)
    valid = np.arange(T)[None, :] < lengths[:, None]
    if blank_id is not None:
        valid = valid & (am != blank_id)
    total = (mx * valid).sum(axis=1) - 1e-5
    count = valid.sum(axis=1).astype(np.float64)
    return -(total / (count + 1e-6))


def confidence_scores(log_probs: np.ndarray, lengths: np.ndarray, blank_id: int,
                      measure: str = "ref") -> np.ndarray:
    """(B,) per-utterance scores, lower = more confident.  ``measure``:

    * ``ref``: the reference's score (``sum_logprob`` with its never-firing
      blank skip);
    * ``nonblank``: the mean max log-prob over non-blank frames only;
    * ``min_maxlp``: the negated weakest valid frame's max log-prob;
    * ``entropy``: the mean per-frame posterior entropy (nats) over the
      valid frames."""
    log_probs = np.asarray(log_probs, np.float32)
    lengths = np.asarray(lengths)
    B, T, C = log_probs.shape
    valid = np.arange(T)[None, :] < lengths[:, None]
    if measure == "ref":
        return sum_logprob(log_probs, lengths, None)
    if measure == "nonblank":
        return sum_logprob(log_probs, lengths, blank_id)
    mx = log_probs.max(axis=-1)
    if measure == "min_maxlp":
        return -np.where(valid, mx, np.inf).min(axis=1)
    if measure == "entropy":
        ent = -(np.exp(log_probs) * log_probs).sum(axis=-1)
        return (ent * valid).sum(axis=1) / np.maximum(valid.sum(axis=1), 1)
    raise ValueError(f"unknown confidence measure {measure!r}")


def seq_sum_logprob(data: tuple, blank_id: Optional[int] = None) -> tuple:
    """(index, (T, C) log-probs, length) -> (index, score)."""
    idx, log_probs, length = data
    score = sum_logprob(np.asarray(log_probs)[None], np.asarray([length]), blank_id)[0]
    return idx, float(score)
