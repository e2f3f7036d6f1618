"""CTC confidence scores (port of ``lightning_asr_tpu/ssl_codec/confidence.py``'s
``sum_logprob``), in numpy as there.

An utterance scores the negated mean of its per-frame max log-probs over the
valid frames, with the reference's constants (the sum starts at -1e-5, the
count's denominator gets +1e-6), against which its pseudo-label threshold
(keep <= 0.01) was calibrated.

The reference means to skip blank frames but compares the argmax with the
class count V+1, which no argmax reaches, so its skip never fires; that is
the default here too.  Passing ``blank_id`` skips the blank frames.
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
