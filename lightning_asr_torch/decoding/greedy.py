"""Greedy CTC decoding (port of ``lightning_asr_tpu/decoding/greedy.py``).

Emit p at frame t when ``(p != previous or previous == blank) and p !=
blank`` within the valid length; the argmax runs on the device, the
collapse on the host over numpy arrays.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


def greedy_emit_mask(predictions: np.ndarray, lengths: np.ndarray, blank_id: int) -> np.ndarray:
    """(B, T) argmax ids + (B,) valid lengths -> (B, T) bool emit mask."""
    predictions = np.asarray(predictions)
    B, T = predictions.shape
    prev = np.concatenate([np.full((B, 1), blank_id, predictions.dtype), predictions[:, :-1]], axis=1)
    valid = np.arange(T)[None, :] < np.asarray(lengths)[:, None]
    return ((predictions != prev) | (prev == blank_id)) & (predictions != blank_id) & valid


def greedy_decode_to_strings(predictions, lengths, vocabulary: Sequence[str],
                             blank_id: Optional[int] = None) -> List[str]:
    """Decode argmax ids (B, T) with valid lengths (B,) to text."""
    vocab = list(vocabulary)
    if blank_id is None:
        blank_id = len(vocab)
    ids = np.asarray(predictions)
    emit = greedy_emit_mask(ids, lengths, blank_id)
    return ["".join(vocab[i] for i in row_ids[row_emit]) for row_ids, row_emit in zip(ids, emit)]
