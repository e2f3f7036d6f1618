"""Greedy CTC decoding (port of ``lightning_asr_tpu/decoding/greedy.py``).

Emit p at frame t when ``(p != previous or previous == blank) and p !=
blank`` within the valid length.  The emit mask is computed for the whole
batch on the tensors' device in one elementwise pass
(``greedy_collapse_device``); the host then compacts the masked ids into
strings.  ``greedy_emit_mask`` is the same rule in numpy, the oracle.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch


def greedy_collapse_device(predictions: torch.Tensor, lengths: torch.Tensor,
                           blank_id: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, T) argmax ids + (B,) valid lengths -> (ids, emit_mask), on the
    ids' device; emit_mask[b, t] is True where the collapse appends
    ids[b, t]."""
    B, T = predictions.shape
    prev = torch.cat([torch.full((B, 1), blank_id, dtype=predictions.dtype,
                                 device=predictions.device), predictions[:, :-1]], dim=1)
    t_idx = torch.arange(T, device=predictions.device)[None, :]
    emit = (((predictions != prev) | (prev == blank_id)) & (predictions != blank_id)
            & (t_idx < lengths.to(predictions.device)[:, None]))
    return predictions, emit


def greedy_emit_mask(predictions: np.ndarray, lengths: np.ndarray, blank_id: int) -> np.ndarray:
    """(B, T) argmax ids + (B,) valid lengths -> (B, T) bool emit mask."""
    predictions = np.asarray(predictions)
    B, T = predictions.shape
    prev = np.concatenate([np.full((B, 1), blank_id, predictions.dtype), predictions[:, :-1]], axis=1)
    valid = np.arange(T)[None, :] < np.asarray(lengths)[:, None]
    return ((predictions != prev) | (prev == blank_id)) & (predictions != blank_id) & valid


def compact_to_strings(ids: np.ndarray, emit: np.ndarray, vocabulary: Sequence[str]) -> List[str]:
    """The host's half: each row's emitted ids as text."""
    vocab = list(vocabulary)
    return ["".join(vocab[i] for i in row_ids[row_emit]) for row_ids, row_emit in zip(ids, emit)]


def greedy_decode_to_strings(predictions, lengths, vocabulary: Sequence[str],
                             blank_id: Optional[int] = None) -> List[str]:
    """Decode argmax ids (B, T) with valid lengths (B,), tensors on any
    device or arrays, to text."""
    if blank_id is None:
        blank_id = len(vocabulary)
    ids, emit = greedy_collapse_device(torch.as_tensor(predictions), torch.as_tensor(lengths),
                                       blank_id)
    return compact_to_strings(ids.cpu().numpy(), emit.cpu().numpy(), vocabulary)
