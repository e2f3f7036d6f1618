"""WER/CER metric (port of ``lightning_asr_tpu/metrics/wer.py``).

  * ``word_error_rate(hyps, refs, use_cer)``: corpus error rate = the sum of
    edit distances over the sum of reference lengths, by words or by
    characters;
  * ``WER`` accumulates the (errors, words) counts; ``update`` returns the
    batch's rate (what the reference logs per step), ``compute`` the
    accumulated corpus rate.

The Levenshtein distance is a small dynamic program in Python.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def editdistance_eval(a: Sequence, b: Sequence) -> int:
    """Levenshtein distance between two token sequences."""
    if len(a) < len(b):
        a, b = b, a
    if not b:
        return len(a)
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def _tokenize(text: str, use_cer: bool) -> List[str]:
    return list(text) if use_cer else text.split()


def _counts(hypotheses: List[str], references: List[str], use_cer: bool):
    scores = words = 0
    for h, r in zip(hypotheses, references):
        r_toks = _tokenize(r, use_cer)
        words += len(r_toks)
        scores += editdistance_eval(_tokenize(h, use_cer), r_toks)
    return scores, words


def word_error_rate(hypotheses: List[str], references: List[str], use_cer: bool = False) -> float:
    """Corpus-level WER/CER over paired hypothesis/reference lists."""
    if len(hypotheses) != len(references):
        raise ValueError("hypotheses and references must have the same number of elements, "
                         f"got {len(hypotheses)} and {len(references)}")
    scores, words = _counts(hypotheses, references, use_cer)
    return scores / words if words else float("inf")


class WER:
    """Accumulating WER/CER metric."""

    def __init__(self, vocabulary: Sequence[str], use_cer: bool = False):
        self.vocabulary = list(vocabulary)
        self.use_cer = use_cer
        self.reset()

    def reset(self) -> None:
        self.scores = 0
        self.words = 0

    def decode_ids(self, ids: Sequence[int]) -> str:
        return "".join(self.vocabulary[int(i)] for i in ids)

    def decode_reference(self, targets, target_lengths) -> List[str]:
        """(B, L) padded label ids + lengths -> reference strings."""
        return [self.decode_ids(row[: int(n)])
                for row, n in zip(np.asarray(targets), np.asarray(target_lengths))]

    def update(self, hypotheses: List[str], references: List[str]) -> float:
        scores, words = _counts(hypotheses, references, self.use_cer)
        self.scores += scores
        self.words += words
        return scores / words if words else float("inf")

    def compute(self) -> float:
        return self.scores / self.words if self.words else float("inf")
