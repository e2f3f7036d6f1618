"""LM-fused CTC beam search (port of
``lightning_asr_tpu/decoding/beam_search.py``): construct with the
vocabulary, beam width, alpha/beta and an optional ARPA LM path; call
``forward(log_probs, lengths)`` with (B, T, V+1) log-probs to get the best
hypothesis's text per row.  Defaults as the reference uses it: beam 40,
alpha = beta = 1.0, cutoff_prob 0.99, cutoff_top_n 40.

The engine is the repository's C++ prefix beam search with its ARPA n-gram
scorer and hot words over a thread pool (``native.py``), which reads
float32 log-probs on the host.
"""

from __future__ import annotations

import ctypes
import logging
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..native import get_lib

logger = logging.getLogger(__name__)


class BeamSearchDecoderWithLM:
    def __init__(self, vocab: Sequence[str], beam_width: int = 40, alpha: float = 1.0,
                 beta: float = 1.0, lm_path: Optional[str] = None, num_cpus: int = 4,
                 cutoff_prob: float = 0.99, cutoff_top_n: int = 40,
                 hotwords: Optional[dict] = None):
        """``hotwords`` maps word -> additive log-score boost: partial trie
        matches earn boost/len(word) per char and are retracted on a
        mismatch; a completed word locks in exactly its boost.  Words are
        split greedily by the longest matching vocabulary symbol."""
        self.vocab = list(vocab)
        self.num_cpus = max(1, num_cpus)
        self._lib = get_lib()
        self._lm = None
        if lm_path:
            if not Path(lm_path).exists():
                raise FileNotFoundError(f"LM not found: {lm_path}")
            self._lm = self._lib.lasr_lm_load(str(lm_path).encode())
            if not self._lm:
                raise ValueError(f"failed to parse ARPA LM: {lm_path}")
            logger.info("loaded %d-gram ARPA LM from %s", self._lib.lasr_lm_order(self._lm), lm_path)
        c_vocab = (ctypes.c_char_p * len(self.vocab))(*[v.encode("utf-8") for v in self.vocab])
        self._decoder = self._lib.lasr_decoder_create(c_vocab, len(self.vocab), beam_width, alpha,
                                                      beta, cutoff_prob, cutoff_top_n, self._lm)
        for word, boost in (hotwords or {}).items():
            self.add_hotword(word, float(boost))

    def _tokenize(self, word: str) -> List[int]:
        """Greedy longest-match split of ``word`` into vocabulary ids."""
        by_len = sorted({len(v) for v in self.vocab if v}, reverse=True)
        sym = {v: i for i, v in enumerate(self.vocab)}
        ids: List[int] = []
        pos = 0
        while pos < len(word):
            for n in by_len:
                cand = word[pos: pos + n]
                if cand in sym:
                    ids.append(sym[cand])
                    pos += n
                    break
            else:
                raise ValueError(f"hotword {word!r}: no vocab symbol matches at {pos} "
                                 f"({word[pos:]!r})")
        return ids

    def add_hotword(self, word: str, boost: float) -> None:
        """Register a hot word with an additive log-score ``boost``."""
        ids = self._tokenize(word)
        space_ids = {i for i, v in enumerate(self.vocab) if v and v.isspace()}
        if any(i in space_ids for i in ids):
            # the decoder is word-level: a space resets the hot-word trie, so
            # a phrase would earn partial boosts, retract them and never
            # complete
            raise ValueError(f"hotword {word!r} contains a space symbol; the word-level "
                             "decoder matches single words only — register each word separately")
        arr = (ctypes.c_int * len(ids))(*ids)
        self._lib.lasr_decoder_add_hotword(self._decoder, arr, len(ids), ctypes.c_float(boost))

    def forward(self, log_probs, log_probs_length) -> List[str]:
        """(B, T, V+1) log-softmax outputs + per-row lengths, float32 tensors
        on any device or arrays -> texts."""
        if isinstance(log_probs, torch.Tensor):
            if log_probs.dtype != torch.float32:
                raise TypeError(f"the native decoder reads float32 log-probs, got {log_probs.dtype}")
            log_probs = log_probs.cpu().numpy()
        if isinstance(log_probs_length, torch.Tensor):
            log_probs_length = log_probs_length.cpu().numpy()
        log_probs = np.ascontiguousarray(log_probs, np.float32)
        lengths = np.ascontiguousarray(log_probs_length, np.int32)
        B, T, C = log_probs.shape
        if C != len(self.vocab) + 1:
            raise ValueError(f"class dim {C} != vocab+1 ({len(self.vocab) + 1})")
        out_ids = np.zeros((B, T), np.int32)
        out_lens = np.zeros(B, np.int32)
        i32p = ctypes.POINTER(ctypes.c_int)
        self._lib.lasr_decode_batch(
            self._decoder, log_probs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            lengths.ctypes.data_as(i32p), B, T, C, self.num_cpus,
            out_ids.ctypes.data_as(i32p), out_lens.ctypes.data_as(i32p))
        return ["".join(self.vocab[i] for i in out_ids[b, : out_lens[b]]) for b in range(B)]

    __call__ = forward

    def close(self) -> None:
        """Free the native decoder and LM (also done when collected)."""
        if getattr(self, "_decoder", None):
            self._lib.lasr_decoder_free(self._decoder)
            self._decoder = None
        if getattr(self, "_lm", None):
            self._lib.lasr_lm_free(self._lm)
            self._lm = None

    def __del__(self):
        self.close()
