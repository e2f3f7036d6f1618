"""LM-free CTC prefix beam search as batched tensor ops on the device (port
of ``lightning_asr_tpu/decoding/device_beam.py``).

The classic prefix beam search (Hannun et al. 2014) in fixed shapes, all B
rows at once, one Python loop over T in place of ``lax.scan``:

  * the beams are rows of a (B, K) state: log p_blank / log p_nonblank,
    last char, two rolling prefix hashes, the prefix ids (B, K, L) and
    their lengths;
  * each step forms the K stay candidates and the K*V extend candidates,
    merges identical prefixes by one stable sort on the hashes (a segment
    logsumexp) and keeps the top K by total probability;
  * beam-indexed state moves by ``torch.gather`` (the JAX version's one-hot
    products exist for the TPU's matrix unit; a gather is exact).

Prefix identity is two independent 32-bit rolling hashes, held in int64 and
multiplied modulo 2^32 by 16-bit halves so that no product overflows; a
false merge needs both to collide.  The lexicographic order on (h1, h2) is
one stable sort on the int64 key ``(h1 - 2^31)·2^32 + h2``.

Ties keep JAX's order: ``lax.top_k`` puts the lower index first among equal
values, so the top K are the first K of a stable descending sort.  Beams
are distinct prefixes, so a merged segment holds a beam's stay candidate
and at most its parent's extension: two values, whose sum by
``scatter_add`` is the same in either order, so the card gives the same
bits on every run.

The loop reads no value back to the host: nothing waits on the device
until the caller copies the result.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..utils.device import resolve_device

NEG_INF = -1e30

# independent 32-bit rolling-hash multipliers (odd -> bijective mod 2^32)
_M1 = 2654435761   # Knuth multiplicative
_M2 = 0x9E3779B1   # golden-ratio prime
_MASK32 = 0xFFFFFFFF


def _mul_add_32(h: torch.Tensor, m: int, c: torch.Tensor) -> torch.Tensor:
    """(h·m + c) mod 2^32 for int64 h in [0, 2^32): h's 16-bit halves keep
    every product under 2^49."""
    hi, lo = h >> 16, h & 0xFFFF
    return ((((hi * m) & 0xFFFF) << 16) + lo * m + c) & _MASK32


def _lse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise logsumexp(a, b), safe at NEG_INF."""
    m = torch.maximum(a, b)
    lo = torch.minimum(a, b)
    m_safe = m.clamp_min(NEG_INF)
    out = m_safe + torch.log1p(torch.exp(lo - m_safe))
    return torch.where(lo <= NEG_INF, m, out)


def _segment_logsumexp(x: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    """Logsumexp of each segment of the rows of ``x`` (B, N), segment ids
    ``seg`` (B, N) ascending from 0 along each row, broadcast back to every
    element of its segment."""
    m = torch.full_like(x, NEG_INF).scatter_reduce(1, seg, x, reduce="amax", include_self=False)
    m_safe = m.clamp_min(NEG_INF)
    e = torch.exp(x - m_safe.gather(1, seg))
    s = torch.zeros_like(x).scatter_add(1, seg, e)
    out = m_safe + torch.log(s.clamp_min(1e-30))
    return torch.where(m <= NEG_INF, m, out).gather(1, seg)


def beam_search_device(log_probs: torch.Tensor, lengths: torch.Tensor, beam_width: int = 40,
                       blank_id: Optional[int] = None, max_prefix_len: Optional[int] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched LM-free CTC prefix beam search on the tensors' device.

    Args:
      log_probs: (B, T, V+1) float log posteriors, blank = last index.
      lengths: (B,) int valid frame counts.
      beam_width: K.
      max_prefix_len: cap on the emitted prefix length (default T).

    Returns:
      prefixes: (B, K, L) int32 label ids (beams sorted best-first),
      prefix_lens: (B, K) int32,
      scores: (B, K) float32 total log posterior of each beam (merged over
        alignments).
    """
    B, T, C = log_probs.shape
    V = C - 1
    blank = V if blank_id is None else blank_id
    if blank != V:
        raise ValueError("device beam search expects blank = last index")
    K = beam_width
    L = T if max_prefix_len is None else min(max_prefix_len, T)
    dev = log_probs.device
    log_probs = log_probs.to(torch.float32)
    lengths = lengths.to(dev)

    # the state of every row: beam 0 is the empty prefix, the others dummies
    # with distinct hashes so that they never merge
    lp_b = torch.full((B, K), NEG_INF, device=dev)
    lp_b[:, 0] = 0.0
    lp_nb = torch.full((B, K), NEG_INF, device=dev)
    last = torch.full((B, K), -1, dtype=torch.int64, device=dev)
    beams = torch.arange(K, device=dev).expand(B, K)
    h1, h2 = beams * 2 + 1, beams * 4 + 3
    prefix = torch.zeros((B, K, L), dtype=torch.int32, device=dev)
    plen = torch.zeros((B, K), dtype=torch.int64, device=dev)

    # candidates: K stays, then beam k + char c at K + k·V + c
    chars = torch.arange(V, device=dev)
    c_hash = chars + 1
    cand_src = torch.cat([torch.arange(K, device=dev),
                          torch.arange(K, device=dev).repeat_interleave(V)]).expand(B, -1)
    cand_ch = torch.cat([torch.full((K,), -1, device=dev), chars.repeat(K)]).expand(B, -1)
    ext_lp_b = torch.full((B, K * V), NEG_INF, device=dev)
    positions = torch.arange(L, device=dev)

    for t in range(T):
        lp_t = log_probs[:, t]                                       # (B, C)
        total_prev = _lse(lp_b, lp_nb)

        # stay candidates (prefix unchanged): a blank, or a repeat of `last`
        rep = torch.where(last >= 0, lp_t.gather(1, last.clamp(0, V - 1)), NEG_INF)
        s_lp_b = total_prev + lp_t[:, blank:blank + 1]
        s_lp_nb = lp_nb + rep

        # extend candidates: beam k + char c; c == last must follow a blank
        base = torch.where(chars == last[:, :, None], lp_b[:, :, None], total_prev[:, :, None])
        e_lp_nb = (base + lp_t[:, None, :V]).reshape(B, K * V)
        e_h1 = _mul_add_32(h1[:, :, None], _M1, c_hash).reshape(B, K * V)
        e_h2 = _mul_add_32(h2[:, :, None], _M2, c_hash).reshape(B, K * V)

        cand_lp_b = torch.cat([s_lp_b, ext_lp_b], dim=1)
        cand_lp_nb = torch.cat([s_lp_nb, e_lp_nb], dim=1)
        key = (torch.cat([h1, e_h1], dim=1) - (1 << 31)) * (1 << 32) + torch.cat([h2, e_h2], dim=1)

        # merge identical prefixes: equal (h1, h2) pairs are contiguous
        key_s, order = torch.sort(key, dim=1, stable=True)
        head = torch.ones_like(key_s, dtype=torch.bool)
        head[:, 1:] = key_s[:, 1:] != key_s[:, :-1]
        seg = torch.cumsum(head, dim=1) - 1
        m_lpb = _segment_logsumexp(cand_lp_b.gather(1, order), seg)
        m_lpnb = _segment_logsumexp(cand_lp_nb.gather(1, order), seg)
        total = torch.where(head, _lse(m_lpb, m_lpnb), NEG_INF)

        # the top K, lower index first among ties (lax.top_k's order)
        top = torch.sort(total, dim=1, descending=True, stable=True)[1][:, :K]
        n_key = key_s.gather(1, top)
        n_src = cand_src.gather(1, order.gather(1, top))
        n_ch = cand_ch.gather(1, order.gather(1, top))
        n_prefix = prefix.gather(1, n_src[:, :, None].expand(B, K, L))
        src_last, src_plen = last.gather(1, n_src), plen.gather(1, n_src)
        extend = n_ch >= 0
        n_last = torch.where(extend, n_ch, src_last)
        write = extend[:, :, None] & (positions == src_plen[:, :, None])
        n_prefix = torch.where(write, n_ch[:, :, None].to(torch.int32), n_prefix)
        # with max_prefix_len < T the write drops the char past the buffer,
        # so the reported length stops at L
        n_plen = torch.clamp_max(src_plen + extend.to(torch.int64), L)

        # rows past their valid length keep their state
        valid = (t < lengths)[:, None]
        lp_b = torch.where(valid, m_lpb.gather(1, top), lp_b)
        lp_nb = torch.where(valid, m_lpnb.gather(1, top), lp_nb)
        last = torch.where(valid, n_last, last)
        h1 = torch.where(valid, (n_key >> 32) + (1 << 31), h1)
        h2 = torch.where(valid, n_key & _MASK32, h2)
        prefix = torch.where(valid[:, :, None], n_prefix, prefix)
        plen = torch.where(valid, n_plen, plen)

    score = _lse(lp_b, lp_nb)
    order = torch.sort(-score, dim=1, stable=True)[1]
    prefixes = prefix.gather(1, order[:, :, None].expand(B, K, L))
    return prefixes, plen.gather(1, order).to(torch.int32), score.gather(1, order)


class DeviceBeamSearchDecoder:
    """The LM-free path with ``BeamSearchDecoderWithLM.forward``'s interface:
    (B, T, V+1) log-probs + lengths, tensors on any device or arrays ->
    the best hypothesis's text per row, searched on ``device`` (``cuda``
    unless given)."""

    def __init__(self, vocab: Sequence[str], beam_width: int = 40, device=None):
        self.vocab = list(vocab)
        self.beam_width = beam_width
        self.device = resolve_device(device)

    def forward(self, log_probs, lengths) -> List[str]:
        prefixes, plens, _ = beam_search_device(
            torch.as_tensor(log_probs).to(self.device), torch.as_tensor(lengths).to(self.device),
            self.beam_width)
        prefixes, plens = prefixes[:, 0].cpu().numpy(), plens[:, 0].cpu().numpy()
        return ["".join(self.vocab[i] for i in row[:n]) for row, n in zip(prefixes, plens)]

    __call__ = forward
