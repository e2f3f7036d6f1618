"""The port's decoding modules on the CPU against the JAX package on the same
seeded inputs: the greedy collapse, the LM-free device beam search (also
against a brute-force path enumeration), the native LM beam search with hot
words, the native Levenshtein distance and the confidence score."""

import itertools
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightning_asr_tpu.decoding import device_beam as jax_device_beam
from lightning_asr_tpu.decoding import greedy as jax_greedy
from lightning_asr_tpu.decoding.beam_search import BeamSearchDecoderWithLM as JaxLMDecoder
from lightning_asr_tpu.native import editdistance_eval as jax_editdistance
from lightning_asr_tpu.ssl_codec.confidence import sum_logprob as jax_sum_logprob
from lightning_asr_torch import native
from lightning_asr_torch.decoding import device_beam
from lightning_asr_torch.decoding.beam_search import BeamSearchDecoderWithLM
from lightning_asr_torch.decoding.device_beam import DeviceBeamSearchDecoder, beam_search_device
from lightning_asr_torch.decoding.greedy import (greedy_collapse_device, greedy_decode_to_strings,
                                                 greedy_emit_mask)
from lightning_asr_torch.metrics.wer import editdistance_eval as py_editdistance
from lightning_asr_torch.ssl_codec.confidence import sum_logprob

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "scripts"))
from make_arpa_lm import train_arpa, write_arpa  # noqa: E402

EN = [" ", "'"] + [chr(ord("a") + i) for i in range(26)]
# scores: float32 log-space sums through torch's exp/log1p/log against
# XLA's, a few ulps a step over up to 32 steps
SCORE_RTOL = 1e-5


def _log_softmax(logits):
    return (logits - np.log(np.exp(logits).sum(-1, keepdims=True))).astype(np.float32)


def _random_log_probs(seed, B, T, C, scale):
    rng = np.random.default_rng(seed)
    return _log_softmax(rng.standard_normal((B, T, C)).astype(np.float32) * scale)


# ---------------------------------------------------------------- greedy

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_greedy_collapse_matches_jax(seed):
    rng = np.random.default_rng(seed)
    B, T, blank = 5, 40, 28
    # runs of repeats and blanks, as argmax ids come
    preds = np.repeat(rng.integers(0, blank + 1, (B, T // 2)), 2, axis=1).astype(np.int32)
    preds[rng.random((B, T)) < 0.2] = blank
    lengths = np.asarray([T, 0, 1, 17, 33], np.int32)
    ids, emit = greedy_collapse_device(torch.from_numpy(preds), torch.from_numpy(lengths), blank)
    want_ids, want_emit = jax_greedy.greedy_collapse_device(jnp.asarray(preds),
                                                            jnp.asarray(lengths), blank)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    np.testing.assert_array_equal(emit.numpy(), np.asarray(want_emit))
    np.testing.assert_array_equal(emit.numpy(), greedy_emit_mask(preds, lengths, blank))
    assert greedy_decode_to_strings(preds, lengths, EN, blank) == \
        jax_greedy.greedy_decode_to_strings(preds, lengths, EN, blank)


# ------------------------------------------------------------ device beam

def brute_force_posteriors(log_probs, length, blank):
    """Exact collapsed-sequence posteriors by enumerating every alignment
    path, (V+1)^length of them."""
    out = {}
    for path in itertools.product(range(log_probs.shape[1]), repeat=length):
        lp = sum(log_probs[t, c] for t, c in enumerate(path))
        seq, prev = [], blank
        for c in path:
            if c != blank and c != prev:
                seq.append(c)
            prev = c
        key = tuple(seq)
        out[key] = np.logaddexp(out[key], lp) if key in out else lp
    return out


def _run_both(log_probs, lengths, K, max_prefix_len=None):
    got = [x.numpy() for x in beam_search_device(torch.from_numpy(log_probs),
                                                 torch.from_numpy(lengths), K,
                                                 max_prefix_len=max_prefix_len)]
    want = [np.asarray(x) for x in jax_device_beam.beam_search_device(
        jnp.asarray(log_probs), jnp.asarray(lengths), K, max_prefix_len=max_prefix_len)]
    return got, want


def _assert_beams_equal(got, want):
    (p, pl, s), (wp, wpl, ws) = got, want
    assert p.dtype == np.int32 and pl.dtype == np.int32 and s.dtype == np.float32
    assert p.shape == wp.shape and pl.shape == wpl.shape and s.shape == ws.shape
    finite = ws > -1e29
    np.testing.assert_array_equal(finite, s > -1e29)
    np.testing.assert_array_equal(pl[finite], wpl[finite])
    for b, k in zip(*np.nonzero(finite)):
        np.testing.assert_array_equal(p[b, k, : pl[b, k]], wp[b, k, : wpl[b, k]])
    np.testing.assert_allclose(s[finite], ws[finite], rtol=SCORE_RTOL)


def test_device_beam_matches_jax_ragged():
    lp = _random_log_probs(0, 3, 32, 29, 3.0)
    lengths = np.asarray([32, 20, 7], np.int32)
    got, want = _run_both(lp, lengths, 16)
    _assert_beams_equal(got, want)
    assert (got[2] > -1e29).all()                   # every beam is a real prefix


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_exhaustive_device_beam_matches_bruteforce(seed):
    T, V = 6, 3
    lp = _random_log_probs(seed, 1, T, V + 1, 2.0)
    oracle = brute_force_posteriors(lp[0], T, blank=V)
    best_seq, best_lp = max(oracle.items(), key=lambda kv: kv[1])
    got, want = _run_both(lp, np.asarray([T], np.int32), 64)
    _assert_beams_equal(got, want)
    prefixes, plens, scores = got
    assert tuple(prefixes[0, 0, : plens[0, 0]]) == best_seq
    np.testing.assert_allclose(scores[0, 0], best_lp, atol=5e-4)
    # the beams are distinct prefixes, best first
    assert len({tuple(prefixes[0, k, : plens[0, k]]) for k in range(64)}) == 64
    assert (np.diff(scores[0]) <= 0).all()


def test_device_beam_length_masking_against_bruteforce():
    lp = _random_log_probs(3, 3, 6, 4, 2.0)
    lengths = np.asarray([6, 4, 2], np.int32)
    got, want = _run_both(lp, lengths, 64)
    _assert_beams_equal(got, want)
    for b in range(3):
        oracle = brute_force_posteriors(lp[b], int(lengths[b]), blank=3)
        best_seq, best_lp = max(oracle.items(), key=lambda kv: kv[1])
        assert tuple(got[0][b, 0, : got[1][b, 0]]) == best_seq, b
        np.testing.assert_allclose(got[2][b, 0], best_lp, atol=5e-4)


def test_device_beam_max_prefix_len_clamp():
    rng = np.random.default_rng(3)
    T, C = 8, 4
    lp = np.log(rng.dirichlet(np.ones(C), size=(1, T)).astype(np.float32))
    lp[:, :, -1] = -8.0     # discourage blank so prefixes grow past L
    got, want = _run_both(lp, np.asarray([T], np.int32), 4, max_prefix_len=3)
    _assert_beams_equal(got, want)
    assert got[0].shape[-1] == 3 and int(got[1].max()) == 3


def test_device_beam_segments_hold_at_most_two(monkeypatch):
    """A merged segment holds a beam's stay candidate and at most its
    parent's extension, so the scatter sums add two values, in either order
    the same bits."""
    sizes = []
    inner = device_beam._segment_logsumexp

    def counting(x, seg):
        sizes.append(int(torch.zeros_like(seg).scatter_add(1, seg, torch.ones_like(seg)).max()))
        return inner(x, seg)

    monkeypatch.setattr(device_beam, "_segment_logsumexp", counting)
    beam_search_device(torch.from_numpy(_random_log_probs(0, 3, 32, 29, 3.0)),
                       torch.tensor([32, 20, 7]), 16)
    for seed in range(3):
        beam_search_device(torch.from_numpy(_random_log_probs(seed, 1, 6, 4, 2.0)),
                           torch.tensor([6]), 64)
    assert len(sizes) == 2 * (32 + 3 * 6)
    assert max(sizes) == 2, sizes


def test_device_beam_decoder_on_peaked_input_is_greedy():
    vocab = [" ", "a", "b"]
    ids = np.asarray([[1, 1, 3, 2, 2, 3, 1, 3]], np.int32)  # blank = 3
    T, C = ids.shape[1], len(vocab) + 1
    lp = np.full((1, T, C), -20.0, np.float32)
    lp[0, np.arange(T), ids[0]] = 0.0
    lengths = np.asarray([T], np.int32)
    dev = DeviceBeamSearchDecoder(vocab, beam_width=8, device="cpu")
    assert dev.forward(lp, lengths) == greedy_decode_to_strings(ids, lengths, vocab, 3) == ["aba"]


# --------------------------------------------------------- native decoder

def test_native_library_is_the_ports_own_build():
    lib = native.get_lib()
    assert native.library_path().parent == REPO / "build" / "torch_native"
    assert native.library_path().exists()
    assert Path(lib._name) == native.library_path()


def test_native_build_failure_raises_with_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text("int main( {\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match=r"(?s)g\+\+ failed.*error"):
        native.build()
    assert not list((tmp_path / "build").glob("*.so"))


CORPUS = ["the cat sat on the mat", "the dog sat on the log", "a cat and a dog",
          "the cat ate the rat", "a dog ate a bone", "the rat sat"]


@pytest.fixture(scope="module")
def arpa(tmp_path_factory):
    tables, _ = train_arpa([s.split() for s in CORPUS], 3)
    path = tmp_path_factory.mktemp("lm") / "lm.arpa"
    write_arpa(tables, str(path))
    return str(path)


def _spelled(texts, seed, confusion=0.45):
    """(B, T, 29) log-probs spelling each text, each char over two frames
    then a blank, with a random runner-up char taking ``confusion`` of the
    mass on some frames."""
    rng = np.random.default_rng(seed)
    rows = []
    for text in texts:
        frames = []
        for ch in text:
            c = EN.index(ch)
            p = np.full(29, 0.002)
            p[c] = 1.0
            if confusion and rng.random() < 0.5:
                p[rng.integers(2, 28)] = confusion * 1.0 / (1 - confusion)
            frames += [p, p, np.eye(29)[28] + 0.002]
        rows.append(np.log(np.stack(frames) / np.stack(frames).sum(-1, keepdims=True)))
    T = max(len(r) for r in rows)
    out = np.full((len(rows), T, 29), np.log(1 / 29), np.float32)
    lengths = np.zeros(len(rows), np.int32)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r
        lengths[i] = len(r)
    return out, lengths


@pytest.mark.parametrize("with_lm", [False, True])
def test_native_beam_matches_jax(arpa, with_lm):
    lp, lengths = _spelled(["the cat sat", "a dog ate a bone", "the rat sat on the mat",
                            "a cat"], seed=4)
    kw = dict(beam_width=16, alpha=2.0, beta=0.5, num_cpus=2,
              lm_path=arpa if with_lm else None)
    port = BeamSearchDecoderWithLM(EN, **kw)
    got = port.forward(lp, lengths)
    assert got == JaxLMDecoder(EN, **kw).forward(lp, lengths)
    # a float32 tensor is read as its array
    assert port.forward(torch.from_numpy(lp), torch.from_numpy(lengths)) == got
    with pytest.raises(TypeError, match="float32"):
        port.forward(torch.from_numpy(lp).to(torch.bfloat16), lengths)
    port.close()


def test_lm_changes_a_decision(arpa):
    """The LM is in play: it overturns an acoustically preferred spelling."""
    lp, lengths = _spelled(["the cat sat"], seed=0, confusion=0.0)
    # the frames of "cat"'s a lean to e: "cet" is no word of the corpus
    p = np.full(29, 0.0004)
    p[EN.index("e")], p[EN.index("a")] = 0.55, 0.44
    lp[0, 15:17] = np.log(p / p.sum())
    no_lm = BeamSearchDecoderWithLM(EN, beam_width=16, alpha=2.0, beta=0.0)
    with_lm = BeamSearchDecoderWithLM(EN, beam_width=16, alpha=2.0, beta=0.0, lm_path=arpa)
    assert no_lm.forward(lp, lengths) == ["the cet sat"]
    assert with_lm.forward(lp, lengths) == ["the cat sat"]
    assert JaxLMDecoder(EN, beam_width=16, alpha=2.0, beta=0.0, lm_path=arpa).forward(
        lp, lengths) == ["the cat sat"]


def test_device_beam_agrees_with_native():
    """The same top-1 text as the C++ prefix beam (no LM, no pruning)."""
    vocab = [" ", "a", "b", "c"]
    lp = _random_log_probs(7, 2, 32, 5, 3.0)
    lengths = np.asarray([32, 20], np.int32)
    cpp = BeamSearchDecoderWithLM(vocab, beam_width=64, cutoff_prob=1.0, cutoff_top_n=5)
    dev = DeviceBeamSearchDecoder(vocab, beam_width=64, device="cpu")
    assert dev.forward(lp, lengths) == cpp.forward(lp, lengths)


HOT_VOCAB = [" ", "a", "b", "c"]   # blank = 4


def _hot_lp(rows, C=5, vocab=HOT_VOCAB):
    out = np.full((1, len(rows), C), -12.0, np.float32)
    idx = {s: i for i, s in enumerate(vocab)}
    idx["_"] = C - 1
    for t, row in enumerate(rows):
        for s, v in row.items():
            out[0, t, idx[s]] = v
    return out


_CLOSE = [{"a": -0.05, "_": -4.0}, {"c": -0.6, "b": -0.9, "_": -3.0}]
HOT_CASES = {
    # (vocab, hotwords, lattice, want) from the JAX package's hot-word tests
    "baseline": (HOT_VOCAB, {}, _CLOSE, "ac"),
    "completed_flips": (HOT_VOCAB, {"ab": 3.0}, _CLOSE, "ab"),
    "incomplete_retracted": (HOT_VOCAB, {"abc": 9.0}, _CLOSE, "ac"),
    "word_boundary_retracts": (HOT_VOCAB, {"abc": 9.0},
                               [{"a": -0.05}, {"c": -0.4, "b": -0.5}, {" ": -0.05}, {"c": -0.05}],
                               "ac c"),
    "exact_boost_below": (HOT_VOCAB, {"ab": 1.9}, [{"a": -0.05}, {"c": -0.1, "b": -2.1}], "ac"),
    "exact_boost_above": (HOT_VOCAB, {"ab": 2.1}, [{"a": -0.05}, {"c": -0.1, "b": -2.1}], "ab"),
    "char_level_restart": (["x", "y", "z"], {"yz": 3.0},
                           [{"x": -0.05}, {"y": -0.05}, {"z": -1.5, "x": -1.2}], "xyz"),
}


@pytest.mark.parametrize("case", sorted(HOT_CASES))
def test_hotwords_match_jax(case):
    vocab, hot, rows, want = HOT_CASES[case]
    lp = _hot_lp(rows, len(vocab) + 1, vocab)
    lengths = np.asarray([len(rows)], np.int32)
    kw = dict(beam_width=8, alpha=1.0, beta=0.0, num_cpus=1, hotwords=hot)
    assert BeamSearchDecoderWithLM(vocab, **kw).forward(lp, lengths) == [want]
    assert JaxLMDecoder(vocab, **kw).forward(lp, lengths) == [want]


def test_hotword_with_lm_matches_jax(arpa):
    lp, lengths = _spelled(["the cat sat", "a dog ate a bone"], seed=2)
    kw = dict(beam_width=16, alpha=1.0, beta=0.5, lm_path=arpa, hotwords={"bone": 3.0, "cat": 2.0})
    assert BeamSearchDecoderWithLM(EN, **kw).forward(lp, lengths) == \
        JaxLMDecoder(EN, **kw).forward(lp, lengths)


def test_hotword_tokenization_and_multiword_rejection():
    dec = BeamSearchDecoderWithLM([" ", "th", "e", "a"], beam_width=4, hotwords={"the": 1.0})
    assert dec._tokenize("the") == [1, 2]
    with pytest.raises(ValueError):
        dec._tokenize("thx")
    with pytest.raises(ValueError, match="space"):
        BeamSearchDecoderWithLM(HOT_VOCAB, beam_width=4, hotwords={"a b": 2.0})


@pytest.mark.parametrize("seed", [0, 1])
def test_native_editdistance_matches_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(20):
        a = list(rng.integers(0, 5, rng.integers(0, 12)))
        b = list(rng.integers(0, 5, rng.integers(0, 12)))
        assert native.editdistance_eval(a, b) == jax_editdistance(a, b) == py_editdistance(a, b)
    assert native.editdistance_eval("x y z".split(), "x z".split()) == 1


# ------------------------------------------------------------- confidence

@pytest.mark.parametrize("blank_id", [None, 28])
def test_sum_logprob_bit_equal(blank_id):
    lp = _random_log_probs(5, 4, 30, 29, 2.0)
    lp[1, :, 28] += 3.0          # a row of mostly blank frames
    lengths = np.asarray([30, 21, 0, 1], np.int32)
    got = sum_logprob(lp, lengths, blank_id)
    np.testing.assert_array_equal(got, jax_sum_logprob(lp, lengths, blank_id))
    assert got.dtype == np.float64
