"""Parity: the port's data path (``lightning_asr_torch/data/``: vocabulary,
manifests, ``BucketBatcher``, ``AsrDataModule``) and ``wave_crop`` against
the JAX package's, on a tone-language corpus of WAV files written here.

Given the same manifest and seed, the batches must be identical: every
array, path and text, for the train loader (crop on) and the eval loader,
on each wire and over two epochs.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightning_asr_tpu.data.datamodule import AsrDataModule as JaxDataModule
from lightning_asr_tpu.data.manifest import read_manifests as jax_read_manifests
from lightning_asr_tpu.data.pipeline import BucketBatcher as JaxBatcher
from lightning_asr_tpu.data.vocab import Vocabulary as JaxVocabulary
from lightning_asr_tpu.ops.augment import wave_crop as jax_wave_crop
from lightning_asr_torch.data.audio import write_wav
from lightning_asr_torch.data.datamodule import AsrDataModule
from lightning_asr_torch.data.manifest import ManifestEntry, read_manifests, write_manifest
from lightning_asr_torch.data.pipeline import BucketBatcher, mulaw_encode, prefetch
from lightning_asr_torch.data.vocab import Vocabulary
from lightning_asr_torch.ops.augment import wave_crop
from lightning_asr_torch.ops.frontend import expand_wire

LABELS = [" ", "'"] + [chr(ord("a") + i) for i in range(26)]
CHARS = "abcdefghij"
SR = 16000


def tone_corpus(root: Path, n: int, seed: int, lo: float = 1.0, hi: float = 1.9,
                name: str = "manifest") -> Path:
    """``n`` utterances of a tone language (each of ten characters a sine
    tone of 80 ms, a space silence, light noise) of ``lo``-``hi`` seconds,
    and their JSONL manifest."""
    rng = np.random.default_rng(seed)
    freqs = {c: 300.0 + 150.0 * i for i, c in enumerate(CHARS)}
    t = np.arange(int(SR * 0.08)) / SR
    rows = []
    for i in range(n):
        n_chars = int(rng.uniform(lo, hi) / 0.08)
        text = ""
        while len(text) < n_chars:
            word = "".join(rng.choice(list(CHARS), size=rng.integers(2, 5)))
            text = f"{text} {word}" if text else word
        text = text[:n_chars].strip()
        wave = np.concatenate([np.zeros_like(t) if c == " " else 0.3 * np.sin(2 * np.pi * freqs[c] * t)
                               for c in text]).astype(np.float32)
        wave += 0.01 * rng.standard_normal(wave.shape).astype(np.float32)
        path = root / f"{name}_{i}.wav"
        write_wav(path, wave, SR)
        rows.append({"audio_filepath": str(path), "duration": len(wave) / SR, "text": text})
    manifest = root / f"{name}.json"
    manifest.write_text("".join(json.dumps(r) + "\n" for r in rows))
    return manifest


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return tone_corpus(tmp_path_factory.mktemp("corpus"), 24, 0)


BUCKETS = (1.2, 1.6, 2.0)


def _assert_same_batches(ours, theirs):
    ours, theirs = list(ours), list(theirs)
    assert len(ours) == len(theirs) > 0
    for a, b in zip(ours, theirs):
        for k in ("waves", "wave_lens", "prev_samples", "targets", "target_lens"):
            x, y = getattr(a, k), getattr(b, k)
            assert x.dtype == y.dtype and x.shape == y.shape, k
            np.testing.assert_array_equal(x, y, err_msg=k)
        assert a.paths == b.paths and a.texts == b.texts


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("wire", ["int16", "mulaw8", "float32"])
def test_batches_equal_jax(corpus, wire, train):
    entries = read_manifests(corpus, 16.7)
    jentries = jax_read_manifests(corpus, 16.7)
    kw = dict(batch_size=5, train=train, bucket_seconds=BUCKETS, seed=3, wire_dtype=wire)
    ours = BucketBatcher(entries, Vocabulary(LABELS), **kw)
    theirs = JaxBatcher(jentries, JaxVocabulary(LABELS), **kw)
    assert len(ours) == len(theirs)
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        _assert_same_batches(ours, theirs)


@pytest.mark.parametrize("wire", ["int16", "float32"])
def test_ram_cache_equals_jax(corpus, wire):
    """``cache='ram'``: decoded once, crops sliced from RAM on the second
    epoch; the same batches as JAX's cached and uncached loaders."""
    cache, jcache = {}, {}
    kw = dict(batch_size=4, train=True, bucket_seconds=BUCKETS, seed=5, wire_dtype=wire)
    ours = BucketBatcher(read_manifests(corpus), Vocabulary(LABELS), wave_cache=cache, **kw)
    theirs = JaxBatcher(jax_read_manifests(corpus), JaxVocabulary(LABELS), wave_cache=jcache, **kw)
    plain = JaxBatcher(jax_read_manifests(corpus), JaxVocabulary(LABELS), **kw)
    seen = set()
    for epoch in (0, 1):
        for b in (ours, theirs, plain):
            b.set_epoch(epoch)
        got = list(ours)
        _assert_same_batches(got, theirs)
        _assert_same_batches(got, plain)
        seen.update(p for batch in got for p in batch.paths)
    assert set(cache) == seen and all(v.dtype == np.int16 for v in cache.values())


def test_datamodule_and_steps_per_epoch_equal_jax(corpus, tmp_path):
    dev = tone_corpus(tmp_path, 7, 1, name="dev")
    kw = dict(train_manifest=str(corpus), dev_manifest=str(dev), test_manifest=str(dev),
              labels=LABELS, train_bs=5, dev_bs=3, bucket_seconds=BUCKETS, seed=2)
    ours, theirs = AsrDataModule(**kw), JaxDataModule(**kw)
    assert ours.steps_per_epoch() == theirs.steps_per_epoch() == len(ours.train_dataloader(0))
    _assert_same_batches(ours.train_dataloader(1), theirs.train_dataloader(1))
    _assert_same_batches(ours.val_dataloader(), theirs.val_dataloader())
    _assert_same_batches(ours.test_dataloader(), theirs.test_dataloader())
    assert ours.vocab.blank_id == len(LABELS) and not ours.vocab.use_cer


def test_manifest_duration_filter_and_round_trip(corpus, tmp_path):
    for cut in (1.3, 1.6, 40.0):
        ours = read_manifests([corpus, corpus], cut)
        theirs = jax_read_manifests([corpus, corpus], cut)
        assert [(e.audio_filepath, e.duration, e.text) for e in ours] == \
            [(e.audio_filepath, e.duration, e.text) for e in theirs]
        assert all(e.duration <= cut for e in ours)
    assert 0 < len(read_manifests(corpus, 1.3)) < 24
    path = tmp_path / "copy.json"
    write_manifest(path, [ManifestEntry("a b.wav", 1.25, "ün ab")])
    assert read_manifests(path) == [ManifestEntry("a b.wav", 1.25, "ün ab")]


def test_vocab_from_a_file_flips_cer(tmp_path):
    path = tmp_path / "vocab.txt"
    path.write_text("你\n好\n\n世\n界\n", encoding="utf-8")
    ours, theirs = Vocabulary.from_config(str(path)), JaxVocabulary.from_config(str(path))
    assert ours.labels == theirs.labels == ["你", "好", "世", "界"]
    assert ours.use_cer and theirs.use_cer
    assert ours.encode("世界你") == theirs.encode("世界你") == [2, 3, 0]
    assert ours.num_classes == 5 and ours.blank_id == 4
    inline = Vocabulary.from_config(LABELS)
    assert not inline.use_cer and inline.encode("ab c") == JaxVocabulary.from_config(LABELS).encode("ab c")


def _jax_draws(key, B, weight):
    """The two uniforms ``lightning_asr_tpu.ops.augment.wave_crop`` draws."""
    r1, r2 = jax.random.split(key)
    return (np.array(jax.random.uniform(r1, (B,), minval=weight, maxval=1.0)),
            np.array(jax.random.uniform(r2, (B,))))


@pytest.mark.parametrize("wire", ["int16", "float32"])
def test_wave_crop_equals_jax_given_its_draws(wire):
    rng = np.random.default_rng(4)
    B, S = 6, 4000
    lens = np.array([4000, 3999, 2500, 100, 1, 3000], np.int32)
    waves = np.zeros((B, S), np.int16)
    for b, n in enumerate(lens):
        waves[b, :n] = rng.integers(-30000, 30000, n)
    if wire == "float32":
        waves = waves.astype(np.float32) / 32768.0
    for seed, weight in ((0, 0.98), (1, 0.5), (2, 0.0)):
        key = jax.random.PRNGKey(seed)
        want = [np.asarray(a) for a in jax_wave_crop(jnp.asarray(waves), jnp.asarray(lens), key, weight)]
        got = wave_crop(torch.from_numpy(waves), torch.from_numpy(lens), weight=weight,
                        uniforms=_jax_draws(key, B, weight))
        for g, w in zip(got, want):
            assert g.numpy().dtype == w.dtype
            np.testing.assert_array_equal(g.numpy(), w)


def test_wave_crop_mulaw_deviation():
    """On the mu-law wire the port fills past the new length with code 128
    (silence) and returns the sample before the crop decoded; the JAX
    package fills with code 0 (about -1.0) and returns the raw code
    (ROADMAP.md §C1).  Lengths and the kept samples agree."""
    rng = np.random.default_rng(5)
    B, S = 4, 3000
    lens = np.array([3000, 2000, 1500, 10], np.int32)
    pcm = np.zeros((B, S), np.int16)
    for b, n in enumerate(lens):
        pcm[b, :n] = rng.integers(-20000, 20000, n)
    codes = mulaw_encode(pcm)
    key = jax.random.PRNGKey(3)
    draws = _jax_draws(key, B, 0.5)
    jw, jl, jp = (np.asarray(a) for a in jax_wave_crop(jnp.asarray(codes), jnp.asarray(lens), key, 0.5))
    w, nl, prev = (a.numpy() for a in wave_crop(torch.from_numpy(codes), torch.from_numpy(lens),
                                                 weight=0.5, uniforms=draws))
    np.testing.assert_array_equal(nl, jl)
    offsets = np.floor(draws[1] * (lens - np.floor(lens * draws[0]))).astype(np.int64)
    for b in range(B):
        np.testing.assert_array_equal(w[b, :nl[b]], jw[b, :nl[b]])
        assert np.all(w[b, nl[b]:] == 128) and np.all(jw[b, nl[b]:] == 0)
        if offsets[b] > 0:
            code = codes[b, offsets[b] - 1]
            assert jp[b] == np.float32(code)              # JAX: the raw code
            assert prev[b] == expand_wire(torch.tensor([code], dtype=torch.uint8)).item()
    assert (offsets > 0).any()
    silence = expand_wire(torch.from_numpy(w)).numpy()
    assert np.all(silence[:, -1][nl < S] == 0.0)


def test_prefetch_order_and_error():
    assert list(prefetch(iter(range(20)), depth=3)) == list(range(20))

    def bad():
        yield 1
        raise RuntimeError("boom")

    it = prefetch(bad(), depth=2)
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="boom"):
        next(it)


def test_unported_options_raise(corpus):
    # row sharding is ported (tests/test_torch_data_parallel.py); a world
    # that pad_to does not divide is refused, as in the JAX batcher
    with pytest.raises(ValueError, match="pad_to"):
        BucketBatcher(read_manifests(corpus), Vocabulary(LABELS), 4, shard_count=2)
    # cache='mmap' is ported (tests/test_torch_wave_cache.py): it opens its
    # default directory beside the train manifest; an unknown cache raises
    dm = AsrDataModule(train_manifest=str(corpus), labels=LABELS, cache="mmap")
    assert dm.cache_dir == Path(corpus).parent / "_lasr_wave_cache" and dm.cache_dir.is_dir()
    with pytest.raises(ValueError, match="cache"):
        AsrDataModule(train_manifest=str(corpus), labels=LABELS, cache="disk")
    with pytest.raises(ValueError):
        BucketBatcher(read_manifests(corpus), Vocabulary(LABELS), 4, wire_dtype="int8")
