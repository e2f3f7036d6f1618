"""The port's persistent wave cache (``cache='mmap'``,
``lightning_asr_torch/data/wave_cache.py``) and its native threaded WAV
loader (``lightning_asr_torch/native.py::load_wav_batch``) against the JAX
package's, on WAV files written here.

The cache tests mirror the JAX package's own (``tests/test_pipeline.py``):
restart without decoding, crash safety, non-int16 refused, the datamodule's
wiring, an orphaned tail, staleness, the writer lock, a file longer than its
manifest says.  Beside them: a cache directory written by either package
read by the other, the two loaders on the same files, the batches of the
two packages under ``cache=None``, ``'ram'`` and ``'mmap'`` bit for bit,
and the per-rank cache directories of a data-parallel group (2 gloo ranks).
"""

import json
import os
import subprocess
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest

from lightning_asr_tpu import native as jax_native
from lightning_asr_tpu.data.datamodule import AsrDataModule as JaxDataModule
from lightning_asr_tpu.data.manifest import read_manifests as jax_read_manifests
from lightning_asr_tpu.data.pipeline import BucketBatcher as JaxBatcher
from lightning_asr_tpu.data.vocab import Vocabulary as JaxVocabulary
from lightning_asr_tpu.data.wave_cache import MmapWaveCache as JaxMmapWaveCache
from lightning_asr_torch import native
from lightning_asr_torch.data import pipeline
from lightning_asr_torch.data.audio import read_audio, write_wav
from lightning_asr_torch.data.datamodule import AsrDataModule
from lightning_asr_torch.data.manifest import read_manifests
from lightning_asr_torch.data.pipeline import BucketBatcher
from lightning_asr_torch.data.vocab import Vocabulary
from lightning_asr_torch.data.wave_cache import MmapWaveCache
from test_torch_data_parallel import run_ranks
from test_torch_pipeline import LABELS, SR, _assert_same_batches, tone_corpus

ROOT = Path(__file__).resolve().parents[1]
BUCKETS = (1.2, 1.6, 2.0)
KW = dict(batch_size=4, train=False, bucket_seconds=BUCKETS, crop=False)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return tone_corpus(tmp_path_factory.mktemp("wc_corpus"), 12, 4)


def _entries(corpus):
    return read_manifests(corpus, 16.7)


def _forbid_decoding():
    """Both decoders of the port booby-trapped."""
    return (mock.patch.object(native, "load_wav_batch",
                              side_effect=AssertionError("decoded on restart")),
            mock.patch.object(pipeline, "read_audio",
                              side_effect=AssertionError("decoded on restart")))


def test_mmap_cache_matches_ram_and_survives_restart(corpus, tmp_path):
    """The mmap cache serves the RAM dict's batches byte for byte, and a
    fresh instance (a restart) serves them with no decode at all."""
    ram: dict = {}
    mm = MmapWaveCache(tmp_path / "wc")
    ram_batches = list(BucketBatcher(_entries(corpus), Vocabulary(LABELS), wave_cache=ram, **KW))
    mm_batches = list(BucketBatcher(_entries(corpus), Vocabulary(LABELS), wave_cache=mm, **KW))
    _assert_same_batches(mm_batches, ram_batches)
    assert len(mm) == 12
    mm.close()
    mm2 = MmapWaveCache(tmp_path / "wc")
    assert len(mm2) == 12
    a, b = _forbid_decoding()
    with a, b:
        again = list(BucketBatcher(_entries(corpus), Vocabulary(LABELS), wave_cache=mm2, **KW))
    _assert_same_batches(again, ram_batches)


def test_mmap_cache_crash_safety(tmp_path):
    """An index line whose samples never reached the disk and a torn last
    line are dropped on reopen; the lost wave is appended again cleanly."""
    d = tmp_path / "wc"
    mm = MmapWaveCache(d)
    rng = np.random.default_rng(0)
    w1 = (rng.standard_normal(100) * 1000).astype(np.int16)
    w2 = (rng.standard_normal(150) * 1000).astype(np.int16)
    mm["a"] = w1
    mm["b"] = w2
    mm.close()
    with open(d / "waves.bin", "r+b") as f:
        f.truncate(100 * 2)                          # w2's samples lost
    with open(d / "index.jsonl", "a") as f:
        f.write('{"p": "c", "o"')                    # a torn write
    mm2 = MmapWaveCache(d)
    assert "a" in mm2 and "b" not in mm2 and "c" not in mm2
    np.testing.assert_array_equal(mm2["a"], w1)
    mm2["b"] = w2
    np.testing.assert_array_equal(mm2["b"], w2)
    mm2.close()
    mm3 = MmapWaveCache(d)
    np.testing.assert_array_equal(mm3["b"], w2)
    assert json.loads((d / "index.jsonl").read_text().splitlines()[-1])["p"] == "b"


def test_mmap_cache_rejects_non_int16(tmp_path):
    mm = MmapWaveCache(tmp_path / "wc")
    with pytest.raises(TypeError):
        mm["x"] = np.zeros(4, np.float32)
    with pytest.raises(KeyError):
        mm["x"]


def test_datamodule_mmap_cache_wiring(corpus, tmp_path):
    """``AsrDataModule(cache='mmap')`` opens its cache at ``cache_dir`` (or
    beside the train manifest) and gives the ``cache=None`` batches."""
    common = dict(train_manifest=str(corpus), dev_manifest=str(corpus), labels=LABELS,
                  train_bs=4, dev_bs=4, bucket_seconds=BUCKETS, crop=False)
    plain = AsrDataModule(**common)
    mm = AsrDataModule(**common, cache="mmap", cache_dir=tmp_path / "wc")
    assert mm.cache_dir == tmp_path / "wc"
    _assert_same_batches(mm.val_dataloader(), plain.val_dataloader())
    assert (tmp_path / "wc" / "waves.bin").exists()
    assert AsrDataModule(**common, cache="mmap").cache_dir == Path(corpus).parent / "_lasr_wave_cache"
    with pytest.raises(ValueError):
        AsrDataModule(train_manifest=str(corpus), labels=LABELS, cache="disk")


def test_mmap_cache_orphaned_tail(tmp_path):
    """Samples flushed whose index line never landed are cut on reopen, so
    later appends are read where the index says."""
    d = tmp_path / "wc"
    mm = MmapWaveCache(d)
    w1 = np.arange(100, dtype=np.int16)
    mm["a"] = w1
    mm.close()
    with open(d / "waves.bin", "ab") as f:
        f.write(np.full(50, 7, np.int16).tobytes())
    mm2 = MmapWaveCache(d)
    w2 = np.arange(1000, 1150, dtype=np.int16)
    mm2["b"] = w2
    np.testing.assert_array_equal(mm2["a"], w1)
    np.testing.assert_array_equal(mm2["b"], w2)
    mm2.close()
    np.testing.assert_array_equal(MmapWaveCache(d)["b"], w2)


def test_mmap_cache_staleness_and_writer_lock(tmp_path):
    """A replaced source is a miss for a fresh instance and is appended
    again; entries without source metadata are trusted; a second writer
    process fails fast while the first holds the lock, and succeeds after
    it closes."""
    d = tmp_path / "wc"
    src = tmp_path / "a.wav"
    src.write_bytes(b"\x01\x02" * 100)
    w1 = np.arange(8, dtype=np.int16)
    mm = MmapWaveCache(d)
    mm[str(src)] = w1
    np.testing.assert_array_equal(mm[str(src)], w1)
    src.write_bytes(b"\x03\x04" * 120)
    os.utime(src, ns=(1, 1))
    mm.close()
    mm2 = MmapWaveCache(d)
    assert str(src) not in mm2
    w2 = np.arange(10, dtype=np.int16) * 3
    mm2[str(src)] = w2
    np.testing.assert_array_equal(mm2[str(src)], w2)
    mm2.close()
    mm3 = MmapWaveCache(d)
    np.testing.assert_array_equal(mm3[str(src)], w2)
    lines = (d / "index.jsonl").read_text().splitlines()
    rec = json.loads(lines[-1])
    rec.pop("s"), rec.pop("m")
    rec["p"] = "legacy-entry"
    (d / "index.jsonl").write_text("\n".join(lines + [json.dumps(rec)]) + "\n")
    mm3.close()
    mm4 = MmapWaveCache(d)
    assert "legacy-entry" in mm4

    code = ("import numpy as np, sys; sys.path.insert(0, %r)\n"
            "from lightning_asr_torch.data.wave_cache import MmapWaveCache\n"
            "mm = MmapWaveCache(%r)\n"
            "try:\n"
            "    mm['other'] = np.ones(4, np.int16)\n"
            "    print('NO-LOCK')\n"
            "except RuntimeError:\n"
            "    print('LOCKED')\n") % (str(ROOT), str(d))
    mm4["holder"] = np.ones(4, np.int16)             # takes the lock
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert "LOCKED" in out.stdout, out.stdout + out.stderr
    mm4.close()
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert "NO-LOCK" in out.stdout, out.stdout + out.stderr


def test_cached_decode_full_file_despite_understated_duration(tmp_path):
    """A manifest row that understates its file's duration must not freeze a
    cut wave into the cache: the loader's buffer comes back full, and that
    file is decoded again at its true length."""
    rng = np.random.default_rng(0)
    wave = (rng.standard_normal(int(SR * 1.9)) * 0.1).astype(np.float32)
    path = tmp_path / "long.wav"
    write_wav(path, wave, SR)
    manifest = tmp_path / "m.json"
    manifest.write_text("".join(json.dumps({"audio_filepath": str(path), "duration": d,
                                            "text": "ab"}) + "\n" for d in (0.5, 1.9)))
    kw = dict(batch_size=1, train=False, bucket_seconds=(1.0, 2.0), crop=False)
    plain = list(BucketBatcher(read_manifests(manifest), Vocabulary(LABELS), **kw))
    reads = BucketBatcher.audio_reads
    cache: dict = {}
    cached = list(BucketBatcher(read_manifests(manifest), Vocabulary(LABELS), wave_cache=cache, **kw))
    assert BucketBatcher.audio_reads == reads + 1                  # the full buffer's re-decode
    assert len(plain) == len(cached) == 2
    _assert_same_batches(cached, plain)
    assert cache[str(path)].shape == (wave.shape[0],)



@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cache_directory_opens_in_the_other_package(corpus, tmp_path, writer):
    """A cache directory built by one package's batcher is read by the
    other's with no decode: the same waves, equal arrays."""
    d = tmp_path / "wc"
    build, read = ((JaxMmapWaveCache, MmapWaveCache) if writer == "jax"
                   else (MmapWaveCache, JaxMmapWaveCache))
    cache = build(d)
    if writer == "jax":
        list(JaxBatcher(jax_read_manifests(corpus, 16.7), JaxVocabulary(LABELS), wave_cache=cache, **KW))
    else:
        list(BucketBatcher(_entries(corpus), Vocabulary(LABELS), wave_cache=cache, **KW))
    cache.close()
    other = read(d)
    assert len(other) == len(cache) == 12
    for e in _entries(corpus):
        assert e.audio_filepath in other
        np.testing.assert_array_equal(np.asarray(other[e.audio_filepath]),
                                      np.asarray(cache[e.audio_filepath]))
    if writer == "jax":                               # the port batches from it without decoding
        a, b = _forbid_decoding()
        with a, b:
            got = list(BucketBatcher(_entries(corpus), Vocabulary(LABELS), wave_cache=other, **KW))
        _assert_same_batches(got, BucketBatcher(_entries(corpus), Vocabulary(LABELS), **KW))


@pytest.mark.parametrize("dtype", ["int16", "float32"])
def test_load_wav_batch_equals_jax(corpus, dtype):
    """The port's loader and the JAX package's on the same files, offsets
    and buffer: waves, lengths, previous samples and rates equal; a missing
    file gives -1 on both; the int16 rows are ``read_audio``'s samples."""
    paths = [e.audio_filepath for e in _entries(corpus)] + ["/nonexistent/x.wav"]
    offsets = np.arange(len(paths), dtype=np.int32) * 37
    rows = native.load_wav_batch.rows
    got = native.load_wav_batch(paths, offsets, 30000, dtype=dtype)
    want = jax_native.load_wav_batch(paths, offsets, 30000, dtype=dtype)
    assert native.load_wav_batch.rows == rows + len(paths)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    lens = got[1]
    assert lens[-1] == -1 and (lens[:-1] > 0).all()
    if dtype == "int16":
        for i, p in enumerate(paths[:-1]):
            samples = read_audio(p, mono=True)[0][0]
            ref = np.round(samples * 32768.0).clip(-32768, 32767).astype(np.int16)
            np.testing.assert_array_equal(got[0][i, : lens[i]], ref[offsets[i]: offsets[i] + lens[i]])
    with pytest.raises(ValueError, match="dtype"):
        native.load_wav_batch(paths, offsets, 100, dtype="int8")


@pytest.mark.parametrize("cache", [None, "ram", "mmap"])
@pytest.mark.parametrize("train", [True, False])
def test_batches_equal_jax_under_each_cache(corpus, tmp_path, cache, train):
    """The two datamodules over two epochs (crops on in training), under no
    cache, the RAM cache and the mmap cache: every batch bit for bit, and
    the port's decoded by its native loader, not by ``read_audio``."""
    common = dict(train_manifest=str(corpus), dev_manifest=str(corpus), labels=LABELS,
                  train_bs=4, dev_bs=4, bucket_seconds=BUCKETS, seed=7, cache=cache)
    ours = AsrDataModule(**common, cache_dir=tmp_path / "port")
    theirs = JaxDataModule(**common, cache_dir=tmp_path / "jax")
    reads = BucketBatcher.audio_reads
    for epoch in (0, 1):
        if train:
            _assert_same_batches(ours.train_dataloader(epoch), theirs.train_dataloader(epoch))
        else:
            _assert_same_batches(ours.val_dataloader(), theirs.val_dataloader())
    assert BucketBatcher.audio_reads == reads


def test_loader_refusal_falls_back_to_read_audio(corpus, monkeypatch):
    """A library that fails to load, or a file the loader refuses, sends the
    chunk to ``read_audio`` (the JAX package's breadth: ImportError, OSError,
    RuntimeError), with the same batches."""
    want = list(BucketBatcher(_entries(corpus), Vocabulary(LABELS), **KW))
    for err in (OSError("no library"), RuntimeError("native decode failed")):
        monkeypatch.setattr(native, "load_wav_batch",
                            lambda *a, _e=err, **k: (_ for _ in ()).throw(_e))
        reads = BucketBatcher.audio_reads
        _assert_same_batches(BucketBatcher(_entries(corpus), Vocabulary(LABELS), **KW), want)
        cache: dict = {}
        _assert_same_batches(BucketBatcher(_entries(corpus), Vocabulary(LABELS), wave_cache=cache,
                                           **KW), want)
        assert len(cache) == 12 and BucketBatcher.audio_reads == reads + 24
    monkeypatch.setattr(native, "load_wav_batch",
                        lambda *a, **k: (_ for _ in ()).throw(ValueError("other")))
    with pytest.raises(ValueError, match="other"):
        list(BucketBatcher(_entries(corpus), Vocabulary(LABELS), **KW))


def test_per_rank_cache_directories(corpus, tmp_path):
    """Under 2 gloo ranks ``cache='mmap'`` opens ``<cache_dir>/rank<r>``:
    each rank writes only its own directory (no writer lock is shared),
    holds the files of its rows, and batches as one process does."""
    cache_dir = tmp_path / "wc"
    outs = run_ranks("mmap", {"datamodule": dict(
        train_manifest=str(corpus), dev_manifest=str(corpus), labels=LABELS, train_bs=4,
        dev_bs=4, bucket_seconds=BUCKETS, seed=7, cache="mmap", cache_dir=str(cache_dir))},
        tmp_path)
    one = AsrDataModule(train_manifest=str(corpus), dev_manifest=str(corpus), labels=LABELS,
                        train_bs=4, dev_bs=4, bucket_seconds=BUCKETS, seed=7)
    assert not (cache_dir / "waves.bin").exists()
    seen = set()
    for r, out in enumerate(outs):
        assert out["cache_dir"] == str(cache_dir / f"rank{r}")
        paths = {json.loads(line)["p"] for line in
                 (cache_dir / f"rank{r}" / "index.jsonl").read_text().splitlines()}
        assert paths == set(out["paths"]) and len(paths) == out["entries"]
        seen |= paths
    assert seen == {e.audio_filepath for e in _entries(corpus)}
    for i, batch in enumerate(one.val_dataloader()):
        rows = [out["val"][i] for out in outs]
        for r, (waves, lens) in enumerate(rows):
            mine = [j for j, p in enumerate(batch.paths) if p in set(outs[r]["val_paths"][i])]
            np.testing.assert_array_equal(waves[: len(mine)], batch.waves[mine])
            np.testing.assert_array_equal(lens[: len(mine)], batch.wave_lens[mine])
