"""Host-side batching: duration buckets, target padding and a background
prefetch thread (port of ``lightning_asr_tpu/data/pipeline.py``).

Given the same manifest entries, seed and epoch, ``BucketBatcher`` gives
the JAX package's batches exactly: the same bucket plan, crop draws
(``np.random.default_rng(seed + epoch · 1000003)``), shuffles, target
padding to a multiple of 32 and wire encoding.

  * utterances are grouped into duration buckets; each batch is padded to
    its bucket's sample count, so the device sees few shapes;
  * the training crop (the reference's ``sub_secquence``) is planned here
    as (offset, length) and applied while decoding; the sample before the
    crop travels as ``prev_samples`` for the preemphasis;
  * the wire to the device is int16 PCM (exact for 16-bit WAVs), 8-bit
    mu-law (G.711 companding, lossy, code 128 = silence) or float32;
  * ``cache='ram'`` decodes every file once, as int16, and slices crops
    from RAM on later epochs (``cache='mmap'``: from the packed file);
  * ``prefetch`` runs the assembly, and whatever the caller adds to it (the
    trainer's host-to-device copies), in a background thread;
  * data parallelism (``shard_rank`` / ``shard_count`` / ``pad_to``): every
    rank follows the same global plan (deterministic in entries, seed and
    epoch), takes the target padding L from the global chunk, and assembles
    only its rows of each global batch (``parallel/mesh.py::local_rows``;
    with ``micro_batches`` > 1 its share of each micro-batch).  The global
    batch is padded to a multiple of ``pad_to`` (and of ``shard_count`` ×
    ``micro_batches``) with rows of ``wave_lens`` 160 and ``target_lens`` 0;
    ``Batch.global_size`` and ``Batch.valid_size`` say which rows are data.

Audio is decoded by the native threaded WAV loader
(``native.load_wav_batch``, C++ outside the interpreter lock, so decoding
overlaps the device under ``prefetch``) as the JAX package decodes it: int16
for the int16 and mu-law wires, float32 for the float32 wire.  Where the
library is missing or refuses a file, the port's ``data/audio.py::
read_audio`` decodes the chunk (``BucketBatcher.audio_reads`` counts its
files).  ``wave_cache`` may be the RAM dict or ``wave_cache.MmapWaveCache``
(``cache='mmap'``).
"""

from __future__ import annotations

import math
import queue
import threading
from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Sequence

import numpy as np

from .. import native
from ..parallel.mesh import local_rows
from .audio import read_audio
from .manifest import ManifestEntry
from .vocab import Vocabulary

# Duration bucket edges (seconds): train is cut at 16.7 s and dev at 40 s
# (conf/conf.yaml); buckets past 17 s serve dev and test.
DEFAULT_BUCKET_SECONDS = (2.0, 4.0, 6.0, 8.0, 10.0, 12.0, 14.0, 16.7, 20.0, 30.0, 40.0)
WIRES = ("int16", "mulaw8", "float32")


@dataclass
class Batch:
    waves: np.ndarray          # (B, S_bucket) int16, uint8 mu-law or float32
                               # (or SSL features (B, T, F) float32)
    wave_lens: np.ndarray      # (B,) int32 true sample (or frame) counts
    prev_samples: np.ndarray   # (B,) float32 sample preceding each crop
    targets: np.ndarray        # (B, L_bucket) int32 padded label ids
    target_lens: np.ndarray    # (B,) int32
    paths: List[str] = field(default_factory=list)
    texts: List[str] = field(default_factory=list)
    extra: Optional[dict] = None  # more arrays for the device (the dual stream's raw waves)
    # data parallelism: the arrays hold this rank's rows of a global batch of
    # this many rows (None: the arrays are the batch) ...
    global_size: Optional[int] = None
    # ... of which this many, the first, are data and the rest pad rows
    valid_size: Optional[int] = None

    @property
    def size(self) -> int:
        return self.waves.shape[0] if self.valid_size is None else self.valid_size

    @property
    def audio_seconds(self) -> float:
        return float(self.wave_lens.sum()) / 16000.0


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _to_int16(samples: np.ndarray) -> np.ndarray:
    return np.round(samples * 32768.0).clip(-32768, 32767).astype(np.int16)


_MULAW_LUT: Optional[np.ndarray] = None


def _mulaw_lut() -> np.ndarray:
    global _MULAW_LUT
    if _MULAW_LUT is None:
        v = np.arange(-32768, 32768, dtype=np.float64) / 32768.0
        y = np.sign(v) * np.log1p(255.0 * np.abs(v)) / np.log(256.0)
        _MULAW_LUT = (np.round(y * 127.0).astype(np.int32) + 128).astype(np.uint8)
    return _MULAW_LUT


def mulaw_encode(waves_i16: np.ndarray) -> np.ndarray:
    """int16 PCM -> uint8 mu-law codes (128 = silence); the device expands
    them (``ops/frontend.py::expand_wire``)."""
    return _mulaw_lut()[waves_i16.astype(np.int32) + 32768]


_READS_LOCK = threading.Lock()


class BucketBatcher:
    """Iterable over static-shape batches from a manifest entry list."""

    audio_reads = 0                  # files decoded by read_audio, in every batcher

    def __init__(
        self,
        entries: Sequence[ManifestEntry],
        vocab: Vocabulary,
        batch_size: int,
        train: bool = False,
        sample_rate: int = 16000,
        bucket_seconds: Sequence[float] = DEFAULT_BUCKET_SECONDS,
        crop: bool = True,
        crop_weight: float = 0.98,
        drop_last: Optional[bool] = None,
        seed: int = 0,
        target_pad_multiple: int = 32,
        shard_rank: int = 0,
        shard_count: int = 1,
        pad_to: int = 1,
        wire_dtype: str = "int16",
        wave_cache: Optional[dict] = None,
        micro_batches: int = 1,
    ):
        """``shard_rank`` of ``shard_count`` ranks assembles its rows of
        every global batch (see the module docstring); ``pad_to`` (the
        world) must be a multiple of ``shard_count``."""
        if shard_count > 1 and pad_to % shard_count != 0:
            raise ValueError(f"pad_to={pad_to} must be a multiple of shard_count={shard_count}")
        self.shard_rank = shard_rank
        self.shard_count = shard_count
        self.pad_to = max(pad_to, 1)
        self.micro_batches = micro_batches
        if wire_dtype not in WIRES:
            raise ValueError(f"wire_dtype must be int16|mulaw8|float32, got {wire_dtype!r}")
        self.wire_dtype = wire_dtype
        self.entries = list(entries)
        self.vocab = vocab
        self.batch_size = batch_size
        self.train = train
        self.sample_rate = sample_rate
        self.bucket_samples = [int(s * sample_rate) for s in bucket_seconds]
        self.crop = crop and train
        self.crop_weight = crop_weight
        self.drop_last = train if drop_last is None else drop_last
        self.seed = seed
        self.target_pad_multiple = target_pad_multiple
        self.epoch = 0
        # decode-once RAM cache, path -> full int16 waveform; the datamodule
        # owns the dict, since a batcher is built anew every epoch
        self.wave_cache = wave_cache
        self._encoded = [np.asarray(vocab.encode(e.text), np.int32) for e in self.entries]

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _bucket_for(self, n_samples: int) -> int:
        for b in self.bucket_samples:
            if n_samples <= b:
                return b
        return _round_up(n_samples, self.sample_rate)  # overflow: 1 s granularity

    def __len__(self) -> int:
        """Batch count (exact when not cropping)."""
        buckets: dict = {}
        for e in self.entries:
            b = self._bucket_for(int(e.duration * self.sample_rate))
            buckets[b] = buckets.get(b, 0) + 1
        return sum(n // self.batch_size if self.drop_last else -(-n // self.batch_size)
                   for n in buckets.values())

    def __iter__(self) -> Iterator[Batch]:
        rng = np.random.default_rng(self.seed + self.epoch * 1000003)
        order = np.arange(len(self.entries))
        if self.train:
            rng.shuffle(order)
        # plan crops and buckets without touching the audio files
        plans: dict = {}                     # bucket -> [(idx, offset, length)]
        for idx in order:
            n = int(round(self.entries[idx].duration * self.sample_rate))
            offset, length = 0, n
            if self.crop:
                target_length = int(n * rng.uniform(self.crop_weight, 1.0))
                offset = int(rng.uniform(0, n - target_length))
                length = max(target_length - offset, 1)
            plans.setdefault(self._bucket_for(length), []).append((int(idx), offset, length))
        pending = []
        for bucket, items in plans.items():
            for i in range(0, len(items), self.batch_size):
                chunk = items[i: i + self.batch_size]
                if len(chunk) < self.batch_size and self.drop_last:
                    continue
                pending.append((bucket, chunk))
        if self.train:
            rng.shuffle(pending)
        for bucket, chunk in pending:
            yield self._assemble(bucket, chunk)

    def _assemble(self, bucket: int, chunk) -> Batch:
        # L from the global chunk, so that every rank has the same shapes
        max_tgt = max((len(self._encoded[idx]) for idx, _, _ in chunk), default=1)
        L = max(_round_up(max_tgt, self.target_pad_multiple), self.target_pad_multiple)
        global_size = valid = None
        B = len(chunk)
        if self.shard_count > 1:
            global_size = _round_up(len(chunk), math.lcm(self.pad_to,
                                                         self.shard_count * self.micro_batches))
            rows = local_rows(global_size, self.shard_rank, self.shard_count, self.micro_batches)
            valid = int((rows < len(chunk)).sum())       # ascending: the pad rows come last
            chunk = [chunk[g] for g in rows[:valid]]
            B = len(rows)
        targets = np.zeros((B, L), np.int32)
        target_lens = np.zeros(B, np.int32)
        paths, texts = [], []
        for i, (idx, _, _) in enumerate(chunk):
            t = self._encoded[idx]
            targets[i, : len(t)] = t
            target_lens[i] = len(t)
            paths.append(self.entries[idx].audio_filepath)
            texts.append(self.entries[idx].text)
        waves, wave_lens, prev_samples = self._decode_chunk(bucket, chunk, paths)
        if self.wire_dtype in ("int16", "mulaw8") and waves.dtype != np.int16:
            waves = _to_int16(waves)
        if len(chunk) < B:                   # pad rows: 160 samples keep normalization finite
            pad = B - len(chunk)
            waves = np.concatenate([waves, np.zeros((pad, bucket), waves.dtype)])
            wave_lens = np.concatenate([wave_lens, np.full(pad, 160, np.int32)])
            prev_samples = np.concatenate([prev_samples, np.zeros(pad, np.float32)])
        if self.wire_dtype == "mulaw8":
            waves = mulaw_encode(waves)      # last, so pad and crop zeros become 128
        return Batch(waves, wave_lens, prev_samples, targets, target_lens, paths, texts,
                     global_size=global_size, valid_size=valid)

    def _decode_chunk(self, bucket: int, chunk, paths):
        """Decode and crop the chunk's audio: by the native threaded loader
        (int16 for the int16 and mu-law wires, float32 for the float32
        wire), or where it is missing or refuses a file, by ``read_audio``
        (float32).  From the RAM or mmap cache when there is one."""
        if self.wave_cache is not None:
            return self._decode_chunk_cached(bucket, chunk, paths)
        offsets = np.asarray([off for _, off, _ in chunk], np.int32)
        req_lens = np.asarray([ln for _, _, ln in chunk], np.int32)
        try:
            waves, lens, prevs, srs = native.load_wav_batch(
                paths, offsets, bucket, dtype="float32" if self.wire_dtype == "float32" else "int16")
            if (lens < 0).any():
                raise RuntimeError(f"native decode failed for {paths[int(np.argmax(lens < 0))]}")
            self._check_rates(paths, srs)
            wave_lens = np.minimum(lens, req_lens).astype(np.int32)
            # zero past the crop with a zero of the waves' own type: a float
            # zero would promote int16 waves to float64, which _assemble
            # then rescales as if they were in [-1, 1)
            t_idx = np.arange(bucket)[None, :]
            waves = np.where(t_idx < wave_lens[:, None], waves, np.zeros((), waves.dtype))
            return waves, wave_lens, prevs
        except (ImportError, OSError, RuntimeError):
            pass
        B = len(chunk)
        waves = np.zeros((B, bucket), np.float32)
        wave_lens = np.zeros(B, np.int32)
        prev_samples = np.zeros(B, np.float32)
        for i, (_, offset, length) in enumerate(chunk):
            wave = self._read(paths[i])
            n = wave.shape[0]
            off = min(offset, max(n - 1, 0))
            ln = min(length, n - off, bucket)
            waves[i, :ln] = wave[off: off + ln]
            wave_lens[i] = ln
            prev_samples[i] = wave[off - 1] if off > 0 else 0.0
        return waves, wave_lens, prev_samples

    def _check_rates(self, paths, srs: np.ndarray) -> None:
        bad = srs != self.sample_rate
        if bad.any():
            i = int(np.argmax(bad))
            raise ValueError(f"{paths[i]}: sample rate {int(srs[i])} != {self.sample_rate} "
                             "(run the prep scripts to resample)")

    def _read(self, path: str) -> np.ndarray:
        samples, sr = read_audio(path, mono=True)
        if sr != self.sample_rate:
            raise ValueError(f"{path}: sample rate {sr} != {self.sample_rate} "
                             "(run the prep scripts to resample)")
        with _READS_LOCK:
            BucketBatcher.audio_reads += 1
        return samples[0]

    def _decode_chunk_cached(self, bucket: int, chunk, paths):
        """The cache path: each file is decoded once, whole, as int16 (by the
        native loader into a buffer a little longer than its manifest
        duration; a buffer that comes back full may hide a longer file, so
        that file is decoded again at its true length), and every epoch
        slices its crops from the cache."""
        missing = [i for i, p in enumerate(paths) if p not in self.wave_cache]
        if missing:
            m_paths = [paths[i] for i in missing]
            full = [int(round(self.entries[chunk[i][0]].duration * self.sample_rate))
                    for i in missing]
            max_n = _round_up(max(full) + 16, 16)
            try:
                waves, lens, _, srs = native.load_wav_batch(
                    m_paths, np.zeros(len(m_paths), np.int32), max_n, dtype="int16")
                if (lens < 0).any():
                    raise RuntimeError(f"native decode failed for "
                                       f"{m_paths[int(np.argmax(lens < 0))]}")
                self._check_rates(m_paths, srs)
                for j, p in enumerate(m_paths):
                    self.wave_cache[p] = (_to_int16(self._read(p)) if lens[j] >= max_n
                                          else waves[j, : lens[j]].copy())
            except (ImportError, OSError, RuntimeError):
                for p in m_paths:
                    self.wave_cache[p] = _to_int16(self._read(p))
        B = len(chunk)
        waves = np.zeros((B, bucket), np.int16)
        wave_lens = np.zeros(B, np.int32)
        prev_samples = np.zeros(B, np.float32)
        for i, (_, offset, length) in enumerate(chunk):
            w = self.wave_cache[paths[i]]
            n = w.shape[0]
            off = min(offset, max(n - 1, 0))
            ln = min(length, n - off, bucket)
            waves[i, :ln] = w[off: off + ln]
            wave_lens[i] = ln
            prev_samples[i] = float(w[off - 1]) / 32768.0 if off > 0 else 0.0
        if self.wire_dtype == "float32":
            waves = waves.astype(np.float32) / 32768.0
        return waves, wave_lens, prev_samples


def prefetch(iterator: Iterator, depth: int = 2) -> Iterator:
    """Run ``iterator`` in a background thread, ``depth`` items ahead; an
    exception in it is raised in the consumer."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    end = object()
    err: list = []

    def worker():
        try:
            for item in iterator:
                q.put(item)
        except BaseException as e:  # handed to the consumer, raised there
            err.append(e)
        finally:
            q.put(end)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is end:
            if err:
                raise err[0]
            return
        yield item


def mulaw_decode_host(codes: np.ndarray) -> np.ndarray:
    """Host reference of the device's mu-law expansion: float32, the
    formula ``ops/frontend.py::expand_wire`` applies to uint8 waves."""
    y = (codes.astype(np.float32) - np.float32(128.0)) * np.float32(1.0 / 127.0)
    return np.sign(y) * (np.exp(np.abs(y) * np.float32(np.log(256.0)))
                         - np.float32(1.0)) * np.float32(1.0 / 255.0)
