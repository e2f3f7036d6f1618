"""SSL data pipeline (port of ``lightning_asr_tpu/ssl_codec/ssl_datamodule.py``):
batches of wav2vec2 features, and the pseudo-label pool of
``AsrDataModule``.

  * offline mode maps each wav to ``{ssl_folder}/{stem}.pkl`` holding
    (1, T, 512) features; on-the-fly mode runs a ``Wav2Vec2Extractor`` in
    the loader instead;
  * feature batches reuse ``Batch``: ``waves`` = (B, T, 512) features
    padded with zeros to a frame bucket (the duration buckets at 50 frames
    a second, the wav2vec2 stride of 20 ms), ``wave_lens`` = frame counts;
    the steps take them with ``from_features=True``;
  * given the same entries, seed and epoch, ``SSLBucketBatcher`` gives the
    JAX package's batches bit for bit: the same numpy shuffles and bucket
    plan;
  * data parallelism (``shard_rank`` / ``shard_count`` / ``pad_to``, as
    ``data/pipeline.py::BucketBatcher`` takes them): every rank follows the
    same global plan, takes the target padding from the global chunk and
    assembles only its rows (``parallel/mesh.py::local_rows``), reading
    only their pickles (or extracting only their features).  The global
    batch is padded to a multiple of ``pad_to`` with the rows the JAX
    trainer adds for its mesh (its ``training/trainer.py::_device_batch``):
    zero features, ``wave_lens`` 160, zero targets, ``target_lens`` 0.
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence

import numpy as np

from ..data.datamodule import AsrDataModule
from ..data.manifest import ManifestEntry
from ..data.pipeline import Batch, _round_up
from ..data.vocab import Vocabulary
from ..parallel.mesh import local_rows
from .extractor import DEFAULT_MODEL, Wav2Vec2Extractor, load_feature_pkl

WAV2VEC_FPS = 50  # 20 ms stride
SSL_BUCKET_SECONDS = (4.0, 8.0, 12.0, 16.7, 20.0, 30.0, 40.0)


class SSLBucketBatcher:
    """Static-shape batches of wav2vec2 features; ``shard_rank`` of
    ``shard_count`` ranks assembles its rows of every global batch (the
    module docstring), ``pad_to`` a multiple of ``shard_count``."""

    def __init__(
        self,
        entries: Sequence[ManifestEntry],
        vocab: Vocabulary,
        batch_size: int,
        ssl_folder: Optional[str] = None,
        extractor: Optional[Wav2Vec2Extractor] = None,
        train: bool = False,
        bucket_seconds: Sequence[float] = SSL_BUCKET_SECONDS,
        drop_last: Optional[bool] = None,
        seed: int = 0,
        feature_dim: int = 512,
        shard_rank: int = 0,
        shard_count: int = 1,
        pad_to: int = 1,
    ):
        if shard_count > 1 and pad_to % shard_count != 0:
            raise ValueError(f"pad_to={pad_to} must be a multiple of shard_count={shard_count}")
        if ssl_folder is None and extractor is None:
            raise ValueError("need ssl_folder (offline) or extractor (on-the-fly)")
        self.entries = list(entries)
        self.vocab = vocab
        self.batch_size = batch_size
        self.ssl_folder = ssl_folder
        self.extractor = extractor
        self.train = train
        self.bucket_frames = [int(s * WAV2VEC_FPS) for s in bucket_seconds]
        self.drop_last = train if drop_last is None else drop_last
        self.seed = seed
        self.feature_dim = feature_dim
        self.epoch = 0
        self.shard_rank, self.shard_count = shard_rank, shard_count
        self.pad_to = max(pad_to, 1)
        self._encoded = [np.asarray(vocab.encode(e.text), np.int32) if e.text
                         else np.zeros((0,), np.int32) for e in self.entries]

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _bucket_for(self, frames: int) -> int:
        for b in self.bucket_frames:
            if frames <= b:
                return b
        return _round_up(frames, WAV2VEC_FPS)

    def __len__(self) -> int:
        buckets: dict = {}
        for e in self.entries:
            b = self._bucket_for(int(e.duration * WAV2VEC_FPS))
            buckets[b] = buckets.get(b, 0) + 1
        return sum(n // self.batch_size if self.drop_last else -(-n // self.batch_size)
                   for n in buckets.values())

    def _features_for(self, entry: ManifestEntry) -> np.ndarray:
        if self.ssl_folder is not None:
            return load_feature_pkl(entry.audio_filepath, self.ssl_folder)
        feats, _ = self.extractor([entry.audio_filepath])
        return feats[0]

    def __iter__(self) -> Iterator[Batch]:
        rng = np.random.default_rng(self.seed + self.epoch * 1000003)
        order = np.arange(len(self.entries))
        if self.train:
            rng.shuffle(order)
        plans: dict = {}
        for idx in order:
            frames = int(self.entries[idx].duration * WAV2VEC_FPS)
            plans.setdefault(self._bucket_for(frames), []).append(int(idx))
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

    def _assemble(self, bucket: int, chunk: list) -> Batch:
        # L from the global chunk, so that every rank has the same shapes
        max_tgt = max((len(self._encoded[i]) for i in chunk), default=1)
        L = max(_round_up(max_tgt, 32), 32)
        global_size = valid = None
        B = len(chunk)
        if self.shard_count > 1:
            global_size = _round_up(len(chunk), self.pad_to)
            rows = local_rows(global_size, self.shard_rank, self.shard_count)
            valid = int((rows < len(chunk)).sum())       # ascending: the pad rows come last
            chunk = [chunk[g] for g in rows[:valid]]
            B = len(rows)
        feats = np.zeros((B, bucket, self.feature_dim), np.float32)
        feat_lens = np.full(B, 160, np.int32)            # pad rows: the JAX trainer's 160
        targets = np.zeros((B, L), np.int32)
        target_lens = np.zeros(B, np.int32)
        paths, texts = [], []
        for i, idx in enumerate(chunk):
            entry = self.entries[idx]
            f = self._features_for(entry)
            n = min(f.shape[0], bucket)
            feats[i, :n] = f[:n]
            feat_lens[i] = n
            t = self._encoded[idx]
            targets[i, : len(t)] = t
            target_lens[i] = len(t)
            paths.append(entry.audio_filepath)
            texts.append(entry.text)
        return Batch(feats, feat_lens, np.zeros(B, np.float32), targets, target_lens, paths, texts,
                     global_size=global_size, valid_size=valid)


class SSLDataModule(AsrDataModule):
    """``AsrDataModule`` over wav2vec2 features (offline pickles in
    ``ssl_folder``, or ``on_the_fly`` through a ``Wav2Vec2Extractor`` of
    ``ssl_model_name`` on ``extractor_device``), with its pseudo-label
    pool."""

    batcher_class = SSLBucketBatcher

    def __init__(self, *args, ssl_folder: Optional[str] = None, on_the_fly: bool = False,
                 ssl_model_name: str = DEFAULT_MODEL, extractor_device=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.ssl_folder = ssl_folder
        self.extractor = (Wav2Vec2Extractor(ssl_model_name, device=extractor_device)
                          if on_the_fly else None)

    def _batcher(self, entries, bs: int, train: bool):
        kwargs = {} if self.bucket_seconds is None else {"bucket_seconds": self.bucket_seconds}
        rank, world = self._shard_info()
        if world > 1:
            kwargs.update(shard_rank=rank, shard_count=world, pad_to=world)
        return self.batcher_class(entries, self.vocab, bs, ssl_folder=self.ssl_folder,
                                  extractor=self.extractor, train=train, seed=self.seed,
                                  **kwargs)
