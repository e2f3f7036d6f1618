"""AsrDataModule: train/val/test loaders from JSONL manifests and labels
(port of ``lightning_asr_tpu/data/datamodule.py``), with the duration
filters (train 16.7 s, dev 40 s) and train-time shuffle and crop.

``cache='ram'`` keeps every decoded waveform (int16) for the life of the
module, so later epochs slice crops from RAM.  ``cache='mmap'`` keeps them
in the persistent packed cache (``wave_cache.MmapWaveCache``) at
``cache_dir``, by default ``<train manifest dir>/_lasr_wave_cache``: a
fresh process (a restart, a second job on the corpus) decodes nothing, and
the corpus may outgrow RAM.  The port runs one process a card, where the
JAX package runs one a host, and the cache admits one writer: in a
data-parallel group of more than one rank each rank opens
``<cache_dir>/rank<r>``; a world of 1 opens ``cache_dir`` itself, so a
cache the JAX package built opens unchanged.  The SSL path's pseudo-label
pool: ``pseudo_manifest`` lists unlabeled utterances (``unlabeled_entries``,
cut at ``pseudo_max_duration``), ``pseudo_train_dataloader`` iterates them
in order, and ``inject_pseudo_datasets`` sets the pseudo-labeled entries
that train batches draw from beside the train set.  In a data-parallel
process group every loader gives this rank's rows of the global batches
(``_shard_info``; train batches laid out for ``micro_batches``, which the
trainer sets from ``accumulate_grad_batches``); with model groups (tensor
parallelism) the rows split over the data group, and the ranks of a model
group assemble the same rows (each rank still writes its own ``mmap``
cache directory).
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Sequence, Tuple, Union

from ..parallel import distributed
from .audio import duration_seconds
from .manifest import ManifestEntry, read_manifests
from .pipeline import BucketBatcher
from .vocab import Vocabulary
from .wave_cache import MmapWaveCache


def _as_list(manifest) -> list:
    if manifest is None:
        return []
    if isinstance(manifest, (str, Path)):
        return [manifest]
    return list(manifest)


class AsrDataModule:
    def __init__(
        self,
        train_manifest=None,
        dev_manifest=None,
        test_manifest=None,
        labels: Union[str, Sequence[str]] = (),
        train_bs: int = 16,
        dev_bs: int = 16,
        train_max_duration: float = 16.7,
        dev_max_duration: float = 40.0,
        seed: int = 0,
        crop: bool = True,
        bucket_seconds: Optional[Sequence[float]] = None,
        prefetch_depth: int = 2,
        pseudo_manifest=None,
        pseudo_max_duration: float = 16.7,
        cache: Optional[str] = None,
        cache_dir=None,
        wire: str = "int16",
    ):
        if cache not in (None, "ram", "mmap"):
            raise ValueError(f"cache must be None, 'ram' or 'mmap', got {cache!r}")
        self.vocab = Vocabulary.from_config(labels)
        self.train_manifest = _as_list(train_manifest)
        self.dev_manifest = _as_list(dev_manifest)
        self.test_manifest = _as_list(test_manifest)
        self.train_bs, self.dev_bs = train_bs, dev_bs
        self.train_max_duration = train_max_duration
        self.dev_max_duration = dev_max_duration
        self.seed = seed
        self.crop = crop
        self.bucket_seconds = bucket_seconds
        self.prefetch_depth = prefetch_depth
        self.wire = wire
        self.train_entries: List[ManifestEntry] = []
        self.dev_entries: List[ManifestEntry] = []
        self.test_entries: List[ManifestEntry] = []
        self.pseudo_manifest = _as_list(pseudo_manifest)
        self.pseudo_max_duration = pseudo_max_duration
        self.unlabeled_entries: List[ManifestEntry] = []
        self.pseudo_entries: List[ManifestEntry] = []
        if cache == "mmap":
            if cache_dir is None:
                base = Path(self.train_manifest[0]).parent if self.train_manifest else Path(".")
                cache_dir = base / "_lasr_wave_cache"
            rank, world = distributed.rank(), distributed.world()
            self.cache_dir = Path(cache_dir) / f"rank{rank}" if world > 1 else Path(cache_dir)
            self._wave_cache = MmapWaveCache(self.cache_dir)
        else:
            self.cache_dir = None
            self._wave_cache = {} if cache == "ram" else None
        self.micro_batches = 1
        self._setup_done = False

    def setup(self) -> None:
        if self._setup_done:
            return
        if self.train_manifest:
            self.train_entries = read_manifests(self.train_manifest, self.train_max_duration)
        if self.dev_manifest:
            self.dev_entries = read_manifests(self.dev_manifest, self.dev_max_duration)
        if self.test_manifest:
            self.test_entries = read_manifests(self.test_manifest, self.dev_max_duration)
        if self.pseudo_manifest:
            self.unlabeled_entries = read_manifests(self.pseudo_manifest, self.pseudo_max_duration)
        self._setup_done = True

    @staticmethod
    def _shard_info() -> Tuple[int, int]:
        """(data index, data size) of the process group, (0, 1) without
        one: each rank assembles its rows of every global batch (the
        reference's DDP sampler, PL's ``DistributedSampler``)."""
        return distributed.data_index(), distributed.data_size()

    def _batcher(self, entries, bs: int, train: bool) -> BucketBatcher:
        kwargs = {} if self.bucket_seconds is None else {"bucket_seconds": self.bucket_seconds}
        rank, world = self._shard_info()
        if world > 1:
            kwargs.update(shard_rank=rank, shard_count=world, pad_to=world,
                          micro_batches=self.micro_batches if train else 1)
        return BucketBatcher(entries, self.vocab, bs, train=train, crop=self.crop and train,
                             seed=self.seed, wave_cache=self._wave_cache, wire_dtype=self.wire,
                             **kwargs)

    def train_dataloader(self, epoch: int = 0) -> BucketBatcher:
        self.setup()
        batcher = self._batcher(self.train_entries + self.pseudo_entries, self.train_bs,
                                train=True)
        batcher.set_epoch(epoch)
        return batcher

    def val_dataloader(self) -> BucketBatcher:
        self.setup()
        return self._batcher(self.dev_entries, self.dev_bs, train=False)

    def test_dataloader(self) -> BucketBatcher:
        self.setup()
        return self._batcher(self.test_entries, self.dev_bs, train=False)

    def steps_per_epoch(self) -> int:
        """Batches of a train epoch: the reference sizes its LR cycle by it."""
        self.setup()
        return len(self._batcher(self.train_entries + self.pseudo_entries, self.train_bs,
                                 train=True))

    def pseudo_train_dataloader(self):
        """The unlabeled pool in order, for pseudo-label generation."""
        self.setup()
        return self._batcher(self.unlabeled_entries, self.dev_bs, train=False)

    def inject_pseudo_datasets(self, pairs: Sequence[tuple]) -> None:
        """(audio_path, text[, duration]) pairs become the pseudo-labeled
        entries, replacing those injected before; a missing duration is read
        from the WAV file."""
        entries = []
        for pair in pairs:
            path, text = pair[0], pair[1]
            duration = pair[2] if len(pair) > 2 else duration_seconds(path)
            entries.append(ManifestEntry(str(path), float(duration), text))
        self.pseudo_entries = entries
