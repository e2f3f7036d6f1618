"""The persistent decode-once waveform cache, ``cache='mmap'`` (port of
``lightning_asr_tpu/data/wave_cache.py``, the same files: a cache directory
written by either package opens in the other).

The RAM cache dies with its process and must hold the whole corpus in the
heap (960 h is about 110 GB of int16).  This cache keeps the decoded waves
on disk instead:

  * ``<dir>/waves.bin`` holds the samples as raw little-endian int16 (exact
    for 16-bit PCM, the wire the device frontend rescales);
  * each append adds one JSON line ``{"p": path, "o": sample offset, "n":
    samples, "s": source size, "m": source mtime_ns}`` to
    ``<dir>/index.jsonl``, written after the samples are flushed; on reopen,
    a torn line and index lines past the end of the bin are dropped (their
    utterances are decoded again and appended), and samples past the last
    indexed one (a crash between the two writes) are truncated away;
  * readers ``np.memmap`` the bin, so a fresh process decodes nothing and
    resident memory follows what is read.

It is a mapping path -> int16 wave (``in``, ``[]``, ``[]=``, ``len``), the
protocol the batcher's RAM dict follows.  A source whose size or mtime no
longer matches its entry is a miss, decoded again and appended (the old
samples stay as dead space); entries without source metadata are trusted.
The first append takes an exclusive ``flock`` on ``<dir>/writer.lock``, so
a second writer fails fast instead of interleaving appends; readers take no
lock.  In a data-parallel group each rank writes its own directory
(``data/datamodule.py``).
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict, Optional, Set, Tuple, Union

import numpy as np


class MmapWaveCache:
    """Mapping path -> int16 waveform, backed by a packed memory-mapped
    file in ``directory``."""

    def __init__(self, directory: Union[str, Path]):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.bin_path = self.dir / "waves.bin"
        self.index_path = self.dir / "index.jsonl"
        self._index: Dict[str, Tuple[int, int]] = {}
        self._src_meta: Dict[str, Tuple[int, int]] = {}   # path -> (size, mtime_ns)
        self._validated: Set[str] = set()                 # staleness checked in this process
        self._mm: Optional[np.memmap] = None
        self._mm_samples = 0                              # samples the current memmap sees
        self._write_f = None
        self._lock_f = None
        self._load_index()

    def _load_index(self) -> None:
        bin_samples = self.bin_path.stat().st_size // 2 if self.bin_path.exists() else 0
        self._end = 0                                     # the next free sample offset
        if not self.index_path.exists():
            if bin_samples:                               # samples no index reaches
                self.bin_path.unlink()
            return
        with open(self.index_path) as f:
            lines = [line.strip() for line in f]
        kept = []
        for line in lines:
            if not line:
                continue
            try:
                rec = json.loads(line)
                off, n = int(rec["o"]), int(rec["n"])
            except (json.JSONDecodeError, KeyError, ValueError):
                break                                     # a line torn by a crash
            if off + n > bin_samples:
                break                                     # samples that never reached the disk
            self._index[rec["p"]] = (off, n)
            if "s" in rec and "m" in rec:
                self._src_meta[rec["p"]] = (int(rec["s"]), int(rec["m"]))
            self._end = max(self._end, off + n)
            kept.append(line)
        if len(kept) != len(lines):                       # drop the tail, so appends stay consistent
            tmp = self.index_path.with_suffix(".jsonl.tmp")
            tmp.write_text("".join(line + "\n" for line in kept))
            os.replace(tmp, self.index_path)
        if bin_samples > self._end:
            # samples whose index line never landed: appends write at the
            # file's end but are indexed at _end, so cut the file there
            with open(self.bin_path, "r+b") as f:
                f.truncate(self._end * 2)

    def _map(self) -> np.memmap:
        if self._mm is None or self._mm_samples < self._end:
            if self._write_f is not None:
                self._write_f.flush()
            self._mm = np.memmap(self.bin_path, dtype=np.int16, mode="r")
            self._mm_samples = self._mm.shape[0]
        return self._mm

    @staticmethod
    def _stat_src(path: str) -> Optional[Tuple[int, int]]:
        try:
            st = os.stat(path)
        except OSError:
            return None
        return int(st.st_size), int(st.st_mtime_ns)

    def _is_fresh(self, path: str) -> bool:
        """One stat a path a process: an entry whose source's size or mtime
        moved is dropped (a miss); an entry without metadata is trusted."""
        if path in self._validated:
            return True
        meta = self._src_meta.get(path)
        if meta is not None and self._stat_src(path) != meta:
            del self._index[path]
            del self._src_meta[path]
            return False
        self._validated.add(path)
        return True

    def __contains__(self, path: str) -> bool:
        return path in self._index and self._is_fresh(path)

    def __len__(self) -> int:
        return len(self._index)

    def __getitem__(self, path: str) -> np.ndarray:
        if path not in self:
            raise KeyError(path)
        off, n = self._index[path]
        return self._map()[off: off + n]

    def _acquire_writer_lock(self) -> None:
        import fcntl

        self._lock_f = open(self.dir / "writer.lock", "w")
        try:
            fcntl.flock(self._lock_f, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            self._lock_f.close()
            self._lock_f = None
            raise RuntimeError(f"another process is writing the wave cache at {self.dir}: give "
                               "each writer (each data-parallel rank) a cache_dir of its own, or "
                               "build the cache once before launching") from None

    def __setitem__(self, path: str, wave: np.ndarray) -> None:
        if path in self._index and self._is_fresh(path):
            return                                        # decode once: a fresh entry is the same
        if np.asarray(wave).dtype != np.int16:
            raise TypeError(f"MmapWaveCache stores int16 PCM, got {np.asarray(wave).dtype} "
                            f"for {path}")
        wave = np.ascontiguousarray(wave, dtype=np.int16)
        if self._write_f is None:
            self._acquire_writer_lock()
            self._write_f = open(self.bin_path, "ab")
        self._write_f.write(wave.astype("<i2", copy=False).tobytes())
        self._write_f.flush()
        rec = {"p": path, "o": self._end, "n": int(wave.size)}
        src = self._stat_src(path)
        if src is not None:
            rec["s"], rec["m"] = src
            self._src_meta[path] = src
        with open(self.index_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        self._index[path] = (self._end, int(wave.size))
        self._validated.add(path)
        self._end += int(wave.size)

    def close(self) -> None:
        """Close the append handle and release the writer lock."""
        if self._write_f is not None:
            self._write_f.close()
            self._write_f = None
        if self._lock_f is not None:
            self._lock_f.close()
            self._lock_f = None
        self._mm = None
