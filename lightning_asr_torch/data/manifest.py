"""JSONL manifests with a duration filter (port of
``lightning_asr_tpu/data/manifest.py``).

Rows are ``{"audio_filepath": ..., "duration": ..., "text": ...}``; rows
longer than ``max_duration`` seconds are dropped (train 16.7 s, dev 40 s in
``conf/conf.yaml``).
"""

from __future__ import annotations

import json
import logging
from dataclasses import dataclass
from pathlib import Path
from typing import List, Sequence, Union

logger = logging.getLogger(__name__)


@dataclass
class ManifestEntry:
    audio_filepath: str
    duration: float
    text: str


def read_manifests(
    manifest_paths: Union[str, Path, Sequence[Union[str, Path]]],
    max_duration: float = 16.7,
) -> List[ManifestEntry]:
    """Read one or more JSONL manifests, dropping rows over ``max_duration``."""
    if isinstance(manifest_paths, (str, Path)):
        manifest_paths = [manifest_paths]
    entries: List[ManifestEntry] = []
    for path in manifest_paths:
        dropped, dropped_s = 0, 0.0
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                row = json.loads(line)
                if row["duration"] > max_duration:
                    dropped += 1
                    dropped_s += row["duration"]
                    continue
                entries.append(ManifestEntry(row["audio_filepath"], float(row["duration"]),
                                             row["text"]))
        logger.info("manifest %s: filtered %d utterances (%.2f min) over %.1fs",
                    path, dropped, dropped_s / 60.0, max_duration)
    return entries


def write_manifest(path: Union[str, Path], entries: Sequence[ManifestEntry]) -> None:
    with open(path, "w", encoding="utf-8") as f:
        for e in entries:
            f.write(json.dumps({"audio_filepath": e.audio_filepath, "duration": e.duration,
                                "text": e.text}, ensure_ascii=False) + "\n")
