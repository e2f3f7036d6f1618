"""Label/vocabulary handling (port of ``lightning_asr_tpu/data/vocab.py``).

The CTC blank is the **last** index: ``blank_id == len(labels)``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List


@dataclass
class Vocabulary:
    labels: List[str]
    use_cer: bool = False

    @property
    def blank_id(self) -> int:
        return len(self.labels)  # blank is the LAST index

    @property
    def num_classes(self) -> int:
        """Model output width = vocab + blank."""
        return len(self.labels) + 1
