"""Label/vocabulary handling (port of ``lightning_asr_tpu/data/vocab.py``).

Labels come inline from the config (English: 28 characters including space
and apostrophe), or from a text file with one label per line (Mandarin
vocab files), which turns CER mode on.  The CTC blank is the **last**
index: ``blank_id == len(labels)``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Sequence, Tuple, Union


def load_labels(labels: Union[str, Path, Sequence[str]]) -> Tuple[List[str], bool]:
    """Return (labels, use_cer). A string or path is read one label per line
    and flips CER mode."""
    if isinstance(labels, (str, Path)):
        with open(labels, encoding="utf-8") as f:
            items = [line.strip() for line in f.readlines()]
        return [c for c in items if c != ""], True
    return list(labels), False


@dataclass
class Vocabulary:
    labels: List[str]
    use_cer: bool = False
    char2index: dict = field(init=False, repr=False)

    def __post_init__(self):
        self.char2index = {c: i for i, c in enumerate(self.labels)}

    @classmethod
    def from_config(cls, labels: Union[str, Path, Sequence[str]]) -> "Vocabulary":
        return cls(*load_labels(labels))

    @property
    def blank_id(self) -> int:
        return len(self.labels)  # blank is the LAST index

    @property
    def num_classes(self) -> int:
        """Model output width = vocab + blank."""
        return len(self.labels) + 1

    def encode(self, text: str) -> List[int]:
        return [self.char2index[c] for c in text]
