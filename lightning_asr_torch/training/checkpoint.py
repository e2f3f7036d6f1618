"""The port's checkpoint format: a directory holding ``state.pt`` (a
``torch.save`` of the model state_dict) and ``metadata.json`` with
``hparams`` — the same keys the JAX trainer writes (``labels``,
``use_cer``, ``encoder``, ``in_c``, ``mask``, ``compute_dtype``,
``frontend``, ``normalize``), so loading needs no config
(``lightning_asr_tpu/training/checkpoint.py::load_checkpoint``)."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Tuple, Union

import torch

STATE_FILE = "state.pt"
META_FILE = "metadata.json"


def save_checkpoint(path: Union[str, Path], state_dict: Dict[str, torch.Tensor],
                    hparams: dict) -> Path:
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()}, path / STATE_FILE)
    (path / META_FILE).write_text(json.dumps({"hparams": hparams}, indent=2, default=str))
    return path


def load_checkpoint(path: Union[str, Path]) -> Tuple[Dict[str, torch.Tensor], dict]:
    """(state_dict on the CPU, metadata) from a checkpoint directory."""
    path = Path(path)
    if not (path / STATE_FILE).is_file():
        raise FileNotFoundError(f"{path} holds no {STATE_FILE}: not a checkpoint of this package")
    state = torch.load(path / STATE_FILE, map_location="cpu", weights_only=True)
    meta_path = path / META_FILE
    metadata = json.loads(meta_path.read_text()) if meta_path.exists() else {}
    return state, metadata
