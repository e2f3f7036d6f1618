"""The port's checkpoints: a directory per checkpoint, and the trainer's
top-k + last manager (port of ``lightning_asr_tpu/training/checkpoint.py``).

A checkpoint directory holds

  * ``state.pt``: a ``torch.save`` of the model state_dict (parameters and
    BatchNorm statistics), so ``AsrTranslator`` loads any checkpoint;
  * ``metadata.json``: ``hparams`` (the keys the JAX trainer writes:
    ``labels``, ``use_cer``, ``encoder``, ``mask``, ``compute_dtype``,
    ``frontend``, ``normalize``, ...), and from the trainer ``epoch``,
    ``metrics`` and ``trainer`` (host-side controller state such as the
    ReduceLROnPlateau counters);
  * ``train_state.pt``, from the trainer: ``step``, ``nan_count`` and the
    optimizer state, NamedTuples stored as tagged dicts so that
    ``torch.load(weights_only=True)`` reads them.

``CheckpointManager`` keeps ``last`` and the ``top_k`` best by a monitored
metric (``val_wer``, lower is better) as ``asr-epochNN-val_werX.XX``, with
``index.json`` listing them.  ``restore`` rebuilds a train state in the
structure of a template, converting a NovoGrad state between the fused and
per-tensor variants when they differ (``migrate_novograd_opt_state``).

In a data-parallel process group every rank calls ``save`` and ``restore``
with the same directory (a shared file system across hosts): rank 0 alone
writes the checkpoint, prunes the top-k and writes ``index.json``, and a
barrier follows each save, so no rank reads a checkpoint before it is
whole; ``restore`` reads on every rank (the JAX package's
``training/checkpoint.py:33-89``, where orbax writes from the primary).
"""

from __future__ import annotations

import json
import math
import os
import shutil
from pathlib import Path
from typing import Any, Dict, Optional, Tuple, Union

import torch

from ..optim.novograd import (FusedNovogradState, InjectHyperparamsState, NovogradState,
                              migrate_novograd_opt_state)
from ..parallel import distributed

STATE_FILE = "state.pt"
TRAIN_STATE_FILE = "train_state.pt"
META_FILE = "metadata.json"
_TAG = "__namedtuple__"
_NAMEDTUPLES = {cls.__name__: cls for cls in (NovogradState, FusedNovogradState,
                                              InjectHyperparamsState)}


def save_checkpoint(path: Union[str, Path], state_dict: Dict[str, torch.Tensor],
                    hparams: dict, metadata: Optional[dict] = None,
                    train_state: Optional[dict] = None) -> Path:
    """Write a checkpoint directory; ``metadata`` adds keys beside
    ``hparams``, ``train_state`` writes ``train_state.pt``."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()}, path / STATE_FILE)
    if train_state is not None:
        torch.save(_encode(train_state), path / TRAIN_STATE_FILE)
    meta = {**(metadata or {}), "hparams": hparams}
    (path / META_FILE).write_text(json.dumps(meta, indent=2, default=str))
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


def _encode(obj):
    """Tensors to the CPU; NamedTuples as tagged dicts."""
    if torch.is_tensor(obj):
        return obj.detach().cpu()
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return {_TAG: type(obj).__name__, **{f: _encode(getattr(obj, f)) for f in obj._fields}}
    if isinstance(obj, dict):
        return {k: _encode(v) for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        return [_encode(v) for v in obj]
    return obj


def _restore_opt(raw, template, params):
    """``raw`` (a decoded optimizer state) in the structure, devices and
    dtypes of ``template``."""
    if isinstance(template, (NovogradState, FusedNovogradState)):
        if isinstance(raw, dict) and raw.get(_TAG) == InjectHyperparamsState.__name__:
            raw = raw["inner_state"]                 # leaving a runtime-lr wrapper
        return migrate_novograd_opt_state(raw, params, template)
    if isinstance(template, InjectHyperparamsState):
        if isinstance(raw, dict) and raw.get(_TAG) == InjectHyperparamsState.__name__:
            hyper = {k: _like(raw["hyperparams"][k], v) for k, v in template.hyperparams.items()}
            return InjectHyperparamsState(_like(raw["count"], template.count), hyper,
                                          _restore_opt(raw["inner_state"], template.inner_state,
                                                       params))
        inner = _restore_opt(raw, template.inner_state, params)   # entering one
        return template._replace(count=inner.count.clone(), inner_state=inner)
    raise TypeError(f"cannot restore an optimizer state into a {type(template).__name__}")


def _like(value, template: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(value).to(device=template.device, dtype=template.dtype)


def _write_atomic(path: Path, write) -> None:
    tmp = path.with_name(path.name + ".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    write(tmp)
    if path.exists():
        shutil.rmtree(path)
    os.replace(tmp, path)


class CheckpointManager:
    def __init__(self, directory: Union[str, Path], top_k: int = 3, monitor: str = "val_wer"):
        self.directory = Path(directory).resolve()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.top_k = top_k
        self.monitor = monitor
        self._index_path = self.directory / "index.json"
        self._index = (json.loads(self._index_path.read_text()) if self._index_path.exists()
                       else {"saved": [], "last": None})

    def save(self, state, epoch: int, metrics: dict, hparams: Optional[dict] = None,
             trainer_meta: Optional[dict] = None) -> None:
        """Save ``last`` always; keep the ``top_k`` best by the monitored
        metric.  ``trainer_meta`` carries host-side controller state.  Rank
        0 writes; every rank waits for it."""
        if distributed.is_primary():
            self._save(state, epoch, metrics, hparams, trainer_meta)
        distributed.barrier()

    def _save(self, state, epoch: int, metrics: dict, hparams: Optional[dict],
              trainer_meta: Optional[dict]) -> None:
        metadata: Dict[str, Any] = {"epoch": epoch,
                                    "metrics": {k: float(v) for k, v in metrics.items()}}
        if trainer_meta:
            metadata["trainer"] = trainer_meta
        train_state = {"step": state.step, "nan_count": state.nan_count,
                       "opt_state": state.opt_state}
        last = self.directory / "last"
        _write_atomic(last, lambda p: save_checkpoint(
            p, {**state.params, **state.batch_stats}, hparams or {}, metadata, train_state))
        self._index["last"] = "last"

        score = metrics.get(self.monitor)
        if score is not None and math.isfinite(float(score)):
            name = f"asr-epoch{epoch:02d}-{self.monitor}{float(score):.2f}"
            # the files of `last` are never written in place: link them
            _write_atomic(self.directory / name,
                          lambda p: shutil.copytree(last, p, copy_function=os.link))
            self._index["saved"] = [e for e in self._index["saved"] if e["name"] != name]
            self._index["saved"].append({"name": name, "score": float(score), "epoch": epoch})
            self._index["saved"].sort(key=lambda e: e["score"])
            while len(self._index["saved"]) > self.top_k:
                worst = self._index["saved"].pop()
                shutil.rmtree(self.directory / worst["name"], ignore_errors=True)
        self._index_path.write_text(json.dumps(self._index, indent=2))

    def restore(self, template, which: str = "last"):
        """(train state in the structure of ``template``, metadata) from the
        checkpoint ``which``: a path, or a name in this directory."""
        path = Path(which)
        if not path.is_absolute() and not path.exists():
            path = self.directory / which
        state_dict, meta = load_checkpoint(path)
        raw = torch.load(path / TRAIN_STATE_FILE, map_location="cpu", weights_only=True)
        params = {k: _like(state_dict[k], v) for k, v in template.params.items()}
        stats = {k: _like(state_dict[k], v) for k, v in template.batch_stats.items()}
        state = type(template)(
            step=_like(raw["step"], template.step), params=params, batch_stats=stats,
            opt_state=_restore_opt(raw["opt_state"], template.opt_state, params),
            nan_count=_like(raw["nan_count"], template.nan_count))
        return state, meta
