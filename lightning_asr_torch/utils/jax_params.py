"""Weight bridge between the JAX package's flax trees and the port's
state_dict (layouts as ``lightning_asr_tpu/utils/torch_import.py``
documents).

  * conv ``kernel`` (k, in/groups, out)     <-> ``weight`` (out, in/groups, k)
  * conv ``bias``                           <-> ``bias``
  * BN ``scale``/``bias`` (params) and ``mean``/``var`` (batch_stats)
                                            <-> ``weight``/``bias``/``running_mean``/``running_var``
  * ``context_rnn`` ``w_ih_f``/``w_hh_f``/``b_ih_f``/``b_hh_f`` (and ``_b``) keep
    their names and shapes.

Keys are the flax paths joined with dots (``encoder.block1.sep_last.bn``),
which are the port's module names.  Trees are nested dicts of numpy arrays
(``jax.device_get`` of the flax variables, or an orbax restore).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

_BN_PARAMS = {"scale": "weight", "bias": "bias"}
_BN_STATS = {"mean": "running_mean", "var": "running_var"}


def _flatten(tree: dict, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flatten(dict(v), prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = np.asarray(v)
    return out


def _set(tree: dict, path: Tuple[str, ...], value: np.ndarray) -> None:
    for part in path[:-1]:
        tree = tree.setdefault(part, {})
    tree[path[-1]] = value


def from_jax(params: dict, batch_stats: dict) -> Dict[str, torch.Tensor]:
    """flax ``params`` + ``batch_stats`` -> torch state_dict (copies)."""
    flat = _flatten(params)
    bn_modules = {path[:-1] for path in _flatten(batch_stats)}
    sd: Dict[str, torch.Tensor] = {}
    for path, value in flat.items():
        module, leaf = path[:-1], path[-1]
        if module in bn_modules:
            if leaf not in _BN_PARAMS:
                raise ValueError(f"unexpected BatchNorm leaf {'/'.join(path)}")
            name = _BN_PARAMS[leaf]
        elif leaf == "kernel":
            if value.ndim != 3:
                raise ValueError(f"{'/'.join(path)}: only conv kernels are ported, got {value.shape}")
            name, value = "weight", np.transpose(value, (2, 1, 0))
        else:
            name = leaf                          # conv bias, LSTM weights
        sd[".".join(module + (name,))] = torch.from_numpy(np.array(value))
    for path, value in _flatten(batch_stats).items():
        if path[-1] not in _BN_STATS:
            raise ValueError(f"unexpected batch_stats leaf {'/'.join(path)}")
        sd[".".join(path[:-1] + (_BN_STATS[path[-1]],))] = torch.from_numpy(np.array(value))
    return sd


def to_jax(state_dict: Dict[str, torch.Tensor]) -> Tuple[dict, dict]:
    """torch state_dict -> (flax ``params``, ``batch_stats``) of numpy arrays."""
    stats_of = {v: k for k, v in _BN_STATS.items()}
    bn_modules = {k.rsplit(".", 1)[0] for k in state_dict if k.endswith(".running_mean")}
    params: dict = {}
    batch_stats: dict = {}
    for key, tensor in state_dict.items():
        value = tensor.detach().cpu().numpy()
        module, name = key.rsplit(".", 1)
        path = tuple(module.split("."))
        if name in stats_of:
            _set(batch_stats, path + (stats_of[name],), value)
        elif module in bn_modules:
            _set(params, path + ({"weight": "scale", "bias": "bias"}[name],), value)
        elif name == "weight":
            _set(params, path + ("kernel",), np.transpose(value, (2, 1, 0)))
        else:
            _set(params, path + (name,), value)
    return params, batch_stats
