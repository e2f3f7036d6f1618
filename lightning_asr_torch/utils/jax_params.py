"""Weight bridge between the JAX package's flax trees and the port's
state_dict (layouts as ``lightning_asr_tpu/utils/torch_import.py``
documents).

  * conv ``kernel`` (k, in/groups, out)     <-> ``weight`` (out, in/groups, k)
  * Dense ``kernel`` (in, out)              <-> ``weight`` (out, in)
    (a kernel's axes reversed, either way)
  * conv ``bias``                           <-> ``bias``
  * BN ``scale``/``bias`` (params) and ``mean``/``var`` (batch_stats)
                                            <-> ``weight``/``bias``/``running_mean``/``running_var``
  * LayerNorm / GroupNorm ``scale``/``bias`` (no batch_stats)
                                            <-> ``weight``/``bias``
    (a 1-D ``weight`` is a norm's scale: conv and Dense weights are 2-D or 3-D)
  * ``context_rnn`` ``w_ih_f``/``w_hh_f``/``b_ih_f``/``b_hh_f`` (and ``_b``) keep
    their names and shapes; so do the LSTM head's ``head_rnn`` tensors, whose
    ``head_bn`` is a BatchNorm and ``head_fc`` a Dense as above.

The port's own encoder ``conformer_ctc_large`` has no flax counterpart:
``from_jax`` and ``to_jax`` refuse its tensors (``ValueError``).

Keys are the flax paths joined with dots (``encoder.block1.sep_last.bn``),
which are the port's module names.  Trees are nested dicts of numpy arrays
(``jax.device_get`` of the flax variables, or an orbax restore).

``opt_state_from_jax`` / ``opt_state_to_jax`` carry a NovoGrad state
across, bit for bit, in either variant.  Fused: the JAX buffers order
tensors as JAX flattens the flax tree (keys sorted) and keep conv kernels
as (k, in, out); the port's follow its parameter dict and (out, in, k) /
(out, in).  Per-tensor (the variant a tensor-parallel run trains with):
the momentum is a tree like the params, mapped leaf by leaf and transposed
as the kernels are; the scalar moments keep their values under the port's
names.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..optim.novograd import _CHUNK, FlatLayout, FusedNovogradState, NovogradState

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


# the Conformer's top-level encoder modules (models/conformer.py)
_CONFORMER_MODULES = ("pre_encode", "layers", "pos_enc")


def _refuse_conformer(paths) -> None:
    """``ValueError`` where a path (a tuple of names) is a Conformer's."""
    if any(len(p) > 1 and p[0] == "encoder" and p[1] in _CONFORMER_MODULES for p in paths):
        raise ValueError("conformer_ctc_large has no JAX counterpart: its weights do not "
                         "cross to or from a flax tree")


def from_jax(params: dict, batch_stats: dict) -> Dict[str, torch.Tensor]:
    """flax ``params`` + ``batch_stats`` -> torch state_dict (copies)."""
    flat = _flatten(params)
    _refuse_conformer(flat)
    bn_modules = {path[:-1] for path in _flatten(batch_stats)}
    sd: Dict[str, torch.Tensor] = {}
    for path, value in flat.items():
        module, leaf = path[:-1], path[-1]
        if module in bn_modules:
            if leaf not in _BN_PARAMS:
                raise ValueError(f"unexpected BatchNorm leaf {'/'.join(path)}")
            name = _BN_PARAMS[leaf]
        elif leaf == "kernel":
            if value.ndim not in (2, 3):
                raise ValueError(f"{'/'.join(path)}: a conv or Dense kernel is 3-D or 2-D, "
                                 f"got {value.shape}")
            name, value = "weight", np.transpose(value)
        elif leaf == "scale":                    # LayerNorm, GroupNorm
            name = "weight"
        else:
            name = leaf                          # biases, LSTM weights
        sd[".".join(module + (name,))] = torch.from_numpy(np.array(value))
    for path, value in _flatten(batch_stats).items():
        if path[-1] not in _BN_STATS:
            raise ValueError(f"unexpected batch_stats leaf {'/'.join(path)}")
        sd[".".join(path[:-1] + (_BN_STATS[path[-1]],))] = torch.from_numpy(np.array(value))
    return sd


def to_jax(state_dict: Dict[str, torch.Tensor]) -> Tuple[dict, dict]:
    """torch state_dict -> (flax ``params``, ``batch_stats``) of numpy arrays."""
    _refuse_conformer(tuple(k.split(".")) for k in state_dict)
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
        elif name == "weight" and value.ndim == 1:   # LayerNorm, GroupNorm
            _set(params, path + ("scale",), value)
        elif name == "weight":                    # conv or Dense; LSTM tensors are w_ih_f, ...
            _set(params, path + ("kernel",), np.transpose(value))
        else:
            _set(params, path + (name,), value)
    return params, batch_stats


def _sorted_leaves(tree: dict, prefix: Tuple[str, ...] = ()) -> List[Tuple[Tuple[str, ...], np.ndarray]]:
    """Leaves of a nested dict in JAX's tree order (keys sorted at every
    level), which is the tensor order of its fused NovoGrad buffers."""
    out = []
    for k in sorted(tree, key=str):
        v = tree[k]
        if isinstance(v, dict) or hasattr(v, "items"):
            out.extend(_sorted_leaves(dict(v), prefix + (str(k),)))
        else:
            out.append((prefix + (str(k),), np.asarray(v)))
    return out


def _port_name(path: Tuple[str, ...], bn_modules) -> str:
    module, leaf = path[:-1], path[-1]
    if module in bn_modules:
        return ".".join(module + (_BN_PARAMS[leaf],))
    return ".".join(module + ("weight" if leaf in ("kernel", "scale") else leaf,))


def _chunks(n: int) -> int:
    return -(-n // _CHUNK)


def _per_tensor_from_jax(field, batch_stats: dict,
                         port_params: Dict[str, torch.Tensor]) -> NovogradState:
    bn_modules = {p[:-1] for p, _ in _sorted_leaves(batch_stats)}
    dev = next(iter(port_params.values())).device
    trees = {}
    for k in ("exp_avg", "exp_avg_sq", "max_exp_avg_sq"):
        trees[k] = {}
        for path, leaf in _sorted_leaves(dict(field(k))):
            value = np.transpose(leaf) if path[-1] == "kernel" else leaf
            trees[k][_port_name(path, bn_modules)] = torch.from_numpy(np.array(value))
    if set(trees["exp_avg"]) != set(port_params):
        raise ValueError("the flax params and the port's parameters name other tensors")
    return NovogradState(
        torch.tensor(int(np.asarray(field("count"))), dtype=torch.int32).to(dev),
        *({n: trees[k][n].to(dev) for n in port_params}
          for k in ("exp_avg", "exp_avg_sq", "max_exp_avg_sq")))


def opt_state_from_jax(opt_state, params: dict, batch_stats: dict,
                       port_params: Dict[str, torch.Tensor]):
    """The JAX package's NovoGrad state (numpy; a NamedTuple or dict with
    ``count``, ``exp_avg``, ``exp_avg_sq``, ``max_exp_avg_sq`` and, when
    fused, ``p_flat``) for the flax ``params`` / ``batch_stats``, as the
    port's ``FusedNovogradState`` or ``NovogradState`` over ``port_params``
    (the port's parameter dict, whose order and shapes set the port's
    layout).  Exact: both fused layouts pad each tensor to whole
    2048-element chunks; only the tensor order and the conv and Dense
    kernels' element order differ.  A per-tensor state's momentum is a
    tree (a dict), a fused one's a buffer."""
    field = (lambda k: opt_state[k]) if isinstance(opt_state, dict) else (
        lambda k: getattr(opt_state, k))
    if isinstance(field("exp_avg"), dict) or hasattr(field("exp_avg"), "items"):
        return _per_tensor_from_jax(field, batch_stats, port_params)
    leaves = _sorted_leaves(params)
    bn_modules = {p[:-1] for p, _ in _sorted_leaves(batch_stats)}
    per_leaf = {k: {} for k in ("exp_avg", "p_flat", "exp_avg_sq", "max_exp_avg_sq")}
    off = 0
    for i, (path, leaf) in enumerate(leaves):
        name = _port_name(path, bn_modules)
        for k in ("exp_avg", "p_flat"):
            flat = np.asarray(field(k)).reshape(-1)[off * _CHUNK: off * _CHUNK + leaf.size]
            value = flat.reshape(leaf.shape)
            if path[-1] == "kernel":
                value = np.transpose(value)
            per_leaf[k][name] = torch.from_numpy(np.array(value))
        for k in ("exp_avg_sq", "max_exp_avg_sq"):
            per_leaf[k][name] = torch.from_numpy(np.array(np.asarray(field(k))[i]))
        off += _chunks(leaf.size)
    if set(per_leaf["exp_avg"]) != set(port_params):
        raise ValueError("the flax params and the port's parameters name other tensors")
    layout = FlatLayout(port_params)
    dev = layout.seg.device
    vec = lambda d: torch.stack([d[n] for n in layout.names]).to(dev)  # noqa: E731
    return FusedNovogradState(
        torch.tensor(int(np.asarray(field("count"))), dtype=torch.int32).to(dev),
        layout.flatten(per_leaf["exp_avg"]).to(dev), vec(per_leaf["exp_avg_sq"]),
        vec(per_leaf["max_exp_avg_sq"]), layout.flatten(per_leaf["p_flat"]).to(dev))


def _per_tensor_to_jax(state: NovogradState, port_batch_stats: Dict[str, torch.Tensor]) -> dict:
    stats = {k: v.detach().cpu() for k, v in port_batch_stats.items()}
    momentum = to_jax({**{n: t.detach().cpu() for n, t in state.exp_avg.items()}, **stats})[0]
    bn_modules = {tuple(k.rsplit(".", 1)[0].split(".")) for k in stats if k.endswith(".running_mean")}
    out = {"count": np.asarray(state.count.cpu().numpy(), np.int32), "exp_avg": momentum}
    for k in ("exp_avg_sq", "max_exp_avg_sq"):
        scalars = getattr(state, k)
        tree: dict = {}
        for path, _ in _sorted_leaves(momentum):      # the momentum's paths, the port's names
            _set(tree, path, scalars[_port_name(path, bn_modules)].detach().cpu().numpy())
        out[k] = tree
    return out


def opt_state_to_jax(state, port_params: Dict[str, torch.Tensor],
                     port_batch_stats: Dict[str, torch.Tensor]) -> dict:
    """The inverse of ``opt_state_from_jax``: a dict of numpy fields in the
    JAX package's layout (fused, or per-tensor trees for a
    ``NovogradState``) for the flax tree that ``to_jax`` makes of
    ``port_params`` and ``port_batch_stats``."""
    if isinstance(state, NovogradState):
        return _per_tensor_to_jax(state, port_batch_stats)
    layout = FlatLayout(port_params)
    momentum = {n: t.detach().cpu() for n, t in layout.unflatten(state.exp_avg).items()}
    masters = {n: t.detach().cpu() for n, t in layout.unflatten(state.p_flat).items()}
    stats = {k: v.detach().cpu() for k, v in port_batch_stats.items()}
    trees = {k: to_jax({**d, **stats})[0] for k, d in (("exp_avg", momentum), ("p_flat", masters))}
    bn_modules = {tuple(k.rsplit(".", 1)[0].split(".")) for k in stats if k.endswith(".running_mean")}
    index = {n: i for i, n in enumerate(layout.names)}
    out = {"count": np.asarray(state.count.cpu().numpy(), np.int32)}
    for k in ("exp_avg", "p_flat"):
        parts = []
        for _, leaf in _sorted_leaves(trees[k]):
            flat = leaf.astype(np.float32).reshape(-1)
            parts.append(np.pad(flat, (0, _chunks(flat.size) * _CHUNK - flat.size)))
        out[k] = np.concatenate(parts).reshape(-1, _CHUNK)
    order = [index[_port_name(p, bn_modules)] for p, _ in _sorted_leaves(trees["exp_avg"])]
    for k in ("exp_avg_sq", "max_exp_avg_sq"):
        out[k] = getattr(state, k).detach().cpu().numpy()[order]
    return out
