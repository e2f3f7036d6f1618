"""Import reference (PyTorch) checkpoints into the port (the port's copy of
``lightning_asr_tpu/utils/torch_import.py``'s mapping).

A ``kouyt5/lightning-asr`` checkpoint is a pytorch-lightning ``.ckpt``
whose ``state_dict`` holds the ``MyModel2`` weights under the
LightningModule's ``encoder.`` prefix.  ``convert_state_dict`` renames its
keys to the port's module names; the layouts are already the port's (a
Conv1d weight is (out, in/groups, k), a Linear weight (out, in), the LSTM
tensors (4H, ...)), so no tensor is transposed:

  * ``encoder.encoder.*`` -> ``encoder.*``, ``encoder.decoder.*`` ->
    ``decoder.*``, ``encoder.feature_mapping.*`` -> ``feature_mapping.*``;
    other keys (losses, metrics) are dropped;
  * a block's separable convs ``seq.{i}`` -> ``sep{i}``, the last one
    ``sep_last``; its residual ``reside.0`` / ``reside.1`` ->
    ``reside_conv`` / ``reside_bn``;
  * the epilog ``last_cnn2.0`` / ``last_cnn2.1`` -> ``last_conv`` /
    ``last_bn``;
  * ``context_rnn.weight_ih_l0[_reverse]`` (and ``weight_hh``, ``bias_ih``,
    ``bias_hh``) -> ``w_ih_f`` / ``w_ih_b`` (...);
  * squeeze-excite ``se.fc.0`` / ``se.fc.2`` -> ``se.fc1`` / ``se.fc2``;
  * BatchNorm's ``num_batches_tracked`` is dropped.

As the JAX package's converter, it knows the QuartNetContext family's
reference names (``quartznet12_context`` and ``_se``).  Values become
float32 CPU tensors.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Tuple, Union

import torch

_WRAPPERS = (("encoder.encoder.", "encoder."), ("encoder.decoder.", "decoder."),
             ("encoder.feature_mapping.", "feature_mapping."))
_BN_LEAVES = ("weight", "bias", "running_mean", "running_var")
_LSTM = {"weight_ih_l0": "w_ih", "weight_hh_l0": "w_hh", "bias_ih_l0": "b_ih", "bias_hh_l0": "b_hh"}


def _bn(prefix: str, leaf: str) -> Optional[str]:
    return f"{prefix}.{leaf}" if leaf in _BN_LEAVES else None


def _sepconv(prefix: str, rest: list) -> Optional[str]:
    """The port's name of a separable conv's tensor, ``rest`` its reference
    key after the conv's own prefix."""
    mod = rest[0]
    if mod in ("depthwise_conv", "pointwise_conv") and rest[1] == "weight":
        return f"{prefix}.{mod}.weight"
    if mod == "bn":
        return _bn(f"{prefix}.bn", rest[1])
    if mod == "se" and rest[-1] == "weight":          # se.fc.0.weight / se.fc.2.weight
        idx = rest[2] if rest[1] == "fc" else rest[1]
        return f"{prefix}.se.{'fc1' if idx in ('0', 'fc1') else 'fc2'}.weight"
    return None


def _port_key(key: str, n_seq: Dict[str, int]) -> Optional[str]:
    """The port's name for a (wrapper-stripped) reference key, or None for
    a tensor the port does not hold."""
    parts = key.split(".")
    if parts[0] in ("decoder", "feature_mapping"):
        return key if parts[-1] in ("weight", "bias") else None
    if parts[0] != "encoder" or len(parts) < 3:
        return None
    sub = parts[1]
    if sub == "context_rnn":
        name = parts[-1]
        kind = _LSTM.get(name.replace("_reverse", ""))
        direction = "b" if name.endswith("_reverse") else "f"
        return f"encoder.context_rnn.{kind}_{direction}" if kind else None
    if sub == "last_cnn2":
        idx, leaf = parts[2], parts[3]
        if idx == "0":
            return f"encoder.last_conv.{leaf}"
        return _bn("encoder.last_bn", leaf) if idx == "1" else None
    if sub == "first_cnn":
        return _sepconv("encoder.first_cnn", parts[2:])
    if sub.startswith("block"):
        rest = parts[2:]
        if rest[0] == "seq":
            i = int(rest[1])
            sep = "sep_last" if i == n_seq[sub] - 1 else f"sep{i}"
            return _sepconv(f"encoder.{sub}.{sep}", rest[2:])
        if rest[0] == "reside":
            if rest[1] == "0" and rest[2] == "weight":
                return f"encoder.{sub}.reside_conv.weight"
            return _bn(f"encoder.{sub}.reside_bn", rest[2]) if rest[1] == "1" else None
    return None


def convert_state_dict(state_dict: Dict[str, object]) -> Dict[str, torch.Tensor]:
    """Reference state_dict (tensors or arrays) -> the port's state_dict."""
    items = {}
    for key, value in state_dict.items():
        for old, new in _WRAPPERS:
            if key.startswith(old):
                key = new + key[len(old):]
                break
        items[key] = value
    n_seq: Dict[str, int] = {}
    for key in items:
        parts = key.split(".")
        if parts[0] == "encoder" and len(parts) > 3 and parts[2] == "seq":
            n_seq[parts[1]] = max(n_seq.get(parts[1], 0), int(parts[3]) + 1)
    out: Dict[str, torch.Tensor] = {}
    for key, value in items.items():
        name = _port_key(key, n_seq)
        if name is not None:
            out[name] = torch.as_tensor(value).detach().to("cpu", torch.float32).clone()
    return out


def load_reference_checkpoint(path: Union[str, Path]) -> Tuple[Dict[str, torch.Tensor], dict]:
    """A reference ``.ckpt`` -> (the port's state_dict, the checkpoint's
    ``hyper_parameters``).  A ``.ckpt`` is a pickle that may hold
    pytorch-lightning objects, so it is read with the full unpickler:
    convert only checkpoints you trust."""
    ckpt = torch.load(str(path), map_location="cpu", weights_only=False)
    state_dict = ckpt.get("state_dict", ckpt)
    return convert_state_dict(state_dict), dict(ckpt.get("hyper_parameters", {}))
