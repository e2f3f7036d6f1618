#!/usr/bin/env python
"""Convert a checkpoint of the JAX package (an Orbax checkpoint directory
as its ``CheckpointManager`` writes it, e.g. ``run/checkpoints/last``) into
a checkpoint directory of the PyTorch port:

    python scripts/torch_from_jax_ckpt.py --jax-ckpt run/checkpoints/last \\
        --out outputs/port_ckpt

It runs where JAX is installed (on the CPU is enough), since it reads the
checkpoint with the JAX package's config-free ``load_checkpoint``.  The
output holds what ``lightning_asr_torch/training/checkpoint.py`` documents:

  * ``state.pt``: the parameters and BatchNorm statistics, mapped by
    ``lightning_asr_torch/utils/jax_params.py::from_jax``;
  * ``metadata.json``: the JAX checkpoint's metadata (``hparams``,
    ``epoch``, ``metrics``, ``trainer``), with ``encoder``, ``mask`` and
    ``compute_dtype`` filled in where it lacks them, so ``AsrTranslator``
    loads it with no config;
  * ``train_state.pt``: ``step``, ``nan_count`` and the optimizer state,
    when the JAX state holds a NovoGrad state, fused or per-tensor (the
    variant a tensor-parallel run trains with), alone or inside the
    runtime-lr wrapper: converted bit for bit by ``opt_state_from_jax``,
    so the port's ``CheckpointManager.restore`` resumes from it (and
    migrates it to the other variant where the run asks for that).
    Without one only the weights are written.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import jax
import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from lightning_asr_tpu.training.checkpoint import load_checkpoint  # noqa: E402
from lightning_asr_torch.data.vocab import Vocabulary  # noqa: E402
from lightning_asr_torch.inference.predict import AsrTranslator  # noqa: E402
from lightning_asr_torch.models.quartznet import build_model  # noqa: E402
from lightning_asr_torch.optim.novograd import InjectHyperparamsState  # noqa: E402
from lightning_asr_torch.training.checkpoint import save_checkpoint  # noqa: E402
from lightning_asr_torch.utils.jax_params import from_jax, opt_state_from_jax  # noqa: E402

_PER_TENSOR = {"count", "exp_avg", "exp_avg_sq", "max_exp_avg_sq"}
_INJECT = {"count", "hyperparams", "inner_state"}


def _fields(node):
    """A restored NamedTuple (or dict) as a dict of its fields, else None."""
    if hasattr(node, "_asdict"):
        return dict(node._asdict())
    return dict(node) if isinstance(node, dict) else None


def find_opt_state(node):
    """(the NovoGrad state, fused or per-tensor, the runtime-lr wrapper
    around it or None) in a restored optimizer state: the state itself, the
    wrapper, or a chain (a list, tuple or dict of states) holding one;
    (None, None) when there is none."""
    fields = _fields(node)
    if fields is not None and _PER_TENSOR <= set(fields):   # a fused one adds p_flat
        return fields, None
    if fields is not None and _INJECT <= set(fields):
        inner, _ = find_opt_state(fields["inner_state"])
        return (inner, fields) if inner is not None else (None, None)
    children = (list(fields.values()) if fields is not None
                else list(node) if isinstance(node, (list, tuple)) else [])
    for child in children:
        found = find_opt_state(child)
        if found[0] is not None:
            return found
    return None, None


def convert(jax_ckpt, out) -> Path:
    """Write the port checkpoint of the JAX checkpoint ``jax_ckpt`` to
    ``out``; returns ``out``."""
    raw, meta = load_checkpoint(jax_ckpt)
    raw = jax.device_get(raw)
    params, stats = raw["params"], raw.get("batch_stats", {})
    state_dict = from_jax(params, stats)
    hparams = dict(meta.get("hparams", {}))
    hparams.setdefault("encoder", "quartznet12_context")
    hparams.setdefault("mask", True)
    hparams.setdefault("compute_dtype", "float32")
    labels = hparams.get("labels") or AsrTranslator.EN_LABELS
    model = build_model(Vocabulary(list(labels)).num_classes, hparams["encoder"],
                        in_c=hparams.get("in_c", 64), mask=bool(hparams["mask"]),
                        feature_in=hparams.get("feature_in"))
    model.load_state_dict(state_dict, strict=True)           # every key, every shape

    train_state = None
    found, wrapper = find_opt_state(raw.get("opt_state"))
    if found is not None:
        # the port's flat layout follows the model's parameter order, as
        # create_train_state gives it
        port_params = {k: p.detach() for k, p in model.named_parameters()}
        opt_state = opt_state_from_jax(found, params, stats, port_params)
        if wrapper is not None:
            hyper = {k: torch.tensor(np.asarray(v), dtype=torch.float32)
                     for k, v in _fields(wrapper["hyperparams"]).items()}
            opt_state = InjectHyperparamsState(
                torch.tensor(int(np.asarray(wrapper["count"])), dtype=torch.int32), hyper, opt_state)
        train_state = {"step": torch.tensor(int(np.asarray(raw["step"])), dtype=torch.int32),
                       "nan_count": torch.tensor(int(np.asarray(raw.get("nan_count", 0))),
                                                 dtype=torch.int32),
                       "opt_state": opt_state}
    metadata = {k: v for k, v in meta.items() if k != "hparams"}
    return save_checkpoint(out, state_dict, hparams, metadata, train_state)


def main(argv=None) -> Path:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--jax-ckpt", required=True, help="the JAX package's checkpoint directory")
    ap.add_argument("--out", required=True, help="output checkpoint directory of the port")
    args = ap.parse_args(argv)
    out = convert(args.jax_ckpt, args.out)
    print(f"wrote {out}")
    return out


if __name__ == "__main__":
    main()
