"""Model analysis: parameter counts and forward FLOPs (port of
``lightning_asr_tpu/models/analysis.py``; the reference's ptflops report).

The JAX package takes its FLOPs from XLA's cost analysis of the compiled
forward; the port counts them with ``torch.utils.flop_counter.
FlopCounterMode``, which counts the matrix products and convolutions (two
operations a multiply-add) and not the elementwise work that XLA also
counts.  Parameter counts and their breakdown use the flax tree's names
(``utils/jax_params.py``), so both packages give the same keys.

    python -m lightning_asr_torch.models.analysis
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..utils.jax_params import to_jax


def count_params(model: nn.Module) -> int:
    """Trainable parameters (BatchNorm statistics are not parameters)."""
    return sum(p.numel() for p in model.parameters())


def param_breakdown(model: nn.Module, depth: int = 1) -> Dict[str, int]:
    """Parameter counts grouped by the first ``depth`` components of the
    flax tree's paths, largest first."""
    params, _ = to_jax(model.state_dict())          # BatchNorm statistics apart
    out: Dict[str, int] = {}

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                key = "/".join((path + (k,))[:depth])
                out[key] = out.get(key, 0) + int(v.size)

    walk(params, ())
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def flops_estimate(model: nn.Module, feature_shape=(1, 1024, 64)) -> Optional[float]:
    """Forward FLOPs of ``model`` in eval mode on zero features of
    ``feature_shape`` (B, T, C), from ``FlopCounterMode`` on the model's
    device (None if the counter fails)."""
    from torch.utils.flop_counter import FlopCounterMode

    dev = next(model.parameters()).device
    x = torch.zeros(feature_shape, dtype=torch.float32, device=dev)
    percents = torch.ones((feature_shape[0],), dtype=torch.float32, device=dev)
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad(), FlopCounterMode(display=False) as counter:
            model(x, percents)
        return float(counter.get_total_flops())
    except Exception:
        return None
    finally:
        model.train(was_training)


def summarize(model: nn.Module, feature_shape=(1, 1024, 64)) -> str:
    lines = [f"params: {count_params(model) / 1e6:.2f} M"]
    flops = flops_estimate(model, feature_shape)
    if flops:
        lines.append(f"forward flops @ {feature_shape}: {flops / 1e9:.2f} G")
    for k, v in param_breakdown(model, depth=2).items():
        lines.append(f"  {k:<40} {v / 1e6:8.3f} M")
    return "\n".join(lines)


if __name__ == "__main__":
    from .quartznet import build_model

    print(summarize(build_model(num_classes=29, mask=True).to("cpu")))
