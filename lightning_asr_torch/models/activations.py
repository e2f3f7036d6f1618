"""Swish and Mish beside ReLU, selectable by name (port of
``lightning_asr_tpu/models/activations.py``; the reference's
``activate_fun/Swish.py``, imported by its model files but unused: ReLU is
the default throughout)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def swish(x: torch.Tensor) -> torch.Tensor:
    """x · sigmoid(x) (SiLU)."""
    return x * torch.sigmoid(x)


def mish(x: torch.Tensor) -> torch.Tensor:
    """x · tanh(softplus(x))."""
    return x * torch.tanh(F.softplus(x))


ACTIVATIONS = {"relu": F.relu, "swish": swish, "mish": mish}


def get_activation(name: str):
    if name not in ACTIVATIONS:
        raise ValueError(f"unknown activation {name!r}; choose from {sorted(ACTIVATIONS)}")
    return ACTIVATIONS[name]
