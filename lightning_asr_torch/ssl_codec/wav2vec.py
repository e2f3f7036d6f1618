"""The wav2vec2 convolutional feature encoder as a trainable module (port of
``lightning_asr_tpu/ssl_codec/wav2vec_flax.py``), for the SSL retrain mode.

It is the part of HuggingFace's ``Wav2Vec2Model`` that the reference
consumes when it retrains the extractor: 7 convolutions over the raw wave,
(B, S) -> (B, T', 512) at a 20 ms frame rate.

  * strides (5, 2, 2, 2, 2, 2, 2), kernels (10, 3, 3, 3, 3, 2, 2), no
    padding, as HF's ``Wav2Vec2FeatureEncoder``;
  * "layer" (wav2vec2-large, xlsr-53): conv (+ bias) -> LayerNorm over the
    channels -> GELU on every layer;
  * "group" (wav2vec2-base): conv -> GroupNorm(512 groups, one a channel,
    over time) -> GELU on layer 0, conv -> GELU after it;
  * exact GELU, eps 1e-5.

The convs run as ``F.conv1d``: the JAX package computes them outside any
Pallas kernel.  The waves are cast to float32 as they are, as flax promotes
an int16 wire: no scaling to [-1, 1] (ROADMAP C16).  Fresh convs draw
flax's default initializer (lecun-normal kernel, zero bias).  Weights come
from a HuggingFace state_dict through ``convert_hf_feature_encoder``, whose
conv layout (out, in, k) is the port's.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..models.layers import Conv

CONV_STRIDE = (5, 2, 2, 2, 2, 2, 2)
CONV_KERNEL = (10, 3, 3, 3, 3, 2, 2)
NORMS = ("group", "layer")


class _LecunConv(Conv):
    """A conv that flax's ``nn.Conv`` defaults initialize: a truncated
    normal kernel of std 1/sqrt(fan_in) (cut at two of its deviations) and
    a zero bias."""

    def reset_parameters(self, generator: torch.Generator) -> None:
        std = 1.0 / math.sqrt(self.weight.shape[1] * self.weight.shape[2]) / 0.87962566103423978
        w = torch.empty(self.weight.shape)
        nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
        with torch.no_grad():
            self.weight.copy_(w)
            if self.bias is not None:
                self.bias.zero_()


def output_lengths(input_lengths, conv_stride: Sequence[int] = CONV_STRIDE,
                   conv_kernel: Sequence[int] = CONV_KERNEL):
    """Valid output frames for sample counts (an int, numpy array or
    tensor): HF's formula, ``(n - k) // s + 1`` a layer."""
    lens = input_lengths
    for k, s in zip(conv_kernel, conv_stride):
        lens = (lens - k) // s + 1
    return lens


class Wav2Vec2FeatureEncoder(nn.Module):
    """(B, S) waves -> (B, T', 512) features; submodules ``conv0``..``conv6``
    and ``ln0``..``ln6`` ("layer") or ``gn0`` ("group"), the flax names."""

    def __init__(self, feat_extract_norm: str = "group", conv_bias: bool = False,
                 conv_dim: Sequence[int] = (512,) * 7, conv_stride: Sequence[int] = CONV_STRIDE,
                 conv_kernel: Sequence[int] = CONV_KERNEL):
        super().__init__()
        if feat_extract_norm not in NORMS:
            raise ValueError(f"feat_extract_norm must be one of {NORMS}, got {feat_extract_norm!r}")
        self.norm = feat_extract_norm
        self.n_layers = len(conv_dim)
        in_ch = 1
        for i, (dim, stride, k) in enumerate(zip(conv_dim, conv_stride, conv_kernel)):
            self.add_module(f"conv{i}", _LecunConv(in_ch, dim, k, stride=stride, bias=conv_bias))
            if feat_extract_norm == "layer":
                self.add_module(f"ln{i}", nn.LayerNorm(dim, eps=1e-5))
            elif i == 0:
                self.gn0 = nn.GroupNorm(dim, dim, eps=1e-5)
            in_ch = dim

    def forward(self, waves: torch.Tensor) -> torch.Tensor:
        x = waves.to(torch.float32)[:, None, :]                  # (B, 1, S)
        for i in range(self.n_layers):
            x = getattr(self, f"conv{i}")(x)                      # (B, C, T)
            if self.norm == "layer":
                ln = getattr(self, f"ln{i}")
                x = F.layer_norm(x.transpose(1, 2), ln.normalized_shape, ln.weight, ln.bias,
                                 ln.eps).transpose(1, 2)
            elif i == 0:
                x = self.gn0(x)
            x = F.gelu(x)
        return x.transpose(1, 2)


def convert_hf_feature_encoder(state_dict, norm: str = "group",
                               prefix: str = "") -> Dict[str, torch.Tensor]:
    """A HuggingFace ``Wav2Vec2FeatureEncoder`` state_dict (keys
    ``conv_layers.{i}.conv.weight`` ...) -> the state_dict of a
    ``Wav2Vec2FeatureEncoder`` with that ``norm`` (float32 copies).
    ``prefix`` picks and strips, e.g., ``'wav2vec2.feature_extractor.'``."""
    out: Dict[str, torch.Tensor] = {}
    for key, value in state_dict.items():
        if prefix:
            if not key.startswith(prefix):
                continue
            key = key[len(prefix):]
        parts = key.split(".")
        if parts[0] != "conv_layers":
            continue
        i, mod, leaf = int(parts[1]), parts[2], parts[3]
        value = torch.as_tensor(value).detach().to("cpu", torch.float32).clone()
        if mod == "conv":
            out[f"conv{i}.{leaf}"] = value
        elif mod == "layer_norm":
            out[f"{'gn0' if norm == 'group' else f'ln{i}'}.{leaf}"] = value
    return out
