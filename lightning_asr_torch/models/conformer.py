"""Conformer-CTC's encoder (Gulati et al., arXiv:2005.08100), at the sizes
of NVIDIA NeMo's ``conformer_ctc_bpe.yaml`` ("Large": d_model 512, 18
layers, 8 heads, feed-forward 2048, conv kernel 31, striding x4 at 512
channels), the port's own encoder: the JAX package has none.

  * ``pre_encode`` (NeMo's "striding" ``ConvSubsampling``): the features
    (B, T, F) as one input channel, two Conv2d k3 stride 2 padding 1 each
    followed by ReLU, then the (channels x F'') frame flattened and a
    Linear to d_model; T' = ceil(ceil(T / 2) / 2), F'' likewise of F.
  * the frames times sqrt(d_model) (xscaling), and ``pos_enc``'s relative
    sinusoidal table (positions max_len - 1 down to -(max_len - 1), sin in
    the even channels, cos in the odd; a buffer that each call slices to
    the 2T' - 1 positions T' - 1 ... -(T' - 1); not in the state_dict).
  * each ``ConformerLayer``: x += FFN(LN(x)) / 2; x += MHSA(LN(x)); x +=
    Conv(LN(x)); x += FFN(LN(x)) / 2; x = LN(x).  FFN: Linear d -> ff,
    Swish, Linear ff -> d.  MHSA: Transformer-XL relative attention (NeMo's
    ``RelPositionMultiHeadAttention``) with per-layer ``pos_bias_u`` and
    ``pos_bias_v`` (H, d_k), a bias-free ``linear_pos`` on the table:
    scores (q + u) k^T + rel_shift((q + v) p^T), over sqrt(d_k).  Conv:
    pointwise d -> 2d, GLU, pad frames zeroed, depthwise k (groups d, with
    bias), BatchNorm (eps 1e-5), Swish, pointwise d -> d.
  * pad frames, from each row's int(float32(T') * percent) valid frames:
    a pad key gets -10000 in the scores (NeMo's), a pad query's attention
    output is 0 before ``linear_out`` (NeMo zeroes the weights of a masked
    row), and pad frames are zeroed before the depthwise conv; BatchNorm's
    statistics take every frame, as NeMo's ``BatchNorm1d`` does.

Compute policy (the QuartzNets'): with a compute ``dtype`` (bf16) the
Linear and conv GEMMs, the scores' position term and the attention core
run in it, on float32 parameters; LayerNorm and BatchNorm compute in
float32 and cast back, so the residual stream, every sum included,
stays in the compute dtype (under NeMo's bf16 autocast LayerNorm returns
float32, and every residual sum after the first layer is float32: a
departure the benchmark's configuration lists); the decoder and the loss
(``AsrModel``) are float32.

The attention core is ``F.scaled_dot_product_attention`` with the scaled,
masked position term as its additive float mask (NeMo's
``use_pytorch_sdpa`` path).  Its backend set is forced: on the card the
memory-efficient kernel alone (it takes a float mask and gives its
gradient; a call it cannot take raises instead of falling back to the
math kernel), on the CPU the math kernel.  The memory-efficient kernel's
backward sums a query's gradient over blocks of keys in no fixed order
unless ``torch.use_deterministic_algorithms(True)`` is on: two eager steps
may then differ in the last bits.  Each forward call counts its
set in ``training/profiler.py``'s counter ``conformer.attention.backend``
(``cuda/efficient``, ``cpu/math``), once a call: a replayed CUDA graph
runs no Python and counts nothing.  The subsampling and the layers are
the spans ``subsampling`` and ``conformer``.

``drop_rate`` drops out, from the step's generator, the subsampling's
output and each residual branch's (NeMo's ``dropout`` and
``dropout_pre_encoder``); NeMo's dropout of the attention weights and of
the position table is not done.  Module names are NeMo's
(``pre_encode.conv.0``, ``layers.3.self_attn.linear_q``, ...).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.attention import SDPBackend, sdpa_kernel

from ..training.profiler import count, span
from .activations import swish
from .layers import (Conv, Conv2d, LayerNorm, Linear, MaskedBatchNorm, _lengths_from_percents,
                     dropout)

NAME = "conformer_ctc_large"
ATTENTION_COUNTER = "conformer.attention.backend"
MASK_VALUE = -10000.0                 # a pad key's score (NeMo's INF_VAL)
# device type -> (the SDPA backends the attention may use, its counter key)
_BACKENDS = {"cuda": ([SDPBackend.EFFICIENT_ATTENTION], "cuda/efficient"),
             "cpu": ([SDPBackend.MATH], "cpu/math")}


def subsampled(n: int) -> int:
    """Frames (or bins) after the two stride-2 k3 pad-1 convs."""
    return (((n - 1) // 2) // 2) + 1


def rel_shift(x: torch.Tensor) -> torch.Tensor:
    """(B, H, T, 2T - 1) scores against positions T - 1 ... -(T - 1) ->
    (B, H, T, 2T - 1) whose [i, j] for j < T holds position i - j (NeMo's
    ``rel_shift``: pad one column on the left, read the buffer as (2T, T),
    drop its first row)."""
    b, h, t, p = x.shape
    x = F.pad(x, (1, 0)).view(b, h, p + 1, t)
    return x[:, :, 1:].reshape(b, h, t, p)


def position_table(max_len: int, d_model: int) -> torch.Tensor:
    """(2 max_len - 1, d_model) float32: row i is position max_len - 1 - i;
    sin(pos w_k) in channel 2k, cos in 2k + 1, w_k = 10000^(-2k / d)."""
    pos = torch.arange(max_len - 1, -max_len, -1, dtype=torch.float32)[:, None]
    div = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32)
                    * -(math.log(10000.0) / d_model))
    pe = torch.zeros(pos.shape[0], d_model)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


class ConvSubsampling(nn.Module):
    """NeMo's "striding" subsampling x4: (B, T, F) -> (B, T', d_model)."""

    def __init__(self, in_feats: int, channels: int, d_model: int,
                 dtype: Optional[torch.dtype]):
        super().__init__()
        self.conv = nn.ModuleList([Conv2d(1, channels, 3, 2, 1, dtype), nn.ReLU(),
                                   Conv2d(channels, channels, 3, 2, 1, dtype), nn.ReLU()])
        self.out = Linear(channels * subsampled(in_feats), d_model, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.unsqueeze(1)
        for m in self.conv:
            x = m(x)
        b, c, t, f = x.shape
        return self.out(x.transpose(1, 2).reshape(b, t, c * f))


class RelPositionalEncoding(nn.Module):
    """The relative position table (``position_table``), sliced per call."""

    def __init__(self, d_model: int, max_len: int = 5000):
        super().__init__()
        self.max_len = max_len
        self.register_buffer("pe", position_table(max_len, d_model), persistent=False)

    def forward(self, t: int) -> torch.Tensor:
        if t > self.max_len:
            raise ValueError(f"{t} frames past the position table's {self.max_len}")
        return self.pe[self.max_len - t: self.max_len + t - 1]


class FeedForward(nn.Module):
    def __init__(self, d_model: int, d_ff: int, dtype: Optional[torch.dtype]):
        super().__init__()
        self.linear1 = Linear(d_model, d_ff, dtype=dtype)
        self.linear2 = Linear(d_ff, d_model, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear2(swish(self.linear1(x)))


class RelPositionAttention(nn.Module):
    """Transformer-XL relative multi-head self-attention (the module
    docstring) on (B, T, d)."""

    def __init__(self, d_model: int, heads: int, dtype: Optional[torch.dtype]):
        super().__init__()
        self.h, self.d_k = heads, d_model // heads
        for name in ("linear_q", "linear_k", "linear_v", "linear_out"):
            self.add_module(name, Linear(d_model, d_model, dtype=dtype))
        self.linear_pos = Linear(d_model, d_model, bias=False, dtype=dtype)
        self.pos_bias_u = nn.Parameter(torch.zeros(heads, self.d_k))
        self.pos_bias_v = nn.Parameter(torch.zeros(heads, self.d_k))
        self.dtype = dtype

    def reset_parameters(self, generator: torch.Generator) -> None:
        """NeMo's zeros for u and v (the Linears draw their own)."""
        with torch.no_grad():
            self.pos_bias_u.zero_()
            self.pos_bias_v.zero_()

    def forward(self, x: torch.Tensor, pos: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        dt = self.dtype or x.dtype
        q = self.linear_q(x).view(b, t, self.h, self.d_k)
        k = self.linear_k(x).view(b, t, self.h, self.d_k).transpose(1, 2)
        v = self.linear_v(x).view(b, t, self.h, self.d_k).transpose(1, 2)
        p = self.linear_pos(pos).view(-1, self.h, self.d_k).transpose(0, 1)
        q_u = (q + self.pos_bias_u.to(dt)).transpose(1, 2)
        q_v = (q + self.pos_bias_v.to(dt)).transpose(1, 2)
        bd = rel_shift(torch.matmul(q_v, p.transpose(-2, -1)))[..., :t]
        bias = (bd * (1.0 / math.sqrt(self.d_k))).masked_fill(~keep[:, None, None, :],
                                                              MASK_VALUE)
        with sdpa_kernel(_BACKENDS[x.device.type][0]):
            out = F.scaled_dot_product_attention(q_u, k, v, attn_mask=bias)
        out = out * keep[:, None, :, None].to(out.dtype)
        return self.linear_out(out.transpose(1, 2).reshape(b, t, d))


class ConformerConvolution(nn.Module):
    """Pointwise d -> 2d, GLU, pad frames zeroed, depthwise k, BatchNorm,
    Swish, pointwise d -> d, on (B, d, T)."""

    def __init__(self, d_model: int, k: int, dtype: Optional[torch.dtype]):
        super().__init__()
        self.pointwise_conv1 = Conv(d_model, 2 * d_model, 1, bias=True, dtype=dtype)
        self.depthwise_conv = Conv(d_model, d_model, k, padding=(k - 1) // 2, groups=d_model,
                                   bias=True, dtype=dtype)
        self.batch_norm = MaskedBatchNorm(d_model, eps=1e-5)
        self.pointwise_conv2 = Conv(d_model, d_model, 1, bias=True, dtype=dtype)

    def forward(self, x: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
        x = F.glu(self.pointwise_conv1(x), dim=1) * keep[:, None, :].to(x.dtype)
        return self.pointwise_conv2(swish(self.batch_norm(self.depthwise_conv(x))))


class ConformerLayer(nn.Module):
    def __init__(self, d_model: int, heads: int, d_ff: int, k: int,
                 dtype: Optional[torch.dtype], drop_rate: float):
        super().__init__()
        self.drop_rate = drop_rate
        for name in ("norm_feed_forward1", "norm_self_att", "norm_conv", "norm_feed_forward2",
                     "norm_out"):
            self.add_module(name, LayerNorm(d_model))
        self.feed_forward1 = FeedForward(d_model, d_ff, dtype)
        self.self_attn = RelPositionAttention(d_model, heads, dtype)
        self.conv = ConformerConvolution(d_model, k, dtype)
        self.feed_forward2 = FeedForward(d_model, d_ff, dtype)

    def forward(self, x: torch.Tensor, pos: torch.Tensor, keep: torch.Tensor,
                generator: Optional[torch.Generator]) -> torch.Tensor:
        def drop(y):
            return dropout(y, self.drop_rate, generator) if self.training else y

        x = x + 0.5 * drop(self.feed_forward1(self.norm_feed_forward1(x)))
        x = x + drop(self.self_attn(self.norm_self_att(x), pos, keep))
        x = x + drop(self.conv(self.norm_conv(x).transpose(1, 2), keep).transpose(1, 2))
        x = x + 0.5 * drop(self.feed_forward2(self.norm_feed_forward2(x)))
        return self.norm_out(x)


class ConformerEncoder(nn.Module):
    """(B, F, T) features -> (B, d_model, T'), T' = ceil(ceil(T / 2) / 2).
    The defaults are Conformer-CTC Large's; ``mask`` False treats every
    frame as valid."""

    name = NAME
    in_c = 80                          # the features it is published for
    tensor_parallel = False            # no layout of model groups (parallel/tp.py)

    def __init__(self, in_c: int = 80, mask: bool = True, drop_rate: float = 0.0,
                 dtype: Optional[torch.dtype] = None, conv_kernel: Optional[str] = None,
                 d_model: int = 512, layers: int = 18, heads: int = 8, d_ff: int = 2048,
                 kernel: int = 31, subsampling_channels: int = 512, max_len: int = 5000):
        super().__init__()
        if conv_kernel is not None:
            raise ValueError(f"{NAME}: conv_kernel={conv_kernel!r} routes the QuartzNets' "
                             "separable convs; the Conformer has none")
        self.mask, self.drop_rate, self.out_ch = mask, drop_rate, d_model
        self.xscale = math.sqrt(d_model)
        self.pre_encode = ConvSubsampling(in_c, subsampling_channels, d_model, dtype)
        self.pos_enc = RelPositionalEncoding(d_model, max_len)
        self.layers = nn.ModuleList([ConformerLayer(d_model, heads, d_ff, kernel, dtype,
                                                    drop_rate) for _ in range(layers)])

    def forward(self, x: torch.Tensor, percents: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        with span("subsampling"):
            x = self.pre_encode(x.transpose(1, 2)) * self.xscale
            if self.training:
                x = dropout(x, self.drop_rate, generator)
            t = x.shape[1]
            pos = self.pos_enc(t)
            frames = torch.arange(t, device=x.device)[None, :]
            lengths = _lengths_from_percents(t, percents) if self.mask else \
                torch.full_like(percents, t, dtype=torch.int32)
            keep = frames < lengths[:, None]
        count(ATTENTION_COUNTER, _BACKENDS[x.device.type][1])
        with span("conformer"):
            for layer in self.layers:
                x = layer(x, pos, keep, generator)
        return x.transpose(1, 2)
