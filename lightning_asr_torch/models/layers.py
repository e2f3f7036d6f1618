"""Building blocks of the QuartzNet encoders (port of
``lightning_asr_tpu/models/layers.py``), eval and train paths, and the
Conformer's holders (``Conv2d``, ``Linear``, ``LayerNorm``: the port's own,
``models/conformer.py``).

Modules take and return NCT tensors (B, C, T), the layout of ``F.conv1d``;
the model's public functions keep the JAX package's (B, T, C).

  * ``SepConv`` = depthwise conv -> pointwise conv -> [length mask] ->
    BatchNorm -> ReLU (skipped when ``last``) -> dropout.  The mask runs
    BEFORE BatchNorm, so batch statistics see the zeroed pad frames.
  * masking recovers frame counts as ``int(float32(T) · percents)``,
    truncated in float32, at every application point.
  * ``MaskedBatchNorm`` eval: ``inv = rsqrt(var + 1e-3) · scale`` in fp32,
    then ``mean``, ``inv`` and ``bias`` are cast to the activation dtype.
    Train mode takes the mean and the biased variance in fp32 over all B·T
    frames instead and updates the running statistics (momentum 0.1, the
    variance scaled by n/(n-1)) in place, without gradient; the same cast
    order follows.  ``F.batch_norm`` is not used: it computes in the input
    dtype.  Inside a data-parallel step (``parallel/mesh.py::row_shard``)
    the statistics are the global batch's, as the JAX SPMD step takes them
    over its sharded batch (PARITY.md deviation 3): every rank holds the
    same number of rows, so the mean is the all-reduced sum of the ranks'
    means over W, and the variance likewise of their mean squared
    deviations from that global mean (the same two passes; with W = 1 the
    same bits); n counts the global frames; the gradient flows through both
    all-reduces.
  * dropout (``drop_rate`` > 0, train mode only) draws its keep mask from
    the ``torch.Generator`` passed down the forward call, as flax's
    ``nn.Dropout`` draws from the ``dropout`` rng: ``x / keep`` where
    ``U < keep``, else 0 (in a data-parallel step, this rank's rows of the
    global batch's draw).
  * with a compute ``dtype`` (bf16), convs take bf16 input and weights and
    give bf16 output; parameters stay float32.
  * ``SepConvSE`` adds a squeeze-excite stage (``SELayer``) after the
    BatchNorm: the mean over the whole padded time axis in float32, rounded
    to the activation type, then two bias-free ``Dense`` layers with float32
    weights.  As in the JAX package the float32 weights promote: with bf16
    activations the block returns float32, and the next conv casts back.
  * ``conv_kernel`` picks what runs the separable convs of an eligible
    ``SepConv`` (stride 1, odd k; the JAX package's rule, so the stride-2
    stem keeps ``F.conv1d``): None the ``F.conv1d`` pair (JAX's default);
    ``"sepconv"`` the fused kernels K9/K10 (``LASR_SEPCONV_PALLAS=1``), with
    float32 weight gradients; ``"dw_wgrad"`` ``F.conv1d`` with K11 as the
    depthwise weight gradient (``LASR_DW_WGRAD_PALLAS=1``), the weight cast
    to the compute type before it, as JAX does.  The parameters are the same
    in every case.  ``SepConvSE`` has no route: the JAX package's always
    runs ``nn.Conv``.
  * inside ``parallel/tp.py::model_parallel`` (tensor parallelism) a module
    runs on this rank's channel block of the trunk (that module's
    docstring): the depthwise conv on its input block (``groups`` follows
    the block's width), the pointwise and residual convs on the gathered
    input for this rank's output rows, BatchNorm on its block with the
    statistics of the data group's rows, SE's Dense layers on the gathered
    squeeze, dropout on this rank's block of the draw for every channel.
    With ``conv_kernel="sepconv"`` K9/K10 take the gathered input and
    depthwise weight with this rank's pointwise rows.  Outside the scope
    every module runs as described above, bit for bit.

Parameters are created as zeros (BatchNorm scale and variance as ones);
weights come from a checkpoint or from ``reset_parameters(generator)``,
which draws torch's default U(±1/sqrt(fan_in)) as the JAX package does.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.depthwise_kernels import depthwise_conv
from ..ops.lstm import LSTMWeights, lstm
from ..ops.sepconv_kernels import sepconv
from ..parallel import tp
from ..parallel.distributed import all_reduce_sum
from ..parallel.mesh import current_shard, draw

CONV_KERNELS = (None, "sepconv", "dw_wgrad")


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
            channels: Optional[int] = None) -> torch.Tensor:
    """flax ``nn.Dropout`` in train mode: keep with probability 1 - rate and
    scale the kept values by 1 / (1 - rate); the identity at rate 0.  On a
    trunk activation of ``channels`` channels split over a model group the
    draw is made for every channel and this rank keeps its block."""
    if rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in train mode needs a torch.Generator")
    keep = 1.0 - rate
    if channels is None:
        u = draw(x.shape, generator, x.device)
    else:
        u = tp.own_block(draw((x.shape[0], channels, *x.shape[2:]), generator, x.device))
    return torch.where(u < keep, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def _uniform_(t: torch.Tensor, bound: float, generator: torch.Generator) -> None:
    with torch.no_grad():
        t.copy_(torch.rand(t.shape, generator=generator, dtype=t.dtype) * (2 * bound) - bound)


def _lengths_from_percents(T: int, percents: torch.Tensor) -> torch.Tensor:
    """The reference's ``(T * percents).int()`` recovery, in float32."""
    t = torch.full((), T, dtype=torch.float32, device=percents.device)
    return (t * percents.to(torch.float32)).to(torch.int32)


def mask_by_percents(x: torch.Tensor, percents: torch.Tensor) -> torch.Tensor:
    """Zero frames >= int(T * percent). x: (B, C, T)."""
    T = x.shape[-1]
    lengths = _lengths_from_percents(T, percents)
    keep = torch.arange(T, device=x.device)[None, :] < lengths[:, None]
    return x * keep[:, None, :].to(x.dtype)


class Conv(nn.Module):
    """1-D convolution weight (out, in/groups, k) [+ bias], run in a compute
    dtype; the holder the weight bridge maps flax ``kernel``/``bias`` onto."""

    def __init__(self, in_ch: int, out_ch: int, k: int = 1, stride: int = 1,
                 padding: int = 0, groups: int = 1, bias: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(out_ch, in_ch // groups, k))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None
        self.in_ch, self.out_ch = in_ch, out_ch
        self.stride, self.padding, self.groups, self.dtype = stride, padding, groups, dtype

    def reset_parameters(self, generator: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.weight.shape[1] * self.weight.shape[2])
        _uniform_(self.weight, bound, generator)
        if self.bias is not None:
            _uniform_(self.bias, bound, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or x.dtype
        bias = None if self.bias is None else self.bias.to(dt)
        # a depthwise conv on a channel block (tensor parallelism) has as
        # many groups as the block has channels
        groups = self.groups if self.groups == 1 else x.shape[1] // self.weight.shape[1]
        return F.conv1d(x.to(dt), self.weight.to(dt), bias, self.stride,
                        self.padding, 1, groups)


class Conv2d(nn.Module):
    """2-D convolution weight (out, in, kh, kw) + bias, run in a compute
    dtype as ``Conv`` runs its 1-D one (the Conformer's subsampling)."""

    def __init__(self, in_ch: int, out_ch: int, k: int, stride: int = 1, padding: int = 0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(out_ch, in_ch, k, k))
        self.bias = nn.Parameter(torch.zeros(out_ch))
        self.stride, self.padding, self.dtype = stride, padding, dtype

    def reset_parameters(self, generator: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.weight[0].numel())
        _uniform_(self.weight, bound, generator)
        _uniform_(self.bias, bound, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or x.dtype
        return F.conv2d(x.to(dt), self.weight.to(dt), self.bias.to(dt), self.stride, self.padding)


class Linear(nn.Module):
    """``torch.nn.Linear``'s weight (out, in) [+ bias] on the last axis, run
    in a compute dtype (bf16 GEMMs; the parameters stay float32), drawn
    U(±1/sqrt(in)).  Unlike ``Dense`` its bits may depend on the row count
    (a library GEMM)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None
        self.dtype = dtype

    def reset_parameters(self, generator: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.weight.shape[1])
        _uniform_(self.weight, bound, generator)
        if self.bias is not None:
            _uniform_(self.bias, bound, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or x.dtype
        return F.linear(x.to(dt), self.weight.to(dt), None if self.bias is None
                        else self.bias.to(dt))


class LayerNorm(nn.Module):
    """LayerNorm over the last axis, computed in float32 and cast back to
    the input's dtype; scale and shift float32, ones and zeros."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.weight.shape, self.weight, self.bias,
                            self.eps).to(x.dtype)


class MaskedBatchNorm(nn.Module):
    """torch.nn.BatchNorm1d semantics over (B, C, T), eps 1e-3, momentum
    0.1, with the JAX package's cast order."""

    MOMENTUM = 0.1

    def __init__(self, features: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        if self.training:
            xf = x.to(torch.float32)
            n = x.shape[0] * x.shape[2]
            shard = current_shard()
            if shard is None:
                mean = torch.mean(xf, dim=(0, 2))
                var = torch.mean((xf - mean[:, None]) ** 2, dim=(0, 2))  # biased, for normalizing
            else:                                   # the global batch's (module docstring)
                mean = all_reduce_sum(torch.mean(xf, dim=(0, 2)), "data") / shard.world
                var = all_reduce_sum(torch.mean((xf - mean[:, None]) ** 2, dim=(0, 2)),
                                     "data") / shard.world
                n *= shard.world
            with torch.no_grad():
                unbiased = var * (n / max(n - 1, 1))
                m = self.MOMENTUM
                self.running_mean.copy_((1 - m) * self.running_mean + m * mean)
                self.running_var.copy_((1 - m) * self.running_var + m * unbiased)
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean.to(dt)[:, None]) * inv.to(dt)[:, None] + self.bias.to(dt)[:, None]


class SepConv(nn.Module):
    """Time-channel separable conv block (``layers.py::SepConv``)."""

    def __init__(self, in_ch: int, out_ch: int, k: int = 33, last: bool = False,
                 mask: bool = True, stride: int = 1, drop_rate: float = 0.1,
                 dtype: Optional[torch.dtype] = None, conv_kernel: Optional[str] = None):
        super().__init__()
        if conv_kernel not in CONV_KERNELS:
            raise ValueError(f"conv_kernel must be one of {CONV_KERNELS}, got {conv_kernel!r}")
        self.last, self.mask, self.drop_rate = last, mask, drop_rate
        self.in_ch, self.out_ch = in_ch, out_ch
        self.conv_kernel = conv_kernel if stride == 1 and k % 2 == 1 else None
        self.depthwise_conv = Conv(in_ch, in_ch, k, stride=stride, padding=k // 2,
                                   groups=in_ch, dtype=dtype)
        self.pointwise_conv = Conv(in_ch, out_ch, 1, dtype=dtype)
        self.bn = MaskedBatchNorm(out_ch)

    def forward(self, x: torch.Tensor, percents: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        dt = self.depthwise_conv.dtype or x.dtype
        cin, cout = self.in_ch, self.out_ch
        if self.conv_kernel == "sepconv":       # whole input and depthwise weight, own rows
            xs = tp.column_input(tp.full(x.to(dt), cin), cout)
            wd = tp.column_input(tp.full(self.depthwise_conv.weight, cin, dim=0), cout)
            x = sepconv(xs.contiguous(), wd, self.pointwise_conv.weight)
        elif self.conv_kernel == "dw_wgrad":
            x = depthwise_conv(x.to(dt).contiguous(), self.depthwise_conv.weight.to(dt))
            x = self.pointwise_conv(tp.column_input(tp.full(x, cin), cout))
        else:
            x = self.pointwise_conv(tp.column_input(tp.full(self.depthwise_conv(x), cin), cout))
        if self.mask:
            x = mask_by_percents(x, percents)
        x = self.excite(self.bn(x))
        if not self.last:
            x = F.relu(x)
        return dropout(x, self.drop_rate, generator, cout) if self.training else x

    def excite(self, x: torch.Tensor) -> torch.Tensor:
        """The stage between BN and ReLU: none here, squeeze-excite in
        ``SepConvSE``."""
        return x


class Dense(nn.Module):
    """Linear layer on the last axis, ``weight`` (out, in) [+ ``bias``] in
    float32: flax's ``nn.Dense``, whose ``kernel`` is (in, out); bias-free
    unless ``bias``, both drawn U(±1/sqrt(in)).  Each output is a product
    summed over the last axis, whose bits do not depend on the row count:
    ``F.linear`` (and a batched matmul, on the card) picks another kernel
    for 1 row than for 8, so a row's bits would depend on its batch, and in
    bf16 a stream (one row a window) would not equal ``translate_long`` (8
    rows; ROADMAP C13)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.weight.shape[1])
        _uniform_(self.weight, bound, generator)
        if self.bias is not None:
            _uniform_(self.bias, bound, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = (x.float().unsqueeze(-2) * self.weight).sum(dim=-1)
        return y if self.bias is None else y + self.bias


class SELayer(nn.Module):
    """Squeeze-excite (``layers.py::SELayer``) on (B, C, T): the mean over
    every frame, padding included, then fc1 (C -> C/r), ReLU, fc2, sigmoid
    and a rescale of the channels.  Returns float32 (see the module
    docstring)."""

    def __init__(self, channels: int, reduction: int = 8):
        super().__init__()
        self.channels = channels
        self.fc1 = Dense(channels, channels // reduction)
        self.fc2 = Dense(channels // reduction, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        squeezed = x.float().mean(dim=2).to(x.dtype)     # jnp.mean: float32 sum, input type
        squeezed = tp.full(squeezed, self.channels)       # the Dense layers read every channel
        y = tp.own(torch.sigmoid(self.fc2(F.relu(self.fc1(squeezed)))))
        return x * y[:, :, None]


class SepConvSE(SepConv):
    """SepConv with the squeeze-excite stage after BN, before the ReLU
    (``layers.py::SepConvSE``); always the ``F.conv1d`` pair."""

    def __init__(self, in_ch: int, out_ch: int, k: int = 33, last: bool = False,
                 mask: bool = True, stride: int = 1, drop_rate: float = 0.1,
                 dtype: Optional[torch.dtype] = None, reduction: int = 8):
        super().__init__(in_ch, out_ch, k, last, mask, stride, drop_rate, dtype)
        self.se = SELayer(out_ch, reduction)

    def excite(self, x: torch.Tensor) -> torch.Tensor:
        return self.se(x)


def sep_conv(use_se: bool, in_ch: int, out_ch: int, k: int,
             conv_kernel: Optional[str] = None, **kwargs) -> SepConv:
    """``SepConvSE`` when ``use_se`` (where ``conv_kernel`` has no effect,
    as in the JAX package), else ``SepConv``."""
    if use_se:
        return SepConvSE(in_ch, out_ch, k, **kwargs)
    return SepConv(in_ch, out_ch, k, conv_kernel=conv_kernel, **kwargs)


class QuartNetBlock(nn.Module):
    """Residual block (``layers.py::QuartNetBlock``): (repeat-1) SepConvs +
    one last SepConv, summed with a 1x1-conv+BN residual branch, then ReLU.
    The residual branch is NOT masked before its BN — reference behaviour."""

    def __init__(self, repeat: int = 3, in_ch: int = 1, out_ch: int = 32, k: int = 33,
                 mask: bool = True, drop_rate: float = 0.0, dtype: Optional[torch.dtype] = None,
                 conv_kernel: Optional[str] = None, use_se: bool = False):
        super().__init__()
        self.in_ch, self.out_ch = in_ch, out_ch
        self.seps = [f"sep{i}" for i in range(repeat - 1)] + ["sep_last"]
        common = dict(mask=mask, drop_rate=drop_rate, dtype=dtype, conv_kernel=conv_kernel)
        for i in range(repeat - 1):
            self.add_module(f"sep{i}", sep_conv(use_se, in_ch, in_ch, k, **common))
        self.sep_last = sep_conv(use_se, in_ch, out_ch, k, last=True, **common)
        self.reside_conv = Conv(in_ch, out_ch, 1, dtype=dtype)
        self.reside_bn = MaskedBatchNorm(out_ch)

    def forward(self, x: torch.Tensor, percents: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        start = tp.column_input(tp.full(x, self.in_ch), self.out_ch)
        for name in self.seps:
            x = getattr(self, name)(x, percents, generator)
        return F.relu(x + self.reside_bn(self.reside_conv(start)))


class BatchLSTM(nn.Module):
    """Bidirectional LSTM with packed-sequence-equivalent masking on
    (B, T, C) float32; the recurrence is kernel K2, its backward K3, or with
    ``fuse_directions`` the batch-stacked K7 and K8 (the JAX package's
    ``LASR_LSTM_FUSED_BIDIR=1``); the parameters are the same."""

    def __init__(self, in_ch: int, hidden: int, fuse_directions: bool = False):
        super().__init__()
        self.in_ch, self.hidden = in_ch, hidden
        self.fuse_directions = fuse_directions
        for tag in ("f", "b"):
            self.register_parameter(f"w_ih_{tag}", nn.Parameter(torch.zeros(4 * hidden, in_ch)))
            self.register_parameter(f"w_hh_{tag}", nn.Parameter(torch.zeros(4 * hidden, hidden)))
            self.register_parameter(f"b_ih_{tag}", nn.Parameter(torch.zeros(4 * hidden)))
            self.register_parameter(f"b_hh_{tag}", nn.Parameter(torch.zeros(4 * hidden)))

    def reset_parameters(self, generator: torch.Generator) -> None:
        for p in self.parameters():
            _uniform_(p, 1.0 / math.sqrt(self.hidden), generator)

    def weights(self, tag: str) -> LSTMWeights:
        return LSTMWeights(*(getattr(self, f"{n}_{tag}") for n in ("w_ih", "w_hh", "b_ih", "b_hh")))

    def forward(self, x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        return lstm(x, lengths, self.weights("f"), self.weights("b"), self.fuse_directions)
