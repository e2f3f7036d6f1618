"""The QuartzNet encoders + CTC head (port of
``lightning_asr_tpu/models/quartznet.py``), eval and train paths.

  * ``QuartNet12Context`` (``quartznet12_context``, the default): SepConv
    stem 64->256 k33 stride 2 (padding 16); 3 blocks k33 and 3 blocks k39 at
    256ch; a BiLSTM(256->2x40) context branch, run in float32 and cast to
    the activation type, concatenated onto the 256ch stream (336ch); 3
    blocks k51 (336->512), 3 blocks k63, one k75, one k87; epilog 1x1 conv
    512->1024 + BN + ReLU + dropout.  ``use_se`` (``quartznet12_context_se``)
    makes every SepConv a ``SepConvSE``.
  * ``QuartNet15x5`` (``quartznet15x5``): a plain conv stem 64->256 k33
    stride 2 with bias + BN + ReLU; five repeat-5 blocks; a k87 SepConv; a
    1x1 conv 512->1024 with bias + BN + ReLU.
  * ``QuartNet105`` (``quartznet10x5``): a SepConv stem 64->256 k33 stride
    2; ten repeat-5 blocks; the epilog of 15x5.

``conformer_ctc_large`` (``models/conformer.py``) is the port's own
encoder, Conformer-CTC Large, with no counterpart in the JAX package:
``MODEL_REGISTRY`` names the JAX package's four, ``ENCODERS`` all five.

``AsrModel`` adds the 1x1-conv decoder to (vocab+1) classes and
log-softmax, both in float32; with ``feature_in`` (the SSL path) a float32
``Dense`` ``feature_mapping`` (feature_in -> in_c, with bias) runs before
the encoder.  With ``lstm_head`` (the reference's legacy ``MyModel`` head)
the decoder is replaced by ``head_rnn``, a BiLSTM(1024 -> 2 x 128) over
the true lengths (kernels K2 / K3, or K7 / K8 with ``fuse_directions``,
at H = 128), ``head_bn``, a BatchNorm over its 256 channels, and
``head_fc``, a ``Dense`` 256 -> (vocab+1) with bias, all in float32.
``module.train()`` selects batch statistics and dropout; a dropout rate
above 0 needs a ``torch.Generator`` passed to ``forward``.

Module names follow the flax parameter tree, so ``utils/jax_params.py``
maps one onto the other key by key.

Inside ``parallel/tp.py::model_parallel`` (tensor parallelism) the encoders
take the whole input and return this rank's channel block of the trunk
where it splits: a SepConv stem reads its block of the input (a free
slice), the 15x5's plain stem the whole input for its own output rows; the
context BiLSTM reads the gathered trunk, and the 336-channel concat is cut
to this rank's block (at tp = 4 one block straddles the trunk and the
BiLSTM's channels, as GSPMD lays out a split-by-whole concat); the epilog
conv writes this rank's rows of its 1024 outputs, which the decoder (or the
LSTM head) reads gathered.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import tp
from .conformer import NAME as CONFORMER, ConformerEncoder, RelPositionAttention
from .layers import (BatchLSTM, Conv, Conv2d, Dense, LayerNorm, Linear, MaskedBatchNorm,
                     QuartNetBlock, SepConv, _lengths_from_percents, dropout, sep_conv)

_BLOCKS = ([(n, 256, 256, 33) for n in ("block1", "block12", "block13")]
           + [(n, 256, 256, 39) for n in ("block2", "block22", "block23")])
_CONTEXT_BLOCKS = ([("block3", None, 512, 51), ("block32", 512, 512, 51), ("block33", 512, 512, 51)]
                   + [(n, 512, 512, 63) for n in ("block4", "block42", "block43")]
                   + [("block5", 512, 512, 75), ("block6", 512, 512, 87)])
# (in, out, k) of the repeat-5 blocks, named block1, block2, ...
_PLAN_15X5 = [(256, 256, 33), (256, 256, 39), (256, 512, 51), (512, 512, 63), (512, 512, 75)]
_PLAN_10X5 = ([(256, 256, 33)] * 2 + [(256, 256, 39)] * 2 + [(256, 512, 51), (512, 512, 51)]
              + [(512, 512, 63)] * 2 + [(512, 512, 75)] * 2)


def epilog_input(conv: Conv, x: torch.Tensor) -> torch.Tensor:
    """The input of a 1x1 epilog conv: the trunk gathered, for this rank's
    output rows (``parallel/tp.py``; ``x`` itself outside it)."""
    return tp.column_input(tp.full(x, conv.in_ch), conv.out_ch)


class QuartNet12Context(nn.Module):
    """QuartzNet 12x1 with BiLSTM context branch (the default encoder; with
    ``use_se`` the squeeze-excite variant).  (B, C, T) -> (B, 1024, T') with
    T' = ceil(T / 2)."""

    in_c, out_ch = 64, 1024

    def __init__(self, in_c: int = 64, mask: bool = False, lstm_hidden: int = 40,
                 drop_rate: float = 0.0, dtype: Optional[torch.dtype] = None,
                 conv_kernel: Optional[str] = None, fuse_directions: bool = False,
                 use_se: bool = False):
        super().__init__()
        self.drop_rate = drop_rate
        self.first_cnn = sep_conv(use_se, in_c, 256, 33, stride=2, mask=mask,
                                  drop_rate=drop_rate, dtype=dtype, conv_kernel=conv_kernel)
        ctx_ch = 256 + 2 * lstm_hidden
        self.trunk = [name for name, *_ in _BLOCKS]
        self.head = [name for name, *_ in _CONTEXT_BLOCKS]
        for name, cin, cout, k in _BLOCKS + _CONTEXT_BLOCKS:
            self.add_module(name, QuartNetBlock(repeat=1, in_ch=cin or ctx_ch, out_ch=cout,
                                                k=k, mask=mask, drop_rate=drop_rate, dtype=dtype,
                                                conv_kernel=conv_kernel, use_se=use_se))
        self.context_rnn = BatchLSTM(256, lstm_hidden, fuse_directions)
        self.last_conv = Conv(512, 1024, 1, dtype=dtype)
        self.last_bn = MaskedBatchNorm(1024)

    def forward(self, x: torch.Tensor, percents: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.first_cnn(tp.own(x), percents, generator)
        for name in self.trunk:
            x = getattr(self, name)(x, percents, generator)
        # context branch: BiLSTM over true lengths in float32, on (B, T, C)
        x = tp.full(x, self.context_rnn.in_ch)
        lengths = _lengths_from_percents(x.shape[-1], percents)
        c = self.context_rnn(x.transpose(1, 2).float(), lengths)
        x = tp.own(torch.cat([x, c.to(x.dtype).transpose(1, 2)], dim=1))   # (B, 336, T)
        for name in self.head:
            x = getattr(self, name)(x, percents, generator)
        x = F.relu(self.last_bn(self.last_conv(epilog_input(self.last_conv, x))))
        return dropout(x, self.drop_rate, generator, self.last_conv.out_ch) if self.training else x


class _Repeat5(nn.Module):
    """The repeat-5 QuartzNets (``quartznet.py::QuartNet15x5``,
    ``QuartNet105``): a stride-2 stem, repeat-5 blocks ``block1``, ... on
    ``plan``, the k87 SepConv ``last_cnn`` and the 1x1 conv 512->1024 with
    bias + BN + ReLU, without a final dropout.  (B, C, T) -> (B, 1024, T')."""

    in_c, out_ch = 64, 1024

    def __init__(self, stem: nn.Module, plan, mask: bool, drop_rate: float,
                 dtype: Optional[torch.dtype], conv_kernel: Optional[str]):
        super().__init__()
        self.first_cnn = stem
        self.blocks = [f"block{i + 1}" for i in range(len(plan))]
        for name, (cin, cout, k) in zip(self.blocks, plan):
            self.add_module(name, QuartNetBlock(repeat=5, in_ch=cin, out_ch=cout, k=k, mask=mask,
                                                drop_rate=drop_rate, dtype=dtype,
                                                conv_kernel=conv_kernel))
        self.last_cnn = SepConv(512, 512, 87, last=False, mask=mask, drop_rate=drop_rate,
                                dtype=dtype, conv_kernel=conv_kernel)
        self.last_conv = Conv(512, 1024, 1, bias=True, dtype=dtype)
        self.last_bn = MaskedBatchNorm(1024)

    def stem(self, x: torch.Tensor, percents: torch.Tensor, generator) -> torch.Tensor:
        return self.first_cnn(tp.own(x), percents, generator)

    def forward(self, x: torch.Tensor, percents: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.stem(x, percents, generator)
        for name in self.blocks:
            x = getattr(self, name)(x, percents, generator)
        x = self.last_cnn(x, percents, generator)
        return F.relu(self.last_bn(self.last_conv(epilog_input(self.last_conv, x))))


class QuartNet15x5(_Repeat5):
    """QuartzNet 15x5: the stem is a full conv 64->256 k33 stride 2 with
    bias (``F.conv1d``; no kernel of the JAX package runs it), then BN and
    ReLU."""

    def __init__(self, in_c: int = 64, mask: bool = True, drop_rate: float = 0.0,
                 dtype: Optional[torch.dtype] = None, conv_kernel: Optional[str] = None):
        super().__init__(Conv(in_c, 256, 33, stride=2, padding=16, bias=True, dtype=dtype),
                         _PLAN_15X5, mask, drop_rate, dtype, conv_kernel)
        self.first_bn = MaskedBatchNorm(256)

    def stem(self, x: torch.Tensor, percents: torch.Tensor, generator) -> torch.Tensor:
        return F.relu(self.first_bn(self.first_cnn(tp.column_input(x, self.first_cnn.out_ch))))


class QuartNet105(_Repeat5):
    """QuartzNet 10x5: a SepConv stem 64->256 k33 stride 2."""

    def __init__(self, in_c: int = 64, mask: bool = True, drop_rate: float = 0.0,
                 dtype: Optional[torch.dtype] = None, conv_kernel: Optional[str] = None):
        super().__init__(SepConv(in_c, 256, 33, stride=2, mask=mask, drop_rate=drop_rate,
                                 dtype=dtype, conv_kernel=conv_kernel),
                         _PLAN_10X5, mask, drop_rate, dtype, conv_kernel)


# encoder name -> (class, its own arguments): the JAX package's _ENCODERS,
# then the port's own, which have no JAX counterpart (no weight bridge, no
# tensor-parallel layout)
_ENCODERS = {
    "quartznet12_context": (QuartNet12Context, {}),
    "quartznet12_context_se": (QuartNet12Context, {"use_se": True}),
    "quartznet15x5": (QuartNet15x5, {}),
    "quartznet10x5": (QuartNet105, {}),
    CONFORMER: (ConformerEncoder, {}),
}
PORT_ONLY_ENCODERS = (CONFORMER,)
MODEL_REGISTRY = tuple(k for k in _ENCODERS if k not in PORT_ONLY_ENCODERS)   # the JAX package's
PORTED_ENCODERS = MODEL_REGISTRY
ENCODERS = tuple(_ENCODERS)


class AsrModel(nn.Module):
    """Encoder + CTC head (the reference's ``MyModel2``).

    ``forward(feats (B, T, in_c), percents (B,))`` returns
    ``(log_probs (B, T', num_classes), out_lengths (B,) int32)``; with
    ``feature_in`` the features are (B, T, feature_in).  ``in_c`` None is
    the encoder's own input width (64 mels for the QuartzNets, 80 for the
    Conformer); the head reads the encoder's output width (``out_ch``:
    1024 for the QuartzNets, 512 for the Conformer)."""

    def __init__(self, num_classes: int, encoder_name: str = "quartznet12_context",
                 in_c: Optional[int] = None, drop_rate: float = 0.0, mask: bool = False,
                 dtype: Optional[torch.dtype] = None, conv_kernel: Optional[str] = None,
                 fuse_directions: bool = False, feature_in: Optional[int] = None,
                 lstm_head: bool = False, lstm_head_hidden: int = 128):
        super().__init__()
        self.dtype = dtype                                          # conv compute type
        in_c = in_c or _ENCODERS[encoder_name][0].in_c
        self.feature_mapping = None if feature_in is None else Dense(feature_in, in_c, bias=True)
        self.encoder = make_encoder(encoder_name, in_c, mask, drop_rate, dtype, conv_kernel,
                                    fuse_directions)
        self.width = width = self.encoder.out_ch
        self.lstm_head = lstm_head
        if lstm_head:                                               # float32 head
            self.head_rnn = BatchLSTM(width, lstm_head_hidden, fuse_directions)
            self.head_bn = MaskedBatchNorm(2 * lstm_head_hidden)
            self.head_fc = Dense(2 * lstm_head_hidden, num_classes, bias=True)
        else:
            self.decoder = Conv(width, num_classes, 1, bias=True)  # float32 head

    def forward(self, x: torch.Tensor, percents: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.feature_mapping is not None:
            x = self.feature_mapping(x)
        x = tp.full(self.encoder(x.transpose(1, 2), percents, generator), self.width)
        if not self.lstm_head:
            return ctc_head(self.decoder, x, percents)
        x = x.float().transpose(1, 2)                               # (B, T', C)
        x = self.head_rnn(x, _lengths_from_percents(x.shape[1], percents))
        x = self.head_fc(self.head_bn(x.transpose(1, 2)).transpose(1, 2))
        log_probs = F.log_softmax(x, dim=-1)
        return log_probs, _lengths_from_percents(log_probs.shape[1], percents)


def make_encoder(encoder_name: str, in_c: int, mask: bool, drop_rate: float,
                 dtype: Optional[torch.dtype], conv_kernel: Optional[str],
                 fuse_directions: bool) -> nn.Module:
    """The ``encoder_name`` encoder; ``fuse_directions`` reaches the
    encoders with a BiLSTM."""
    enc_cls, enc_kwargs = _ENCODERS[encoder_name]
    if enc_cls is QuartNet12Context:
        enc_kwargs = {**enc_kwargs, "fuse_directions": fuse_directions}
    return enc_cls(in_c=in_c, mask=mask, drop_rate=drop_rate, dtype=dtype,
                   conv_kernel=conv_kernel, **enc_kwargs)


def ctc_head(decoder: Conv, x: torch.Tensor, percents: torch.Tensor):
    """The float32 1x1-conv decoder and log-softmax on the encoder's (B, C,
    T'): (log_probs (B, T', V+1), out_lengths (B,) int32)."""
    log_probs = F.log_softmax(decoder(x.float()), dim=1).transpose(1, 2)
    return log_probs, _lengths_from_percents(log_probs.shape[1], percents)


def build_model(num_classes: int, encoder: str = "quartznet12_context",
                in_c: Optional[int] = None,
                drop_rate: float = 0.0, mask: bool = False, feature_in: Optional[int] = None,
                dtype: Optional[torch.dtype] = None, conv_kernel: Optional[str] = None,
                fuse_directions: bool = False, lstm_head: bool = False,
                lstm_head_hidden: int = 128) -> AsrModel:
    """``build_model`` of the JAX package.  ``conv_kernel`` (None,
    ``"sepconv"``, ``"dw_wgrad"``) stands for the JAX package's
    ``LASR_SEPCONV_PALLAS`` and ``LASR_DW_WGRAD_PALLAS`` switches
    (``models/layers.py``; the SE convs ignore them, as there),
    ``fuse_directions`` for ``LASR_LSTM_FUSED_BIDIR`` (the BiLSTM through K7
    / K8; the repeat-5 encoders have none); neither changes the parameters.
    ``feature_in`` maps SSL features (wav2vec2's 512) to ``in_c`` first.
    ``lstm_head`` replaces the 1x1-conv decoder by the BiLSTM head of
    hidden size ``lstm_head_hidden`` (the LSTM kernels are built for 40 and
    128); as in the JAX package no CLI or config reaches it.  ``in_c`` None
    is the encoder's own input width.  ``conformer_ctc_large``
    (``models/conformer.py``) is the port's own encoder, without a JAX
    counterpart; it takes no ``conv_kernel``."""
    if encoder not in ENCODERS:
        raise ValueError(f"unknown encoder {encoder!r}; choose from {sorted(ENCODERS)}")
    return AsrModel(num_classes, encoder, in_c=in_c, drop_rate=drop_rate, mask=mask, dtype=dtype,
                    conv_kernel=conv_kernel, fuse_directions=fuse_directions,
                    feature_in=feature_in, lstm_head=lstm_head, lstm_head_hidden=lstm_head_hidden)


def reset_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """Draw every weight as the JAX package's initializers do (torch's
    default U(±1/sqrt(fan_in)); the wav2vec2 convs flax's default
    lecun-normal and zero bias; BatchNorm, LayerNorm and GroupNorm
    ones/zeros; the Conformer's ``pos_bias_u``/``pos_bias_v`` zeros, as
    NeMo's), from ``generator``."""
    for m in model.modules():
        if isinstance(m, (Conv, Conv2d, Dense, Linear, LayerNorm, MaskedBatchNorm, BatchLSTM,
                          RelPositionAttention)):
            m.reset_parameters(generator)
        elif isinstance(m, (nn.LayerNorm, nn.GroupNorm)):
            m.reset_parameters()
