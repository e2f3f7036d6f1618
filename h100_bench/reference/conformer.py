"""Plain float32 reference of Conformer-CTC (Gulati et al., arXiv:2005.08100;
NVIDIA NeMo's ``ConformerEncoder`` with relative-position attention, its
"striding" subsampling and ``ConvASRDecoder``), read from a configuration
file of ``h100_bench/configs/`` (``conformer_ctc_large.json``), and its
train step.

Parameters are a dict of tensors under the port's ``state_dict`` names
(``encoder.layers.3.self_attn.linear_q.weight``...).  Per row of T'
output frames, of which n = int(float32(T') * percent) are valid:

  * subsampling: the (B, T, F) features as one channel, Conv2d k3 stride 2
    padding 1 (with bias) and ReLU, twice; the (C x F'') frame flattened
    channel-major; a Linear to d_model; times sqrt(d_model).
  * position table: for positions T' - 1 down to -(T' - 1), sin(pos w_k) in
    channel 2k and cos(pos w_k) in 2k + 1, w_k = 10000^(-2k / d_model).
  * a layer: x += FFN1(LN(x)) / 2; x += MHSA(LN(x)); x += Conv(LN(x));
    x += FFN2(LN(x)) / 2; x = LN(x) (LayerNorm eps 1e-5).  FFN: Linear,
    Swish (x sigmoid(x)), Linear.
  * MHSA, spelled out: q, k, v from Linears, split into H heads of d_k;
    p = table @ W_pos^T (no bias); ac[i, j] = (q_i + u) . k_j; bd[i, j] =
    (q_i + v) . p at position i - j (the column T' - 1 - i + j of the
    product with the whole table); scores (ac + bd) / sqrt(d_k); where the
    query or the key is a pad frame the score is -10000 and, after the
    softmax, the weight 0; the weights times v, the heads concatenated,
    ``linear_out``.
  * Conv: pointwise d -> 2d (bias), GLU over channels, pad frames zeroed,
    depthwise k (groups d, padding (k - 1) / 2, bias), BatchNorm in train
    mode (the mean and biased variance over every frame of every row, eps
    1e-5), Swish, pointwise d -> d (bias).
  * decoder: a 1x1 conv to the classes (blank last), log-softmax.

The train step is ``train.py``'s: the reference frontend (``frontend.py``),
the batch mean of the CTC losses and NovoGrad, with the same seeded draws.

``precision="fp8"`` is the control: every value the program holds in bf16
rounded to float8 e4m3 under a per-tensor scale (``model.round_fp8``): each
Linear's and conv's input, weight and output, the position term of the
scores and the attention weights and output, each LayerNorm's and
BatchNorm's output, every residual sum; the LayerNorm and BatchNorm
statistics, the softmax's, the decoder and the loss stay float32, as in
the program.

Departures from NeMo's recipe, here and in the program alike (the
configuration's ``departures``): NovoGrad with the cosine warm-up in place
of AdamW with Noam annealing; no dropout (NeMo 0.1); the port's log-mel in
dB with per-utterance normalization in place of ln(. + 2^-24) with
per-feature normalization; the port's SpecAugment (one frequency and one
time band) in place of 2 frequency and 10 time masks; valid frames from the
percents in place of NeMo's conv length formula; in the program, a bf16
residual stream (each LayerNorm's output and each residual sum) where
NeMo's bf16 mixed precision keeps LayerNorm outputs, and so every residual
sum after the first layer, in float32 (the float32 reference rounds
neither; its float8 control rounds both).
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from .model import Tensors, is_stat, lengths_from_percents, round_fp8
from .train import RefTrainer

LN_EPS = BN_EPS = 1e-5
MASK_VALUE = -10000.0


def subsampled(n: int) -> int:
    """Frames (or bins) after the two stride-2 k3 pad-1 convs."""
    return (((n - 1) // 2) // 2) + 1


def positions(t: int, d_model: int, device) -> torch.Tensor:
    """(2t - 1, d_model) float32: row r is position t - 1 - r."""
    pos = torch.arange(t - 1, -t, -1, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32, device=device)
                    * -(math.log(10000.0) / d_model))
    pe = torch.zeros(pos.shape[0], d_model, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


class ConformerNet:
    """The reference network of one configuration (``cfg``: the parsed
    configuration file)."""

    def __init__(self, cfg: dict, precision: str = "fp32"):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"precision must be fp32 or fp8, got {precision!r}")
        self.cfg, self.enc, self.precision = cfg, cfg["encoder"], precision
        self.mask = bool(cfg["build_model"]["mask"])

    def _act(self, x: torch.Tensor) -> torch.Tensor:
        """A value as the control holds it (float8), else as is."""
        return round_fp8(x) if self.precision == "fp8" else x

    def _linear(self, p: Tensors, name: str, x: torch.Tensor) -> torch.Tensor:
        w, b = p[f"{name}.weight"], p.get(f"{name}.bias")
        y = self._act(self._act(x) @ self._act(w).t())
        return y if b is None else self._act(y + b)

    def _conv(self, x, w, b, stride=1, padding=0, groups=1, dims=1):
        conv = F.conv1d if dims == 1 else F.conv2d
        return self._act(conv(self._act(x), self._act(w), b, stride, padding, 1, groups))

    def _ln(self, p: Tensors, name: str, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=-1, keepdim=True)
        var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
        y = (x - mean) / torch.sqrt(var + LN_EPS) * p[f"{name}.weight"] + p[f"{name}.bias"]
        return self._act(y)

    def _bn(self, p: Tensors, name: str, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=(0, 2))
        var = ((x - mean[:, None]) ** 2).mean(dim=(0, 2))
        inv = torch.rsqrt(var + BN_EPS) * p[f"{name}.weight"]
        return self._act((x - mean[:, None]) * inv[:, None] + p[f"{name}.bias"][:, None])

    @staticmethod
    def _swish(x: torch.Tensor) -> torch.Tensor:
        return x * torch.sigmoid(x)

    # -- blocks ---------------------------------------------------------
    def subsample(self, p: Tensors, feats: torch.Tensor) -> torch.Tensor:
        """(B, T, F) -> (B, T', d_model), times sqrt(d_model)."""
        x = feats[:, None]
        for i in (0, 2):
            name = f"encoder.pre_encode.conv.{i}"
            x = F.relu(self._conv(x, p[f"{name}.weight"], p[f"{name}.bias"], 2, 1, dims=2))
        b, c, t, f = x.shape
        x = self._linear(p, "encoder.pre_encode.out", x.transpose(1, 2).reshape(b, t, c * f))
        return self._act(x * math.sqrt(self.enc["d_model"]))

    def attention(self, p: Tensors, name: str, x: torch.Tensor, pos: torch.Tensor,
                  valid: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        h = self.enc["n_heads"]
        dk = d // h
        q = self._linear(p, f"{name}.linear_q", x).view(b, t, h, dk)
        k = self._linear(p, f"{name}.linear_k", x).view(b, t, h, dk)
        v = self._linear(p, f"{name}.linear_v", x).view(b, t, h, dk)
        pe = self._linear(p, f"{name}.linear_pos", pos).view(2 * t - 1, h, dk)
        q_u = self._act(q + p[f"{name}.pos_bias_u"])
        q_v = self._act(q + p[f"{name}.pos_bias_v"])
        ac = torch.einsum("bihd,bjhd->bhij", q_u, k)
        bd_all = torch.einsum("bihd,rhd->bhir", q_v, pe)             # (B, H, T, 2T - 1)
        i = torch.arange(t, device=x.device)[:, None]
        j = torch.arange(t, device=x.device)[None, :]
        col = (t - 1 - i + j).expand(b, h, t, t)                     # position i - j
        bd = self._act(torch.gather(bd_all, 3, col) / math.sqrt(dk))
        scores = ac / math.sqrt(dk) + bd
        masked = ~(valid[:, None, :, None] & valid[:, None, None, :])
        weights = torch.softmax(scores.masked_fill(masked, MASK_VALUE), dim=-1)
        weights = self._act(weights.masked_fill(masked, 0.0))
        out = self._act(torch.einsum("bhij,bjhd->bihd", weights, v)).reshape(b, t, d)
        return self._linear(p, f"{name}.linear_out", out)

    def convolution(self, p: Tensors, name: str, x: torch.Tensor,
                    valid: torch.Tensor) -> torch.Tensor:
        """(B, T, d) -> (B, T, d)."""
        d, k = self.enc["d_model"], self.enc["conv_kernel_size"]
        y = self._conv(x.transpose(1, 2), p[f"{name}.pointwise_conv1.weight"],
                       p[f"{name}.pointwise_conv1.bias"])
        y = self._act(F.glu(y, dim=1) * valid[:, None, :].to(y.dtype))
        y = self._conv(y, p[f"{name}.depthwise_conv.weight"], p[f"{name}.depthwise_conv.bias"],
                       padding=(k - 1) // 2, groups=d)
        y = self._act(self._swish(self._bn(p, f"{name}.batch_norm", y)))
        y = self._conv(y, p[f"{name}.pointwise_conv2.weight"], p[f"{name}.pointwise_conv2.bias"])
        return y.transpose(1, 2)

    def feed_forward(self, p: Tensors, name: str, x: torch.Tensor) -> torch.Tensor:
        return self._linear(p, f"{name}.linear2",
                            self._act(self._swish(self._linear(p, f"{name}.linear1", x))))

    def layer(self, p: Tensors, name: str, x, pos, valid):
        x = self._act(x + 0.5 * self.feed_forward(p, f"{name}.feed_forward1",
                                                  self._ln(p, f"{name}.norm_feed_forward1", x)))
        x = self._act(x + self.attention(p, f"{name}.self_attn",
                                         self._ln(p, f"{name}.norm_self_att", x), pos, valid))
        x = self._act(x + self.convolution(p, f"{name}.conv",
                                           self._ln(p, f"{name}.norm_conv", x), valid))
        x = self._act(x + 0.5 * self.feed_forward(p, f"{name}.feed_forward2",
                                                  self._ln(p, f"{name}.norm_feed_forward2", x)))
        return self._ln(p, f"{name}.norm_out", x)

    # -- the network ----------------------------------------------------
    def forward(self, p: Tensors, feats: torch.Tensor, percents: torch.Tensor):
        """(feats (B, T, n_mels), percents (B,)) -> (log_probs (B, T', V),
        out_lens (B,) int64)."""
        x = self.subsample(p, feats)
        b, t, d = x.shape
        pos = positions(t, d, x.device)
        lens = lengths_from_percents(t, percents)
        if not self.mask:
            lens = torch.full_like(lens, t)
        valid = torch.arange(t, device=x.device)[None, :] < lens[:, None]
        for i in range(self.enc["n_layers"]):
            x = self.layer(p, f"encoder.layers.{i}", x, pos, valid)
        logits = F.conv1d(x.transpose(1, 2), p["decoder.weight"], p["decoder.bias"])
        log_probs = F.log_softmax(logits, dim=1).transpose(1, 2)
        return log_probs, lengths_from_percents(t, percents)


def param_shapes(cfg: dict) -> Dict[str, tuple]:
    """Every parameter and BatchNorm statistic of ``cfg``'s network, by the
    port's name, with its shape."""
    enc = cfg["encoder"]
    d, c, ff, k = enc["d_model"], enc["subsampling_conv_channels"], enc["d_ff"], \
        enc["conv_kernel_size"]
    dk = d // enc["n_heads"]
    shapes: Dict[str, tuple] = {}

    def linear(name, n_in, n_out, bias=True):
        shapes[f"{name}.weight"] = (n_out, n_in)
        if bias:
            shapes[f"{name}.bias"] = (n_out,)

    def norm(name, stats=False):
        leaves = ("weight", "bias") + (("running_mean", "running_var") if stats else ())
        for leaf in leaves:
            shapes[f"{name}.{leaf}"] = (d,)

    pre = "encoder.pre_encode"
    shapes[f"{pre}.conv.0.weight"], shapes[f"{pre}.conv.0.bias"] = (c, 1, 3, 3), (c,)
    shapes[f"{pre}.conv.2.weight"], shapes[f"{pre}.conv.2.bias"] = (c, c, 3, 3), (c,)
    linear(f"{pre}.out", c * subsampled(enc["feat_in"]), d)
    for i in range(enc["n_layers"]):
        ly = f"encoder.layers.{i}"
        for ffn in ("feed_forward1", "feed_forward2"):
            norm(f"{ly}.norm_{ffn}")
            linear(f"{ly}.{ffn}.linear1", d, ff)
            linear(f"{ly}.{ffn}.linear2", ff, d)
        norm(f"{ly}.norm_self_att")
        att = f"{ly}.self_attn"
        for lin in ("linear_q", "linear_k", "linear_v", "linear_out"):
            linear(f"{att}.{lin}", d, d)
        linear(f"{att}.linear_pos", d, d, bias=False)
        shapes[f"{att}.pos_bias_u"] = shapes[f"{att}.pos_bias_v"] = (enc["n_heads"], dk)
        norm(f"{ly}.norm_conv")
        cv = f"{ly}.conv"
        shapes[f"{cv}.pointwise_conv1.weight"], shapes[f"{cv}.pointwise_conv1.bias"] = \
            (2 * d, d, 1), (2 * d,)
        shapes[f"{cv}.depthwise_conv.weight"], shapes[f"{cv}.depthwise_conv.bias"] = \
            (d, 1, k), (d,)
        norm(f"{cv}.batch_norm", stats=True)
        shapes[f"{cv}.pointwise_conv2.weight"], shapes[f"{cv}.pointwise_conv2.bias"] = \
            (d, d, 1), (d,)
        norm(f"{ly}.norm_out")
    shapes["decoder.weight"], shapes["decoder.bias"] = (cfg["num_classes"], d, 1), \
        (cfg["num_classes"],)
    return shapes


def param_groups(cfg: dict) -> Dict[str, str]:
    """Each parameter's group: ``subsampling`` (``pre_encode``),
    ``attention`` (``self_attn`` and ``norm_self_att``), ``ffn`` (both
    feed-forwards, their LayerNorms and each layer's ``norm_out``), ``conv``
    (the conv module and ``norm_conv``), ``head`` (the decoder)."""
    def group(name: str) -> str:
        if name.startswith("encoder.pre_encode."):
            return "subsampling"
        if name.startswith("decoder."):
            return "head"
        part = name.split(".")[3]
        if part in ("self_attn", "norm_self_att"):
            return "attention"
        if part in ("conv", "norm_conv"):
            return "conv"
        return "ffn"
    return {name: group(name) for name in param_shapes(cfg) if not is_stat(name)}


def init_bound(name: str, shape: tuple):
    """The half-width of a parameter's uniform draw (torch's defaults,
    U(+-1/sqrt(fan_in)) for a Linear's or a conv's weight and bias), or
    None for the constants: LayerNorm's and BatchNorm's ones and zeros, and
    NeMo's zero ``pos_bias_u``/``pos_bias_v``."""
    if name.endswith(("pos_bias_u", "pos_bias_v")) or len(shape) == 1 and (
            ".norm_" in name or ".batch_norm." in name):
        return None
    return None if is_stat(name) else 1.0 / math.sqrt(math.prod(shape[1:]))


def _fan_in_shape(shapes: Dict[str, tuple], name: str) -> tuple:
    """A bias draws with its weight's fan-in."""
    return shapes[name[: -len("bias")] + "weight"] if name.endswith(".bias") else shapes[name]


def make_params(cfg: dict, generator: torch.Generator, device) -> Tensors:
    """Every parameter of ``cfg``'s network from ``generator`` (on
    ``device``) in one draw, by ``init_bound``; LayerNorm and BatchNorm
    scales and variances 1, shifts, means and the position biases 0."""
    shapes = param_shapes(cfg)
    bounds = {n: init_bound(n, _fan_in_shape(shapes, n)) for n in shapes}
    total = sum(math.prod(s) for n, s in shapes.items() if bounds[n] is not None)
    u = torch.rand(total, generator=generator, device=device, dtype=torch.float32)
    out, off = {}, 0
    for name, shape in shapes.items():
        if bounds[name] is None:
            fill = 1.0 if name.endswith(("weight", "running_var")) else 0.0
            out[name] = torch.full(shape, fill, dtype=torch.float32, device=device)
            continue
        n = math.prod(shape)
        out[name] = (u[off: off + n].view(shape) * (2 * bounds[name]) - bounds[name]).contiguous()
        off += n
    return out


class ConformerTrainer(RefTrainer):
    """``train.py``'s reference steps on ``ConformerNet``."""

    def __init__(self, cfg: dict, params: Tensors, precision: str = "fp32"):
        super().__init__(cfg, params, precision)
        self.net = ConformerNet(cfg, precision)


def run_steps(cfg: dict, params: Tensors, batches: List[dict], generators: list,
              precision: str = "fp32", update: bool = True) -> dict:
    """``train.run_steps`` on ``ConformerNet``: each step's loss, the first
    step's gradient norm a tensor, its log-probs and valid frames, and each
    tensor's change over all the steps.  ``update`` False is the fault of a
    state left unchanged: the losses of the first state on every batch, no
    gradient norm and no change (what the program reports when its step
    leaves the state as it was)."""
    tr = ConformerTrainer(cfg, params, precision)
    start = {k: v.clone() for k, v in tr.params.items()}
    losses, first = [], None
    for batch, gen in zip(batches, generators):
        if update:
            out = tr.step(batch, gen)
        else:
            loss, _, log_probs, out_lens = tr.loss_and_grads(batch, gen)
            out = {"loss": loss, "log_probs": log_probs, "out_lens": out_lens,
                   "grad_norms": {k: torch.zeros(()) for k in tr.params}}
        losses.append(float(out["loss"]))
        first = out if first is None else first
    change = {k: (tr.params[k] - start[k]).norm() for k in start}
    return {"losses": losses, "grad_norms": {k: float(v) for k, v in first["grad_norms"].items()},
            "change": {k: float(v) for k, v in change.items()},
            "log_probs": first["log_probs"], "out_lens": first["out_lens"],
            "preds": first["log_probs"].argmax(dim=-1)}
