"""Plain float32 reference of the QuartzNet encoders and the CTC head, read
from a configuration file of ``h100_bench/configs/``.

Parameters are a dict of tensors under the same names the port's
``state_dict`` uses (``encoder.block1.sep_last.pointwise_conv.weight``...),
so the benchmark draws one dict and hands it to both sides.  Layer
equations (QuartzNet, arXiv:1910.10261, and the reference project's
``QuartNetContext.py``):

  * SepConv: depthwise conv (groups = channels, padding k // 2) ->
    pointwise 1x1 conv -> frames at or past int(T * percent) zeroed (the
    mask, before BatchNorm) -> BatchNorm (eps 1e-3) -> ReLU unless last.
  * block: the SepConvs, plus a 1x1 conv + BatchNorm of the block's input
    (not masked), summed, then ReLU.
  * the context branch: a bidirectional LSTM (torch.nn.LSTM gate order,
    packed-sequence semantics: the reverse direction starts at each row's
    last valid frame, pad frames output 0) over the trunk's (B, T, C),
    concatenated onto the channels.
  * epilog: an optional SepConv ``last_cnn``, a 1x1 conv (optional bias),
    BatchNorm, ReLU; the decoder a 1x1 conv with bias and a log-softmax.

BatchNorm runs in train mode: its statistics come from the batch (mean
and biased variance over every frame of every row, pad frames included).

``precision="fp8"`` is the control: one step below the bf16 compute the
configurations state, every value the program holds in bf16 is rounded to
float8 e4m3 under a per-tensor scale: each convolution's input, weight and
output, each BatchNorm's output, each block's sum, the BiLSTM's output on
its way back into the trunk (``frontend.py`` does the same to the
log-mel's products, which the "default" frontend states in bf16); the
LSTM, the decoder and the loss stay float32, as in the program.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

Tensors = Dict[str, torch.Tensor]
BN_EPS = 1e-3
FP8_MAX = 448.0
# torch.nn.LSTM's parameter names -> the port's, per direction
_LSTM_NAMES = {"weight_ih": "w_ih", "weight_hh": "w_hh", "bias_ih": "b_ih", "bias_hh": "b_hh"}


def no_tf32() -> None:
    """Float32 products in float32: TF32 off for matmuls and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale that maps its
    largest magnitude to 448, returned in float32; the gradient passes
    through the rounding unchanged."""
    with torch.no_grad():
        amax = x.abs().amax().clamp(min=1e-30)
        q = (x * (FP8_MAX / amax)).to(torch.float8_e4m3fn).to(torch.float32) * (amax / FP8_MAX)
    return x + (q - x).detach()


def _conv(x, w, b=None, stride=1, padding=0, groups=1, precision="fp32"):
    if precision == "fp8":
        y = F.conv1d(round_fp8(x), round_fp8(w), None, stride, padding, 1, groups)
        y = round_fp8(y)
        return y if b is None else y + b[:, None]
    return F.conv1d(x, w, b, stride, padding, 1, groups)


def lengths_from_percents(T: int, percents: torch.Tensor) -> torch.Tensor:
    """int(float32(T) * percent), truncated in float32."""
    return (torch.full((), T, dtype=torch.float32, device=percents.device)
            * percents.to(torch.float32)).to(torch.int64)


def _mask(x: torch.Tensor, percents: torch.Tensor) -> torch.Tensor:
    lens = lengths_from_percents(x.shape[-1], percents)
    keep = torch.arange(x.shape[-1], device=x.device)[None, :] < lens[:, None]
    return x * keep[:, None, :].to(x.dtype)


class Net:
    """The reference network of one configuration (``cfg``: the parsed
    configuration file)."""

    def __init__(self, cfg: dict, precision: str = "fp32"):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"precision must be fp32 or fp8, got {precision!r}")
        self.cfg, self.precision = cfg, precision
        self.mask = bool(cfg["build_model"]["mask"])
        self._lstms: dict = {}

    # -- layers ---------------------------------------------------------
    def _bn(self, p: Tensors, name: str, x: torch.Tensor):
        mean = x.mean(dim=(0, 2))
        var = ((x - mean[:, None]) ** 2).mean(dim=(0, 2))
        inv = torch.rsqrt(var + BN_EPS) * p[f"{name}.weight"]
        return self._act((x - mean[:, None]) * inv[:, None] + p[f"{name}.bias"][:, None])

    def _act(self, x: torch.Tensor) -> torch.Tensor:
        """An activation as the control holds it (float8), else as is."""
        return round_fp8(x) if self.precision == "fp8" else x

    def _sepconv(self, p, name, x, percents, k, stride, last):
        pr = self.precision
        x = _conv(x, p[f"{name}.depthwise_conv.weight"], None, stride, k // 2, x.shape[1], pr)
        x = _conv(x, p[f"{name}.pointwise_conv.weight"], precision=pr)
        if self.mask:
            x = _mask(x, percents)
        x = self._bn(p, f"{name}.bn", x)
        return x if last else F.relu(x)

    def _block(self, p, name, blk, x, percents):
        start = x
        names = [f"sep{i}" for i in range(blk["repeat"] - 1)] + ["sep_last"]
        for sep in names:
            x = self._sepconv(p, f"{name}.{sep}", x, percents, blk["k"], 1, sep == "sep_last")
        res = _conv(start, p[f"{name}.reside_conv.weight"], precision=self.precision)
        return self._act(F.relu(x + self._bn(p, f"{name}.reside_bn", res)))

    def _bilstm(self, p, name, x, lengths, hidden):
        """(B, T, C) -> (B, T, 2H) float32: torch.nn.LSTM over the packed
        rows (every row at least one frame long), pad frames 0."""
        B, T, C = x.shape
        key = (C, hidden, x.device)
        if key not in self._lstms:
            self._lstms[key] = torch.nn.LSTM(C, hidden, batch_first=True,
                                             bidirectional=True).to(x.device)
        weights = {f"{torch_name}_l0{sfx}": p[f"{name}.{ours}_{d}"]
                   for d, sfx in (("f", ""), ("b", "_reverse"))
                   for torch_name, ours in _LSTM_NAMES.items()}
        packed = torch.nn.utils.rnn.pack_padded_sequence(x, lengths.cpu(), batch_first=True,
                                                         enforce_sorted=False)
        y, _ = torch.func.functional_call(self._lstms[key], weights, (packed,))
        return torch.nn.utils.rnn.pad_packed_sequence(y, batch_first=True, total_length=T)[0]

    # -- the network ----------------------------------------------------
    def forward(self, p: Tensors, feats: torch.Tensor, percents: torch.Tensor):
        """(feats (B, T, n_mels), percents (B,)) -> (log_probs (B, T', V),
        out_lens (B,) int64)."""
        cfg, pr = self.cfg, self.precision
        x = feats.transpose(1, 2)
        st = cfg["stem"]
        x = self._sepconv(p, f"encoder.{st['name']}", x, percents, st["k"], st["stride"], False)
        ctx = cfg.get("context")
        for blk in cfg["blocks"]:
            x = self._block(p, f"encoder.{blk['name']}", blk, x, percents)
            if ctx is not None and blk["name"] == ctx["after"]:
                lens = lengths_from_percents(x.shape[-1], percents)
                c = self._bilstm(p, f"encoder.{ctx['name']}", x.transpose(1, 2), lens,
                                 ctx["hidden"])
                x = torch.cat([x, self._act(c.transpose(1, 2))], dim=1)
        lc = cfg.get("last_cnn")
        if lc is not None:
            x = self._sepconv(p, f"encoder.{lc['name']}", x, percents, lc["k"], 1, False)
        bias = p.get("encoder.last_conv.bias") if cfg["last_conv"]["bias"] else None
        x = _conv(x, p["encoder.last_conv.weight"], bias, precision=pr)
        x = F.relu(self._bn(p, "encoder.last_bn", x))
        logits = F.conv1d(x, p["decoder.weight"], p["decoder.bias"])
        log_probs = F.log_softmax(logits, dim=1).transpose(1, 2)
        return log_probs, lengths_from_percents(log_probs.shape[1], percents)


def param_shapes(cfg: dict) -> Dict[str, tuple]:
    """Every parameter and BatchNorm statistic of ``cfg``'s network, by the
    port's name, with its shape, in the port's registration order."""
    shapes: Dict[str, tuple] = {}

    def bn(name, c):
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            shapes[f"{name}.{leaf}"] = (c,)

    def sepconv(name, cin, cout, k):
        shapes[f"{name}.depthwise_conv.weight"] = (cin, 1, k)
        shapes[f"{name}.pointwise_conv.weight"] = (cout, cin, 1)
        bn(f"{name}.bn", cout)

    st = cfg["stem"]
    sepconv(f"encoder.{st['name']}", st["in"], st["out"], st["k"])
    ctx = cfg.get("context")
    for blk in cfg["blocks"]:
        name = f"encoder.{blk['name']}"
        for i in range(blk["repeat"] - 1):
            sepconv(f"{name}.sep{i}", blk["in"], blk["in"], blk["k"])
        sepconv(f"{name}.sep_last", blk["in"], blk["out"], blk["k"])
        shapes[f"{name}.reside_conv.weight"] = (blk["out"], blk["in"], 1)
        bn(f"{name}.reside_bn", blk["out"])
    if ctx is not None:
        H, C = ctx["hidden"], ctx["in"]
        for d in ("f", "b"):
            shapes[f"encoder.{ctx['name']}.w_ih_{d}"] = (4 * H, C)
            shapes[f"encoder.{ctx['name']}.w_hh_{d}"] = (4 * H, H)
            shapes[f"encoder.{ctx['name']}.b_ih_{d}"] = (4 * H,)
            shapes[f"encoder.{ctx['name']}.b_hh_{d}"] = (4 * H,)
    lc = cfg.get("last_cnn")
    if lc is not None:
        sepconv(f"encoder.{lc['name']}", lc["in"], lc["out"], lc["k"])
    lcv = cfg["last_conv"]
    shapes["encoder.last_conv.weight"] = (lcv["out"], lcv["in"], 1)
    if lcv["bias"]:
        shapes["encoder.last_conv.bias"] = (lcv["out"],)
    bn("encoder.last_bn", lcv["out"])
    dec = cfg["decoder"]
    shapes["decoder.weight"] = (dec["out"], dec["in"], 1)
    shapes["decoder.bias"] = (dec["out"],)
    return shapes


def param_groups(cfg: dict) -> Dict[str, str]:
    """Each parameter's group, by where it sits in the network: ``stem``
    (the first SepConv), ``context`` (the context branch's BiLSTM),
    ``head`` (the epilog and the decoder) or ``trunk`` (the blocks)."""
    ctx, lc = cfg.get("context"), cfg.get("last_cnn")
    prefixes = [(f"encoder.{cfg['stem']['name']}.", "stem"), ("encoder.last_conv.", "head"),
                ("encoder.last_bn.", "head"), ("decoder.", "head")]
    if ctx is not None:
        prefixes.append((f"encoder.{ctx['name']}.", "context"))
    if lc is not None:
        prefixes.append((f"encoder.{lc['name']}.", "head"))
    return {name: next((g for pre, g in prefixes if name.startswith(pre)), "trunk")
            for name in param_shapes(cfg) if not is_stat(name)}


def is_stat(name: str) -> bool:
    return name.endswith(("running_mean", "running_var"))


def init_bound(name: str, shape: tuple, cfg: dict) -> Optional[float]:
    """The half-width of the uniform draw of a parameter (the recipe's
    initializers), or None for BatchNorm's constants."""
    ctx = cfg.get("context")
    if ctx is not None and name.startswith(f"encoder.{ctx['name']}."):
        return 1.0 / ctx["hidden"] ** 0.5
    if name.endswith(".weight") and len(shape) == 3:
        return 1.0 / (shape[1] * shape[2]) ** 0.5
    if name.endswith(".bias") and (name.startswith("decoder") or "last_conv" in name):
        fan_in = cfg["decoder"]["in"] if name.startswith("decoder") else cfg["last_conv"]["in"]
        return 1.0 / fan_in ** 0.5
    return None


def make_params(cfg: dict, generator: torch.Generator, device) -> Tensors:
    """Every parameter of ``cfg``'s network from ``generator`` (on
    ``device``) in one draw: U(+-bound) by ``init_bound``; BatchNorm scale
    and variance 1, shift and mean 0."""
    shapes = param_shapes(cfg)
    drawn = [(n, s) for n, s in shapes.items() if init_bound(n, s, cfg) is not None]
    total = sum(int(torch.Size(s).numel()) for _, s in drawn)
    u = torch.rand(total, generator=generator, device=device, dtype=torch.float32)
    out, off = {}, 0
    for name, shape in shapes.items():
        bound = init_bound(name, shape, cfg)
        if bound is None:
            fill = 1.0 if name.endswith(("weight", "running_var")) else 0.0
            out[name] = torch.full(shape, fill, dtype=torch.float32, device=device)
            continue
        n = int(torch.Size(shape).numel())
        out[name] = (u[off: off + n].view(shape) * (2 * bound) - bound).contiguous()
        off += n
    return out
