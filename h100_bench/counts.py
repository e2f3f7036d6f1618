"""Operations and bytes: the hand kernels' roofline bounds and a model's
FLOPs.

Frozen copies, from ``chip_smoke.py`` at commit 504420a: the peaks
(``PEAK_BYTES_S``, ``PEAK_FLOPS``), ``bound`` and the byte and operation
counts of K1-K6 in its phases (``_k1_at``, ``phase_k2``/``phase_k3``'s K2
with its cell output and K3, ``_k6_at``, the K4/K5 phase): inputs read once,
outputs written once, the valid frames only where the kernel skips pad
frames.  Published peaks of one H100 SXM (NVIDIA's data sheet, dense, at
its 700 W limit).
"""

from __future__ import annotations

from typing import Iterable, List, Tuple

import numpy as np

PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}


def bound_ms(nbytes: float, flops: float, kind: str) -> float:
    """The least time the chip could take: the larger of bytes over the
    peak bandwidth and operations over the peak rate."""
    return 1e3 * max(nbytes / PEAK_BYTES_S, flops / PEAK_FLOPS[kind])


def window_nonzero(fe: dict) -> int:
    """Samples of an n_fft frame that K1's DFT runs over: those the centred
    periodic Hann window leaves non-zero (its first sample is 0), widened
    to whole 16-sample steps ([96, 416) for the default frontend)."""
    left = (fe["n_fft"] - fe["win_length"]) // 2
    lo, hi = (left + 1) // 16 * 16, -(-(left + fe["win_length"]) // 16) * 16
    return hi - lo


def k6_out_len(S: int, fe: dict) -> int:
    """Samples of K6's extended rows: the extension, or the frames' span."""
    ext = S + 2 * fe["pad"] + fe["n_fft"]
    T = (ext - fe["n_fft"]) // fe["hop_length"] + 1
    return max(ext, (T + -(-fe["n_fft"] // fe["hop_length"])) * fe["hop_length"])


def k1(B: int, T: int, fe: dict) -> float:
    """K1 (log-mel): the samples the frames cover, the DFT table over the
    window's non-zero samples and the mel table in bf16, log-mels out."""
    F, K, hop, n_fft = fe["n_fft"] // 2 + 1, window_nonzero(fe), fe["hop_length"], fe["n_fft"]
    span = (T - 1) * hop + n_fft
    nbytes = B * span * 4 + (2 * F * K + F * fe["n_mels"]) * 2 + B * T * fe["n_mels"] * 4
    flops = B * T * (2 * 2 * F * K + 3 * F + 2 * F * fe["n_mels"])
    return bound_ms(nbytes, flops, "bf16")


def k6(B: int, S: int, out_len: int) -> float:
    """K6 (preemphasis + extension): float32 waves and lengths in, the
    extended rows out; two operations a sample."""
    return bound_ms(B * S * 4 + B * 4 + B * out_len * 4, 2 * B * S, "fp32")


def k2(valid_steps: int, B: int, T: int, H: int, D: int) -> float:
    """K2 with its cell output (train mode): the valid frames' projections,
    W_hh and the lengths in; all of h and the valid frames' cell states
    out.  ``valid_steps``: the rows' valid frames summed, times D."""
    G = 4 * H
    nbytes = valid_steps * G * 4 + D * G * H * 4 + B * 4 + B * T * D * H * 4 + valid_steps * H * 4
    return bound_ms(nbytes, valid_steps * (2 * G * H + 2 * G + 5 * H), "fp32")


def k3(valid_steps: int, B: int, T: int, H: int, D: int) -> float:
    """K3: per valid step its projection, h_prev, c_prev and dh in; W_hh and
    the lengths in; all of d_xproj and dW_hh out; the gate recompute,
    dh_prev and dW_hh (2 4H H each) and ~30 a unit for the cell."""
    G = 4 * H
    nbytes = (valid_steps * (G + 3 * H) * 4 + D * G * H * 4 + B * 4 + B * T * D * G * 4
              + D * G * H * 4)
    return bound_ms(nbytes, valid_steps * (3 * 2 * G * H + 30 * H), "fp32")


def k4(frames: int, C: int, S: int, small: int) -> float:
    """K4 (CTC alpha): the valid frames' log-probs in, alpha of the valid
    frames out; per (frame, state) about 12 operations."""
    return bound_ms(frames * C * 4 + small + frames * S * 4, frames * S * 12, "fp32")


def k5(frames: int, C: int, S: int, small: int, grad_elems: int) -> float:
    """K5 (CTC beta): log-probs and alpha of the valid frames in, the whole
    emission gradient out; per (frame, state) about 16 operations."""
    return bound_ms(frames * C * 4 + frames * S * 4 + small + grad_elems * 4, frames * S * 16,
                    "fp32")


def output_frames(samples, S: int, fe: dict):
    """(mel frames of a batch padded to ``S`` samples, each row's output
    frames after the stride-2 stem, as the model recovers them:
    int(float32(T') * float32(frames / T))) for rows of ``samples``."""
    T = 1 + (S + 2 * fe["pad"]) // fe["hop_length"]
    frames = 1 + (np.asarray(samples, np.int64) + 2 * fe["pad"]) // fe["hop_length"]
    return T, (np.float32((T + 1) // 2) * (frames.astype(np.float32) / np.float32(T))).astype(
        np.int64)


# -- a whole model's FLOPs --------------------------------------------------
def conv_layers(cfg: dict) -> List[Tuple[int, int, int, int]]:
    """(in, out, k, groups) of every convolution of ``cfg``'s network, all
    of which produce frames at the model's output rate."""
    out = []

    def sep(cin, cout, k):
        out.extend([(cin, cin, k, cin), (cin, cout, 1, 1)])

    st = cfg["stem"]
    sep(st["in"], st["out"], st["k"])
    for blk in cfg["blocks"]:
        for _ in range(blk["repeat"] - 1):
            sep(blk["in"], blk["in"], blk["k"])
        sep(blk["in"], blk["out"], blk["k"])
        out.append((blk["in"], blk["out"], 1, 1))
    if cfg.get("last_cnn"):
        lc = cfg["last_cnn"]
        sep(lc["in"], lc["out"], lc["k"])
    out.append((cfg["last_conv"]["in"], cfg["last_conv"]["out"], 1, 1))
    out.append((cfg["decoder"]["in"], cfg["decoder"]["out"], 1, 1))
    return out


def flops_per_frame(cfg: dict) -> float:
    """Forward FLOPs of one output frame: every conv's 2 (in / groups) k
    out, and the BiLSTM's input projection and recurrence (2 4H (C + H) a
    direction)."""
    total = sum(2.0 * (cin // g) * k * cout for cin, cout, k, g in conv_layers(cfg))
    ctx = cfg.get("context")
    if ctx:
        H = ctx["hidden"]
        total += 2 * 2.0 * 4 * H * (ctx["in"] + H)
    return total


def model_flops(cfg: dict, valid_frames: Iterable[int], train: bool) -> float:
    """FLOPs of a step over rows of ``valid_frames`` output frames: the
    forward, and with ``train`` the backward at twice the forward."""
    return flops_per_frame(cfg) * float(sum(valid_frames)) * (3.0 if train else 1.0)
