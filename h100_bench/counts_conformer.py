"""Operations and bytes of a Conformer-CTC configuration
(``reference/conformer.py``): its FLOPs over each row's valid frames, and
the roofline bound of the hand kernels its train step calls (K6 and K1 on
the waves, K4 and K5 on the CTC), by ``counts.py``'s frozen counts.

The subsampling's two stride-2 convs give T' = ceil(ceil(T / 2) / 2)
output frames from T mel frames; a row's valid output frames are
int(float32(T') * float32(frames / T)), as the model recovers them.
"""

from __future__ import annotations

from typing import Iterable, Tuple

import numpy as np

from h100_bench import counts
from h100_bench.reference.conformer import subsampled


def output_frames(samples, S: int, fe: dict) -> Tuple[int, np.ndarray]:
    """(mel frames of a batch padded to ``S`` samples, each row's valid
    output frames) for rows of ``samples``."""
    T = 1 + (S + 2 * fe["pad"]) // fe["hop_length"]
    frames = 1 + (np.asarray(samples, np.int64) + 2 * fe["pad"]) // fe["hop_length"]
    return T, (np.float32(subsampled(T)) * (frames.astype(np.float32) / np.float32(T))).astype(
        np.int64)


def frame_flops(cfg: dict) -> float:
    """Forward FLOPs of one output frame, apart from the attention's
    products between frames: the subsampling's two convs (the first's two
    rows of output per output frame, one input channel) and its Linear; in
    each layer the two FFNs, the q, k, v and out projections, the conv
    module's pointwise and depthwise convs; the decoder."""
    enc = cfg["encoder"]
    d, c, ff, k = enc["d_model"], enc["subsampling_conv_channels"], enc["d_ff"], \
        enc["conv_kernel_size"]
    f1, f2 = (enc["feat_in"] - 1) // 2 + 1, subsampled(enc["feat_in"])
    sub = 2 * f1 * c * 2 * 9 + f2 * c * c * 2 * 9 + 2 * c * f2 * d
    layer = 2 * (2 * 2 * d * ff) + 4 * 2 * d * d + 2 * d * 2 * d + 2 * d * k + 2 * d * d
    return float(sub + enc["n_layers"] * layer + 2 * d * cfg["num_classes"])


def model_flops(cfg: dict, valid_frames: Iterable[int], train: bool) -> float:
    """FLOPs of a step over rows of ``valid_frames`` output frames: per
    frame ``frame_flops``; per row of n frames and layer the scores' two
    products ((q + u) k^T and (q + v) p^T against the 2n - 1 positions) and
    the weights times v; per layer once the position projection of the
    longest row's 2n - 1 positions; with ``train`` the backward at twice
    the forward."""
    enc = cfg["encoder"]
    d, layers = enc["d_model"], enc["n_layers"]
    n = np.asarray(list(valid_frames), np.float64)
    att = float(np.sum(2 * n * n * d + 2 * n * (2 * n - 1) * d + 2 * n * n * d))
    pos = 2.0 * d * d * (2 * float(n.max()) - 1) if n.size else 0.0
    fwd = frame_flops(cfg) * float(n.sum()) + layers * (att + pos)
    return fwd * (3.0 if train else 1.0)


def hand_bound_ms(waves_shape, wave_lens, target_width: int, cfg: dict) -> float:
    """The roofline bound of K1, K4, K5 and K6's calls in one step on a
    batch of ``waves_shape`` (B, S) with ``wave_lens``, targets padded to
    ``target_width``."""
    fe = cfg["frontend"]
    B, S = waves_shape
    T, out = output_frames(wave_lens, S, fe)
    total = counts.k6(B, S, counts.k6_out_len(S, fe)) + counts.k1(B, T, fe)
    C, L = cfg["num_classes"], target_width
    small = (B * L + 3 * B) * 4
    total += counts.k4(int(out.sum()), C, 2 * L + 1, small)
    total += counts.k5(int(out.sum()), C, 2 * L + 1, small, B * subsampled(T) * C)
    return total
