"""The model's FLOPs in the profiled stretch (the convolutions, the BiLSTM
and the decoder over each row's valid frames, the backward at twice the
forward) over the stretch's seconds and the H100's dense bf16 peak (989
TFLOP/s, ``counts.PEAK_FLOPS``), in %."""

from h100_bench.counts import PEAK_FLOPS


def read(rec: dict):
    tr = rec.get("trace")
    if not tr or not tr.get("flops") or tr["window_s"] <= 0:
        return None
    return 100.0 * tr["flops"] / tr["window_s"] / PEAK_FLOPS["bf16"]
