"""``mfu.train``'s reader at the Conformer's cell: the driver puts the
Conformer's FLOPs in the profiled stretch (``counts_conformer.py``: the
subsampling, every layer's projections, attention products and convs, and
the decoder, over each row's valid frames, the backward at twice the
forward) where ``train_step`` puts the QuartzNet's, over the stretch's
seconds and the H100's dense bf16 peak (989 TFLOP/s), in %."""

from pathlib import Path

from h100_bench.run import load_module

read = load_module(Path(__file__).with_name("mfu.train.py")).read
