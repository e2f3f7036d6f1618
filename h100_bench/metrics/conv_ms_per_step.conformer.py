"""``conv_ms_per_step.train``'s reader at the Conformer's cell: device
milliseconds a step, in the profiled stretch, of the "conv" group (the
frozen kernel categories of ``trace.py``): the subsampling's Conv2d, the
conv modules' depthwise and pointwise convs, forward and backward."""

from pathlib import Path

from h100_bench.run import load_module

read = load_module(Path(__file__).with_name("conv_ms_per_step.train.py")).read
