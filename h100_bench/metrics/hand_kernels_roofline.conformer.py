"""``hand_kernels_roofline.train``'s reader at the Conformer's cell: the
roofline-bound time of K1, K4, K5 and K6's calls in the profiled stretch
(``counts_conformer.hand_bound_ms``, from each step's inputs, against the
H100's published peaks) over their device time, in %; the Conformer runs
no K2 or K3."""

from pathlib import Path

from h100_bench.run import load_module

read = load_module(Path(__file__).with_name("hand_kernels_roofline.train.py")).read
