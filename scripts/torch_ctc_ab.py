"""Time the PyTorch port's CTC kernels of several checkouts in turns on one
NVIDIA card: K5 (``ctc_beta``) and K4 (``ctc_alpha``) at the training shape
(B=32, T'=836, C=29, S=513), on ragged rows with ~15 labels a second and
one impossible alignment (``chip_smoke.phase_k45``'s inputs) and on rows
that all fill T'.

Each checkout runs in a process of its own, with the kernels built from its
own sources.  Name them in the order to run, e.g. the parent (unpacked with
``git archive`` into a git-ignored directory), the change, the change, the
parent:

    python3 scripts/torch_ctc_ab.py build/archive/parent . . build/archive/parent

Prints one JSON line a run (ms by CUDA events over ITERS calls with warm
L2; ``cold_ms``, each call after a 64 MB write that evicts L2, as the
training step finds alpha; µs per sequential step; K5's device time by
kernel from torch.profiler; a digest of each kernel's outputs, alpha at
valid frames only, so that runs of checkouts show whether its bits moved)
and a summary line last.  Needs a card; imports no JAX.
"""

from __future__ import annotations

import sys
from pathlib import Path

from ab_checkouts import assert_from, cold_ms, digest, main, use_checkout

ITERS = 20
B, T = 32, 836


def run_one(root: Path) -> dict:
    """The timings of checkout ``root``, in this process."""
    use_checkout(root)
    import numpy as np
    import torch

    import chip_smoke
    import lightning_asr_torch
    from lightning_asr_torch.ops.ctc_kernels import ctc_alpha, ctc_beta

    assert_from(root, chip_smoke, lightning_asr_torch)
    dev = torch.device("cuda", 0)
    C, blank = len(chip_smoke.LABELS) + 1, chip_smoke.BLANK
    rng = np.random.default_rng(4)
    seconds, _, ragged = chip_smoke.train_rows(rng, B)
    targets_np, tl_np = chip_smoke.train_targets(rng, seconds)
    tl_np[-1] = ragged[-1] + 10                  # more labels than frames: impossible
    logits = torch.from_numpy((rng.standard_normal((B, T, C)) * 2).astype(np.float32)).to(dev)
    lp = torch.log_softmax(logits, dim=-1).contiguous()
    tg, tl = (torch.from_numpy(a).to(dev) for a in (targets_np, tl_np))
    gbar = torch.full((B,), 1.0 / B, device=dev)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    out = {"root": str(root), "card": torch.cuda.get_device_name(0),
           "S": 2 * targets_np.shape[1] + 1}
    for rows, lens_np in (("ragged", ragged), ("full", np.full(B, T, np.int32))):
        il = torch.from_numpy(lens_np).to(dev)
        alpha, ll = ctc_alpha(lp, il, tg, tl, blank)
        k4 = lambda: ctc_alpha(lp, il, tg, tl, blank)  # noqa: E731
        k5 = lambda: ctc_beta(lp, il, tg, tl, alpha, ll, gbar, blank)  # noqa: E731
        steps = int(lens_np.max())
        ms = {"K5": chip_smoke.cuda_ms(k5, ITERS), "K4": chip_smoke.cuda_ms(k4, ITERS)}
        cold = {"K5": cold_ms(k5, ITERS, flush), "K4": cold_ms(k4, ITERS, flush)}
        try:
            split = chip_smoke.device_time(k5, 5)[2]
        except SystemExit as e:                 # the profiler saw no kernel: leave the split out
            split = {"none": str(e)}
        valid = (torch.arange(T, device=dev)[None, :] < il[:, None])[:, :, None]
        out[rows] = {"ms": ms, "cold_ms": cold, "sequential_steps": steps,
                     "us_per_step": {k: 1e3 * v / steps for k, v in ms.items()},
                     "K5_split_ms": {k.replace("(anonymous namespace)::", "")[:60]: v
                                     for k, v in split.items()},
                     "digest": {"K5": digest(k5()), "K4": digest(torch.where(valid, alpha, 0.0), ll)}}
    return out


if __name__ == "__main__":
    sys.exit(main(__file__, run_one, sys.argv[1:], __doc__))
