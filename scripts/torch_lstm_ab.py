"""Time the PyTorch port's BiLSTM kernels of several checkouts in turns on one
NVIDIA card: K8 (``lstm_backward_stacked``, the wrapper with its row sum),
and on the same inputs K3 (``lstm_backward``), K2 with its cell output and
K7, at the training shape (B=32, T'=836, C=256, H=40) on ragged rows
(``chip_smoke.train_rows``) and on rows that all fill T'.

Each checkout runs in a process of its own, with the kernels built from its
own sources and its own ``chip_smoke.py``'s row lengths.  Name them in the
order to run, e.g. the parent (unpacked with ``git archive`` into a
git-ignored directory), the change, the change, the parent:

    python3 scripts/torch_lstm_ab.py build/archive/parent . . build/archive/parent

Prints one JSON line a run (ms by CUDA events over ITERS calls, µs per
sequential step, K8's device time by kernel from torch.profiler, and a
digest of each kernel's outputs, so that runs of checkouts that share a
kernel show whether its bits moved) and a summary line last.  Needs a card;
imports no JAX.
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
from pathlib import Path

ITERS = 20
B, T, C, H = 32, 836, 256, 40


def _digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def run_one(root: Path) -> dict:
    """The timings of checkout ``root``, in this process."""
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    import chip_smoke
    import lightning_asr_torch
    from lightning_asr_torch.ops.lstm import stack_directions, stacked_valid
    from lightning_asr_torch.ops.lstm_kernels import (lstm_backward, lstm_backward_stacked,
                                                      lstm_recurrence, lstm_recurrence_stacked)

    for mod in (chip_smoke, lightning_asr_torch):                 # this checkout's, no other
        assert root.resolve() in Path(mod.__file__).resolve().parents, mod.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(7)
    s = 1.0 / np.sqrt(H)
    x = torch.from_numpy(rng.standard_normal((B, T, C)).astype(np.float32)).to(dev)
    w_ih, w_hh, bias = (torch.from_numpy(rng.uniform(-s, s, shape).astype(np.float32)).to(dev)
                        for shape in ((2, 4 * H, C), (2, 4 * H, H), (2, 4 * H)))
    xproj = (torch.matmul(x, w_ih.reshape(8 * H, C).t()) + bias.reshape(-1)).reshape(B, T, 2, 4 * H)
    grad_h = torch.from_numpy(rng.standard_normal((B, T, 2 * H)).astype(np.float32)).to(dev)
    xp = stack_directions(xproj).contiguous()
    gs = stack_directions(grad_h.reshape(B, T, 2, H)).contiguous()
    w_f, w_b = w_hh[0].contiguous(), w_hh[1].contiguous()
    out = {"root": str(root), "card": torch.cuda.get_device_name(0)}
    for rows, lens_np in (("ragged", chip_smoke.train_rows(rng, B)[2]),
                          ("full", np.full(B, T, np.int32))):
        lens = torch.from_numpy(lens_np).to(dev)
        valid = stacked_valid(T, lens)
        h7 = lstm_recurrence_stacked(xp, valid, w_f, w_b)
        k8 = lambda: lstm_backward_stacked(xp, valid, w_f, w_b, h7[1], h7[2], gs)  # noqa: E731
        h2, cell = lstm_recurrence(xproj, lens, w_hh, with_cell=True)
        k3 = lambda: lstm_backward(xproj, lens, w_hh, h2, cell, grad_h)  # noqa: E731
        steps = int(lens_np.max())
        ms = {"K8": chip_smoke.cuda_ms(k8, ITERS), "K3": chip_smoke.cuda_ms(k3, ITERS),
              "K2_with_cell": chip_smoke.cuda_ms(
                  lambda: lstm_recurrence(xproj, lens, w_hh, with_cell=True), ITERS),
              "K7": chip_smoke.cuda_ms(lambda: lstm_recurrence_stacked(xp, valid, w_f, w_b), ITERS)}
        try:
            split = chip_smoke.device_time(k8, 5)[2]
        except SystemExit as e:                 # the profiler saw no kernel: leave the split out
            split = {"none": str(e)}
        out[rows] = {"ms": ms, "sequential_steps": steps,
                     "us_per_step": {k: 1e3 * v / steps for k, v in ms.items()},
                     "K8_split_ms": {k.replace("(anonymous namespace)::", "")[:60]: v
                                     for k, v in split.items()},
                     "digest": {"K8": _digest(*k8()), "K3": _digest(*k3()), "K2_with_cell": _digest(h2, cell),
                                "K7": _digest(*h7)}}
    return out


def main(argv) -> int:
    if len(argv) >= 2 and argv[0] == "--one":
        print(json.dumps(run_one(Path(argv[1]))), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    runs = []
    for root in (Path(a).resolve() for a in argv):
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--one", str(root)],
                              capture_output=True, text=True, cwd=root)
        if proc.returncode != 0:
            print(proc.stdout, proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    print(json.dumps({"summary": [{"root": r["root"], **{rows: r[rows]["ms"] for rows in ("ragged", "full")}}
                                  for r in runs]}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
