"""Time the PyTorch port's BiLSTM kernels of several checkouts in turns on one
NVIDIA card: K2 (``lstm_recurrence``) at the serving shape (B=8, T=801,
h only, ``chip_smoke.phase_k2``'s lengths and inputs); then K8
(``lstm_backward_stacked``, the wrapper with its row sum), and on the same
inputs K3 (``lstm_backward``), K2 with its cell output and K7, at the
training shape (B=32, T'=836, C=256, H=40) on ragged rows
(``chip_smoke.train_rows``) and on rows that all fill T'; then K2, K3, K7 and K8
at the LSTM head's H=128 on ``chip_smoke.h128_kernels``' inputs (B=32,
T'=836, C=1024, ragged rows), K2 with and without its cell output, K2's,
K3's, K7's and K8's device time split by kernel, and K2 with its cell
output and K7 at B=64 (``h128_b64``: 64 rows of ``train_rows``' lengths),
where their pair walks need 128 clusters of two CTAs.

Each checkout runs in a process of its own, with the kernels built from its
own sources and its own ``chip_smoke.py``'s row lengths.  Name them in the
order to run, e.g. the parent (unpacked with ``git archive`` into a
git-ignored directory), the change, the change, the parent:

    python3 scripts/torch_lstm_ab.py build/archive/parent . . build/archive/parent

Prints one JSON line a run (the card's name and power limit from
``nvidia-smi``; ms by CUDA events over ITERS calls with warm
L2; K2's ``cold_ms``, each call after a 64 MB write that evicts L2; µs per
sequential step; K8's device time by kernel from torch.profiler; the
registers and spills of the BiLSTM forward kernels from ptxas; and a
digest of each kernel's outputs, so that runs of checkouts that share a
kernel show whether its bits moved; K3's and K8's registers and spills at
both hidden sizes; at H=128 the resident clusters of K8's walk and dW
pass, and of K2's and K7's walks, where the checkout has them) and a
summary line last.  Needs a card; imports no JAX.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

from ab_checkouts import assert_from, cold_ms, digest, main, use_checkout

ITERS = 20
B, T, C, H = 32, 836, 256, 40
# the serving shape and row lengths of chip_smoke.phase_k2
SERVE_B, SERVE_T = 8, 801
SERVE_LENGTHS = (801, 1, 750, 640, 512, 401, 233, 97)


def run_one(root: Path) -> dict:
    """The timings of checkout ``root``, in this process."""
    use_checkout(root)
    import numpy as np
    import torch

    import chip_smoke
    import lightning_asr_torch
    from lightning_asr_torch.ops import kernel_build, lstm_kernels
    from lightning_asr_torch.ops.lstm import stack_directions, stacked_valid
    from lightning_asr_torch.ops.lstm_kernels import (lstm_backward, lstm_backward_stacked,
                                                      lstm_recurrence, lstm_recurrence_stacked)

    assert_from(root, chip_smoke, lightning_asr_torch)           # this checkout's, no other
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    reports = kernel_build.build_all()["ptxas"]
    ptxas = {k: v for name in ("lstm", "lstm_bidir")
             for k, v in chip_smoke.ptxas_kernels(reports.get(name, "")).items() if "fwd" in k}
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    out = {"root": str(root), "card": torch.cuda.get_device_name(0), "nvidia_smi": smi,
           "ptxas": ptxas,
           "K3_ptxas": chip_smoke.ptxas_kernels(reports.get("lstm_bwd", "")),
           "K8_ptxas": {k: v for k, v in chip_smoke.ptxas_kernels(reports.get("lstm_bidir", "")).items()
                        if k.startswith("lstm_stacked_") and "fwd" not in k}}

    rng = np.random.default_rng(1)
    s = 1.0 / np.sqrt(H)
    x = torch.from_numpy(rng.standard_normal((SERVE_B, SERVE_T, C)).astype(np.float32)).to(dev)
    w_ih, w_hh, b_ih, b_hh = (torch.from_numpy(rng.uniform(-s, s, shape).astype(np.float32)).to(dev)
                              for shape in ((2, 4 * H, C), (2, 4 * H, H), (2, 4 * H), (2, 4 * H)))
    xproj = (torch.matmul(x, w_ih.reshape(8 * H, C).t()) + b_ih.reshape(-1)
             + b_hh.reshape(-1)).reshape(SERVE_B, SERVE_T, 2, 4 * H).contiguous()
    lens = torch.tensor(SERVE_LENGTHS, dtype=torch.int32, device=dev)
    k2 = lambda: lstm_recurrence(xproj, lens, w_hh)  # noqa: E731
    ms = chip_smoke.cuda_ms(k2, ITERS)
    out["serving"] = {"ms": {"K2": ms}, "cold_ms": {"K2": cold_ms(k2, ITERS, flush)},
                      "sequential_steps": SERVE_T, "us_per_step": {"K2": 1e3 * ms / SERVE_T},
                      "digest": {"K2_h": digest(k2())}}

    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((B, T, C)).astype(np.float32)).to(dev)
    w_ih, w_hh, bias = (torch.from_numpy(rng.uniform(-s, s, shape).astype(np.float32)).to(dev)
                        for shape in ((2, 4 * H, C), (2, 4 * H, H), (2, 4 * H)))
    xproj = (torch.matmul(x, w_ih.reshape(8 * H, C).t()) + bias.reshape(-1)).reshape(B, T, 2, 4 * H)
    grad_h = torch.from_numpy(rng.standard_normal((B, T, 2 * H)).astype(np.float32)).to(dev)
    xp = stack_directions(xproj).contiguous()
    gs = stack_directions(grad_h.reshape(B, T, 2, H)).contiguous()
    w_f, w_b = w_hh[0].contiguous(), w_hh[1].contiguous()
    for rows, lens_np in (("ragged", chip_smoke.train_rows(rng, B)[2]),
                          ("full", np.full(B, T, np.int32))):
        lens = torch.from_numpy(lens_np).to(dev)
        valid = stacked_valid(T, lens)
        h7 = lstm_recurrence_stacked(xp, valid, w_f, w_b)
        k8 = lambda: lstm_backward_stacked(xp, valid, w_f, w_b, h7[1], h7[2], gs)  # noqa: E731
        h2, cell = lstm_recurrence(xproj, lens, w_hh, with_cell=True)
        k3 = lambda: lstm_backward(xproj, lens, w_hh, h2, cell, grad_h)  # noqa: E731
        k2c = lambda: lstm_recurrence(xproj, lens, w_hh, with_cell=True)  # noqa: E731
        steps = int(lens_np.max())
        ms = {"K8": chip_smoke.cuda_ms(k8, ITERS), "K3": chip_smoke.cuda_ms(k3, ITERS),
              "K2_with_cell": chip_smoke.cuda_ms(k2c, ITERS),
              "K7": chip_smoke.cuda_ms(lambda: lstm_recurrence_stacked(xp, valid, w_f, w_b), ITERS)}
        try:
            split = chip_smoke.device_time(k8, 5)[2]
        except SystemExit as e:                 # the profiler saw no kernel: leave the split out
            split = {"none": str(e)}
        out[rows] = {"ms": ms, "cold_ms": {"K2_with_cell": cold_ms(k2c, ITERS, flush)},
                     "sequential_steps": steps,
                     "us_per_step": {k: 1e3 * v / steps for k, v in ms.items()},
                     "K8_split_ms": {k.replace("(anonymous namespace)::", "")[:60]: v
                                     for k, v in split.items()},
                     "digest": {"K8": digest(*k8()), "K3": digest(*k3()), "K2_h": digest(h2),
                                "K2_c": digest(cell), "K7": digest(*h7)}}

    rng = np.random.default_rng(128)
    H128 = chip_smoke.HEAD_HIDDEN
    _, (_, w_hh, _, _), lens_np, lens, xproj = chip_smoke.bilstm_inputs(dev, rng, B, T, C=1024,
                                                                        H=H128)
    grad_h = torch.from_numpy(rng.standard_normal((B, T, 2 * H128)).astype(np.float32)).to(dev)
    h2, cell = lstm_recurrence(xproj, lens, w_hh, with_cell=True)
    k3 = lambda: lstm_backward(xproj, lens, w_hh, h2, cell, grad_h)  # noqa: E731
    xp = stack_directions(xproj).contiguous()
    valid = stacked_valid(T, lens)
    gs = stack_directions(grad_h.reshape(B, T, 2, H128)).contiguous()
    w_f, w_b = w_hh[0].contiguous(), w_hh[1].contiguous()
    h7 = lstm_recurrence_stacked(xp, valid, w_f, w_b)
    k8 = lambda: lstm_backward_stacked(xp, valid, w_f, w_b, h7[1], h7[2], gs)  # noqa: E731
    k2 = lambda: lstm_recurrence(xproj, lens, w_hh, with_cell=True)  # noqa: E731
    steps = int(lens_np.max())
    k7 = lambda: lstm_recurrence_stacked(xp, valid, w_f, w_b)  # noqa: E731
    ms = {"K2_with_cell": chip_smoke.cuda_ms(k2, ITERS),
          "K2": chip_smoke.cuda_ms(lambda: lstm_recurrence(xproj, lens, w_hh), ITERS),
          "K3": chip_smoke.cuda_ms(k3, ITERS), "K7": chip_smoke.cuda_ms(k7, ITERS),
          "K8": chip_smoke.cuda_ms(k8, ITERS)}
    splits = {}
    for key, fn in (("K2", k2), ("K3", k3), ("K7", k7), ("K8", k8)):
        try:
            split = chip_smoke.device_time(fn, 5)[2]
        except SystemExit as e:
            split = {"none": str(e)}
        splits[f"{key}_split_ms"] = {k.replace("(anonymous namespace)::", "")[:60]: v
                                     for k, v in split.items()}
    out["h128"] = {"ms": ms, "sequential_steps": steps,
                   "us_per_step": {k: 1e3 * v / steps for k, v in ms.items()}, **splits,
                   "digest": {"K3": digest(*k3()), "K8": digest(*k8()), "K2_h": digest(h2),
                              "K2_c": digest(cell), "K7": digest(*h7),
                              "K2_h_only": digest(lstm_recurrence(xproj, lens, w_hh))}}
    clusters = getattr(lstm_kernels, "stacked_backward_clusters_on_card", None)
    if clusters is not None:                    # the checkout's K8 walks at H=128 on a pair
        out["h128"]["K8_resident_clusters"] = {"walk": clusters(dev), "dw": clusters(dev, True),
                                               "walk_needed": 2 * B}
    clusters = getattr(lstm_kernels, "forward_clusters_on_card", None)
    if clusters is not None:                    # the checkout's K2 walks at H=128 on a pair
        out["h128"]["K2_resident_clusters"] = {"walk": clusters(dev), "walk_needed": 2 * B}
    clusters = getattr(lstm_kernels, "stacked_forward_clusters_on_card", None)
    if clusters is not None:                    # the checkout's K7 walks at H=128 on a pair
        out["h128"]["K7_resident_clusters"] = {"walk": clusters(dev), "walk_needed": 2 * B}

    B64 = 2 * B
    _, (_, w_hh, _, _), lens_np, lens, xproj = chip_smoke.bilstm_inputs(
        dev, np.random.default_rng(64), B64, T, C=1024, H=H128)
    k2 = lambda: lstm_recurrence(xproj, lens, w_hh, with_cell=True)  # noqa: E731
    xp = stack_directions(xproj).contiguous()
    valid = stacked_valid(T, lens)
    w_f, w_b = w_hh[0].contiguous(), w_hh[1].contiguous()
    k7 = lambda: lstm_recurrence_stacked(xp, valid, w_f, w_b)  # noqa: E731
    ms = {"K2_with_cell": chip_smoke.cuda_ms(k2, ITERS), "K7": chip_smoke.cuda_ms(k7, ITERS)}
    steps = int(lens_np.max())
    out["h128_b64"] = {"ms": ms, "sequential_steps": steps,
                       "us_per_step": {k: 1e3 * v / steps for k, v in ms.items()},
                       "digest": {"K2_h": digest(k2()[0]), "K2_c": digest(k2()[1]),
                                  "K7": digest(*k7())}}
    return out


if __name__ == "__main__":
    sys.exit(main(__file__, run_one, sys.argv[1:], __doc__))
