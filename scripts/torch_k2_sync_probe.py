"""Where the step of K2's pair walk at the LSTM head's H=128 goes, by the
way the two CTAs of a pair exchange h (``scripts/torch_k2_sync_probe.cu``):
the mbarrier exchange that ``csrc/lstm.cu`` ships, a ``barrier.cluster``
a step, and no exchange at all (the floor of a CTA's own work; its output
is wrong).  On ``chip_smoke.h128_kernels``' inputs (B=32, T'=836, input
width 1024, ragged rows) and at B=64 (64 rows of ``train_rows``' lengths),
each variant's ms by CUDA events over ITERS calls, whether its h and c are
the shipped kernel's bits, and the cycles a step of thread 0 of each CTA
in three phases (waiting for the partner's h; the dots and the cell; the
publish, the copies, the outputs and the barrier) from ``clock64``.

    python3 scripts/torch_k2_sync_probe.py

Prints the card's name and power limit, then one JSON line a batch size.
Needs a card and nvcc; imports no JAX.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from lightning_asr_torch.ops import kernel_build  # noqa: E402
from lightning_asr_torch.ops.lstm_kernels import PAIR_HIDDEN, lstm_recurrence  # noqa: E402

ITERS = 20
SOURCE = Path(__file__).with_suffix(".cu")
EXCHANGES = ("mbarrier", "cluster_barrier", "none")


def build() -> ctypes.CDLL:
    digest = hashlib.sha256(SOURCE.read_bytes())
    for header in sorted(kernel_build.CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    lib = kernel_build.BUILD_DIR / f"k2_sync_probe-{digest.hexdigest()[:16]}.so"
    if not lib.exists():
        kernel_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([kernel_build._nvcc(), *kernel_build.NVCC_FLAGS, "-o", str(lib), str(SOURCE)],
                       check=True)
    fn = ctypes.CDLL(str(lib)).lasr_k2_sync_probe
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    return fn


def run(fn, dev, B: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    T = chip_smoke.T_TRAIN
    _, (_, w_hh, _, _), lens_np, lens, xproj = chip_smoke.bilstm_inputs(dev, rng, B, T, C=1024,
                                                                        H=PAIR_HIDDEN)
    shipped = lambda: lstm_recurrence(xproj, lens, w_hh, with_cell=True)  # noqa: E731
    want_h, want_c = shipped()
    steps = int(lens_np.max())
    out = {"B": B, "sequential_steps": steps, "shipped_ms": chip_smoke.cuda_ms(shipped, ITERS)}
    h, c = torch.empty_like(want_h), torch.empty_like(want_c)
    prof = torch.zeros(4, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for i, name in enumerate(EXCHANGES):
        def call(profile: int = 0):
            err = fn(i, profile, xproj.data_ptr(), lens.data_ptr(), w_hh.data_ptr(), h.data_ptr(),
                     c.data_ptr(), B, T, 2, prof.data_ptr(), dev.index, stream)
            if err:
                raise RuntimeError(f"probe launch failed: CUDA error {err}")
        call()
        torch.cuda.synchronize()
        same = bool(torch.equal(h, want_h) and torch.equal(c, want_c))
        ms = chip_smoke.cuda_ms(call, ITERS)
        prof.zero_()
        call(1)
        cyc = prof.cpu().numpy().astype(np.float64)
        per = cyc[:3] / max(cyc[3], 1.0)
        out[name] = {"ms": ms, "us_per_step": 1e3 * ms / steps, "shipped_bits": same,
                     "cycles_per_step": {"wait": per[0], "dots_and_cell": per[1],
                                         "publish_and_barrier": per[2], "total": float(per.sum())}}
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    fn = build()
    for B, seed in ((chip_smoke.TRAIN_BATCH, 128), (2 * chip_smoke.TRAIN_BATCH, 64)):
        print(json.dumps(run(fn, dev, B, seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
