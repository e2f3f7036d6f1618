"""Run one timing script over several checkouts of the repository in turns,
each in a process of its own with the kernels built from its own sources,
and print one JSON line a run and a summary line last.

A script calls ``main(__file__, run_one, argv)``: each argument names a
checkout root (for example the parent, unpacked with ``git archive`` into a
git-ignored directory, then the change, the change, the parent), and the
script runs again as ``<script> --one <root>`` from that root, where
``run_one(root)`` imports that checkout's modules and returns a dict.
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
from pathlib import Path


def digest(*tensors) -> str:
    """The first 16 hex digits of the sha256 of the tensors' bytes."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def cold_ms(fn, iters: int, flush) -> float:
    """Mean time of one call on the card by CUDA events, each call after a
    write of the tensor ``flush`` (64 MB evicts the 50 MB L2), so that the
    call finds its inputs in device memory."""
    import torch

    start = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    end = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    fn()
    for i in range(iters):
        flush.fill_(i)
        start[i].record()
        fn()
        end[i].record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in zip(start, end)) / iters


def use_checkout(root: Path) -> None:
    """Import this process's modules of the repository from ``root``."""
    sys.path.insert(0, str(root))


def assert_from(root: Path, *modules) -> None:
    """Each module was imported from checkout ``root``, no other."""
    for mod in modules:
        assert root.resolve() in Path(mod.__file__).resolve().parents, mod.__file__


def main(script: str, run_one, argv, doc: str) -> int:
    if len(argv) >= 2 and argv[0] == "--one":
        print(json.dumps(run_one(Path(argv[1]))), flush=True)
        return 0
    if not argv:
        print(doc, file=sys.stderr)
        return 2
    runs = []
    for root in (Path(a).resolve() for a in argv):
        proc = subprocess.run([sys.executable, str(Path(script).resolve()), "--one", str(root)],
                              capture_output=True, text=True, cwd=root)
        if proc.returncode != 0:
            print(proc.stdout, proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    print(json.dumps({"summary": [{"root": r["root"], **{k: v["ms"] for k, v in r.items()
                                                          if isinstance(v, dict) and "ms" in v}}
                                  for r in runs]}))
    return 0
