"""Shared set-up of the benchmark's own tests: the repository root on the
path, and a cell's driver run on the CPU at a tiny size of its mix (the
harness's look for a card skipped)."""

from __future__ import annotations

import argparse
import copy
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())

# each kind of mix cut to a size the CPU runs in seconds
TINY_MIX = {
    "buckets": {"rows": 2, "buckets": [[1.3, 0.3], [1.6, 0.3], [2.0, 0.4]], "cycle_batches": 3,
                "loss_every": 2},
}


def cell_parts(cell: str):
    """(configuration, mix) of a cell, as the harness finds them."""
    from h100_bench import run

    found = run.cell_of(BENCH, cell)
    return found["cfg"], found["mix"]


def tiny(cell: str, f32: bool = False):
    """A cell's configuration and its mix cut to ``TINY_MIX``'s size (the
    configuration's widths untouched); with ``f32`` the program's
    convolutions and frontend in float32, where a sound run reads what the
    plain reference does to round-off."""
    cfg, mix = cell_parts(cell)
    cfg = copy.deepcopy(cfg)
    if f32:
        cfg["build_model"]["compute_dtype"] = "f32"
        cfg["frontend"]["precision"] = "highest"
    return cfg, {**mix, **TINY_MIX[mix["kind"]]}


def run_tiny(cell: str, seed: int, tmp_path, trace: int = 0, seconds: float = 2.0,
             f32: bool = False) -> dict:
    """The cell's driver on the CPU at ``tiny`` size; returns the result's
    JSON as the harness prints it."""
    import torch

    from h100_bench import run

    cfg, mix = tiny(cell, f32)
    args = argparse.Namespace(workload=cell, seed=seed, seconds=seconds, trace=trace)
    ctx = {"args": args, "cell": {"name": cell}, "cfg": cfg, "mix": mix,
           "device": torch.device("cpu"), "chips": 1, "since_start": run.since_start,
           "tmp": Path(tmp_path)}
    out = run.load_module(ROOT / "h100_bench" / "drivers" / f"{mix['driver']}.py").run(ctx)
    return run.result_line(BENCH, args, out)


@pytest.fixture
def cuda_device():
    """The first card, or a skip where there is none (decided here, when
    the test runs, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (on the card: python -m pytest -m cuda h100_bench/tests)")
    return torch.device("cuda", 0)
