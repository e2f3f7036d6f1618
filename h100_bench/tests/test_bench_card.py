"""On the card only (``-m cuda``): each one-card cell runs end to end for a
few seconds and comes out correct, and its control fails a limit at the
cell's own size."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT

ONE_CARD = [w["name"] for w in BENCH["workloads"] if w["chips"] == 1]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ONE_CARD)
def test_cell_runs_correct(cell, cuda_device):
    out = subprocess.run([sys.executable, "h100_bench/run.py", "--workload", cell, "--seed",
                          str(2 ** 31 + 77), "--seconds", "3", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ONE_CARD)
def test_control_fails_on_the_card(cell, cuda_device):
    out = subprocess.run([sys.executable, "h100_bench/controls.py", "--workload", cell,
                          "--seeds", str(2 ** 31 + 78)], cwd=ROOT, capture_output=True,
                         text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["fails"]
