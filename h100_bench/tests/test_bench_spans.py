"""``spans.py``: a hand-built Chrome trace puts launches, device ms and idle
gaps down to the right span, and gaps launched outside every span to
``unspanned``; on the CPU, at a tiny size of the training mix, ``collect``
after the driver's ``--trace 1`` stretches records each phase once a step
and leaves what the existing metrics read as it was."""

from __future__ import annotations

import argparse
from pathlib import Path

import pytest
import torch

from conftest import BENCH, ROOT, tiny

CELL = "qn12ctx.train.libri"


def _x(cat, name, ts, dur, corr=None):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


def test_read_spans_by_hand():
    from h100_bench.spans import read_spans, readings

    events = [
        _x("user_annotation", "lasr/train_step", 0, 100),
        _x("user_annotation", "lasr/train_step/forward", 10, 30),
        _x("user_annotation", "lasr/train_step/update", 60, 30),
        _x("user_annotation", "not_ours", 0, 200),
        _x("cuda_runtime", "cudaLaunchKernel", 5, 1, 1),       # train_step's own
        _x("cuda_runtime", "cudaLaunchKernel", 20, 1, 2),      # forward
        _x("cuda_driver", "cuLaunchKernelEx", 70, 1, 3),       # update
        _x("cuda_runtime", "cudaMemcpyAsync", 120, 1, 4),      # no span, not a launch
        _x("cuda_runtime", "cudaLaunchKernel", 110, 1, 5),     # no span
        _x("kernel", "k1", 30, 5, 1),
        _x("kernel", "k2", 40, 10, 2),                          # ends the gap 35-40
        _x("kernel", "k3", 80, 2, 3),                           # ends the gap 50-80
        _x("gpu_memcpy", "Memcpy HtoD", 130, 1, 4),             # ends the gap 82-130
        _x("kernel", "k5", 140, 1, 5),                          # ends the gap 131-140
    ]
    out = read_spans(events, steps=2)
    ph = out["phases"]
    assert set(ph) == {"train_step", "train_step/forward", "train_step/update"}
    assert [ph[n]["launches"] for n in ("train_step", "train_step/forward",
                                        "train_step/update")] == [0.5, 0.5, 0.5]
    assert ph["train_step"]["device_ms"] == pytest.approx(0.005 / 2)
    assert ph["train_step/forward"]["device_ms"] == pytest.approx(0.010 / 2)
    assert ph["train_step/forward"]["idle_ms"] == pytest.approx(0.005 / 2)
    assert ph["train_step/update"]["idle_ms"] == pytest.approx(0.030 / 2)
    assert ph["train_step"]["idle_ms"] == 0
    assert out["unspanned"] == pytest.approx({"launches": 0.5, "device_ms": 0.002 / 2,
                                              "idle_ms": (0.048 + 0.009) / 2})
    assert out["launches"] == out["records"] == 4 and out["complete"]
    got = readings(out)
    assert got["launches_per_step.train"] == 1.5
    assert got["update_idle_ms.train"] == pytest.approx(0.015)
    assert got["features_host_ms.train"] is None


def test_collect_after_the_traced_stretches_on_the_cpu(tmp_path):
    from h100_bench import run, spans

    cfg, mix = tiny(CELL)
    args = argparse.Namespace(workload=CELL, seed=2 ** 31 + 7, seconds=1.0, trace=1)
    ctx = {"args": args, "cell": {"name": CELL}, "cfg": cfg, "mix": mix,
           "device": torch.device("cpu"), "chips": 1, "since_start": run.since_start,
           "tmp": Path(tmp_path)}
    driver = run.load_module(ROOT / "h100_bench" / "drivers" / f"{mix['driver']}.py")
    loop = driver.Loop(ctx)
    records = driver.measure(loop, ctx)
    readers = {m["name"]: run.load_module(ROOT / "h100_bench" / "metrics" / f"{m['name']}.py")
               for m in run.metrics_of(BENCH, CELL, True)}
    before = {n: r.read(records) for n, r in readers.items()}
    sp = spans.collect(loop)
    assert {n: r.read(records) for n, r in readers.items()} == before
    assert "spans" not in records
    steps = len(loop.cycle)
    ph = sp["phases"]
    assert sp["host_steps"] == steps
    assert {n for n in ph if n.startswith("train_step")} == {
        "train_step", *(f"train_step/{p}" for p in ("features", "forward", "backward", "update"))}
    assert all(ph[n]["host_ms"] > 0 for n in ph if n != "train_step")
    assert ph["train_step"]["host_ms"] >= 0
    got = spans.readings(sp)
    assert all(got[f"{p}_host_ms.train"] > 0 for p in ("features", "forward", "backward",
                                                      "update"))
