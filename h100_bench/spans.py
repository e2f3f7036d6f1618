"""The port's spans inside the train step (``lightning_asr_torch/training/
profiler.py``; ``train_step`` and its phases ``features``, ``forward``,
``backward``, ``all_reduce``, ``update``), read on a cell's state after its
``--trace 1`` stretches, from the cycle's current place:

  (a) host phases: one more whole cycle of the mix, untimed, with the
      program's tracing on and no profiler: each span's host ms a step;
  (b) device phases: one more whole cycle under torch.profiler with the
      program's tracing on, under ``trace.py``'s launch check (the stretch
      halved after a pass that fails it).  From the Chrome trace, for each
      ``lasr/`` annotation: the kernel launches whose start lies inside it,
      the device ms of the operations whose runtime call lies inside it,
      and the idle device ms put down to it: each gap in the union of the
      device's operations goes to the span that holds the runtime call of
      the operation that ends the gap.  Launches, operations and gaps
      outside every span go to ``unspanned``.

Every number is a step's, and a span's own: a runtime call belongs to the
innermost span around it, and a span's host ms leave out its children's
(``SimpleProfiler.self_seconds``), so the phases and ``unspanned`` share
the stretch out between them.  ``readings`` gives the per-layer numbers
these records hold, under the names PERF.md gives them.

    python3 h100_bench/spans.py --workload qn12ctx.train.libri --seed 2147483659 --seconds 51

runs the cell's set-up and its driver's ``--trace 1`` stretches (the
program's tracing off there, as in the harness's traced run), then (a) and
(b), and prints as its last line the cell's per-layer metrics from the
driver's records, the spans' records and their readings, and the cost of
tracing on: the host ms a step of the driver's untraced cycle beside
(a)'s, and of cycles with tracing off and on in turns, before torch.profiler
first runs in the process and after.
No driver calls ``collect``: the harness's records hold no spans.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from h100_bench import outcome, run  # noqa: E402
from h100_bench.trace import MISSING_SHARE, _union  # noqa: E402
from lightning_asr_torch.training.profiler import (ANNOTATION_PREFIX,  # noqa: E402
                                                   SimpleProfiler, tracing)

STEP = "train_step"
UNSPANNED = "unspanned"


def _zero() -> dict:
    return {"launches": 0, "device_ms": 0.0, "idle_ms": 0.0}


def _innermost(spans: list):
    """``where(t)``: the name of the innermost of ``spans`` ([(start, end,
    name)], nested as one thread opens them) that holds ``t``, else
    ``UNSPANNED``."""
    bounds = sorted([(s, 1, i) for i, (s, _, _) in enumerate(spans)]
                    + [(e, 0, i) for i, (_, e, _) in enumerate(spans)])
    open_, times, names = [], [], []
    for t, starts, i in bounds:
        if starts:
            open_.append(i)
        else:
            open_.remove(i)
        times.append(t)
        names.append(spans[open_[-1]][2] if open_ else UNSPANNED)

    def where(t: float) -> str:
        k = bisect.bisect_right(times, t) - 1
        return names[k] if k >= 0 else UNSPANNED
    return where


def read_spans(events: list, steps: int) -> dict:
    """(b) from a Chrome trace's events over ``steps`` steps: ``phases``
    {span name: {launches, device_ms, idle_ms}} and ``unspanned`` (a step
    each), the stretch's ``launches`` and kernel ``records``, and
    ``complete`` (``trace.py``'s launch check)."""
    spans, runtime, device, launches = [], {}, [], []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        if cat == "user_annotation" and name.startswith(ANNOTATION_PREFIX):
            s = float(ev["ts"])
            spans.append((s, s + float(ev.get("dur", 0.0)), name[len(ANNOTATION_PREFIX):]))
        elif cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            device.append(ev)
        elif cat in ("cuda_runtime", "cuda_driver"):
            if "LaunchKernel" in name or "cuLaunch" in name:
                launches.append(float(ev["ts"]))
            corr = (ev.get("args") or {}).get("correlation")
            if corr is not None:
                runtime[corr] = float(ev["ts"])
    where = _innermost(spans)
    phases = {name: _zero() for _, _, name in spans}
    phases[UNSPANNED] = _zero()

    def launched(ev) -> str:
        t = runtime.get((ev.get("args") or {}).get("correlation"))
        return UNSPANNED if t is None else where(t)

    for t in launches:
        phases[where(t)]["launches"] += 1
    intervals, starts = [], {}
    for ev in device:
        s, d = float(ev["ts"]), float(ev.get("dur", 0.0))
        intervals.append((s, s + d))
        starts[s] = ev
        phases[launched(ev)]["device_ms"] += d / 1e3
    for g0, g1 in _union(intervals)[1]:
        phases[launched(starts[g1])]["idle_ms"] += (g1 - g0) / 1e3
    per_step = {name: {k: v / steps for k, v in p.items()} for name, p in phases.items()}
    records = sum(ev.get("cat") == "kernel" for ev in device)
    return {"phases": per_step, "unspanned": per_step.pop(UNSPANNED), "launches": len(launches),
            "records": records,
            "complete": bool(device) and len(launches) - records <= MISSING_SHARE * len(launches)}


def _events(prof) -> list:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.unlink(path)
    return events["traceEvents"] if isinstance(events, dict) else events


def _cycle(loop, n: int) -> None:
    loop.steps(n=n)
    loop.finish()


def device_phases(loop, steps: int, passes: int = 3) -> dict:
    """(b): ``steps`` steps profiled with the program's tracing on, until
    the launch check passes, halving the stretch after a pass that fails;
    ``read_spans``' reading with ``steps`` and ``passes``."""
    from torch.profiler import ProfilerActivity, profile

    n = steps
    for attempt in range(1, passes + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with tracing(SimpleProfiler()):
                _cycle(loop, n)
        out = read_spans(_events(prof), n)
        out.update(steps=n, passes=attempt)
        if out["complete"]:
            return out
        n = max(1, n // 2)
    return out


def collect(loop) -> dict:
    """The spans' records on ``loop`` (a driver's ``Loop``): (a), then (b),
    each over a whole cycle of its mix; each phase with its host ms,
    launches, device ms and idle ms a step."""
    steps = len(loop.cycle)
    prof = SimpleProfiler()
    with tracing(prof):
        _cycle(loop, steps)
    out = device_phases(loop, steps)
    for name in prof.totals:
        out["phases"].setdefault(name, _zero())["host_ms"] = \
            1e3 * prof.self_seconds(name) / steps
    out["host_steps"] = steps
    return out


def _in_step(phases: dict) -> list:
    """The records of ``train_step`` and of the spans inside it."""
    return [p for name, p in phases.items() if name == STEP or name.startswith(STEP + "/")]


def readings(spans: dict) -> dict:
    """The per-layer numbers of ``spans`` (``collect``'s records), by name;
    None where a phase did not run."""
    ph = spans["phases"]

    def get(phase: str, key: str):
        return ph.get(phase, {}).get(key)

    in_step = _in_step(ph)
    return {"features_host_ms.train": get(STEP + "/features", "host_ms"),
            "forward_host_ms.train": get(STEP + "/forward", "host_ms"),
            "backward_host_ms.train": get(STEP + "/backward", "host_ms"),
            "update_host_ms.train": get(STEP + "/update", "host_ms"),
            "step_self_host_ms.train": get(STEP, "host_ms"),
            "launches_per_step.train": sum(p["launches"] for p in in_step) if in_step else None,
            "update_device_ms.train": get(STEP + "/update", "device_ms"),
            "update_idle_ms.train": get(STEP + "/update", "idle_ms")}


def tracing_cost(loop, pairs: int = 3) -> dict:
    """The host ms a step call takes, timed around the call as the driver's
    ``step_host_ms`` cycle is, over whole cycles with the program's tracing
    off and on in turns (off first in even pairs, on first in odd ones):
    {"off": [a cycle's mean, ...], "on": [...]}."""
    out = {"off": [], "on": []}
    for k in range(pairs):
        for on in ((False, True) if k % 2 == 0 else (True, False)):
            ms = []
            with tracing(SimpleProfiler()) if on else contextlib.nullcontext():
                loop.steps(n=len(loop.cycle), spans=ms)
                loop.finish()
            out["on" if on else "off"].append(sum(ms) / len(ms))
    return out


def report(ctx: dict, bench: dict, driver) -> dict:
    """``tracing_cost`` after a cycle that warms the mix's shapes, then the
    driver's set-up and ``--trace 1`` stretches on ``ctx``, ``collect``, and
    ``tracing_cost`` again (after torch.profiler has run); the cell's
    per-layer metrics from the records, the spans and their readings, the
    share of the stretch's launches inside ``train_step``, and the host ms a
    step of the driver's untraced cycle beside (a)'s."""
    loop = driver.Loop(ctx)
    _cycle(loop, len(loop.cycle))
    before = tracing_cost(loop)
    records = driver.measure(loop, ctx)
    sp = records["spans"] = collect(loop)
    metrics = {m["name"]: run.load_module(run.BENCH / "metrics" / f"{m['name']}.py").read(records)
               for m in run.metrics_of(bench, ctx["cell"]["name"], True)}
    in_step = _in_step(sp["phases"])
    host = records["step_host_ms"]
    return {"metrics": metrics, "readings": readings(sp), "spans": sp,
            "launch_share_in_step": (sum(p["launches"] for p in in_step) * sp["steps"]
                                     / sp["launches"] if sp["launches"] else None),
            "step_host_ms_untraced": sum(host) / len(host),
            "step_host_ms_traced": sum(p.get("host_ms", 0.0) for p in in_step),
            "tracing_cost": {"before_profiler": before, "after_profiler": tracing_cost(loop)},
            "device": outcome.device_info(loop.dev, ctx["chips"], records.get("trace"))}


def main(argv=None) -> int:
    run.cache_env()
    args = run.parse(argv)
    args.trace = 1
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    found = run.cell_of(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < found["cell"]["chips"]:
        print(f"h100_bench/spans.py: the cell needs {found['cell']['chips']} CUDA card(s)",
              file=sys.stderr)
        return 3
    ctx = {"args": args, "cell": found["cell"], "cfg": found["cfg"], "mix": found["mix"],
           "device": torch.device("cuda", 0), "chips": found["cell"]["chips"],
           "since_start": run.since_start, "tmp": Path(os.environ.get("TMPDIR") or "/tmp")}
    print(json.dumps(report(ctx, bench, run.load_module(found["driver"]))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
