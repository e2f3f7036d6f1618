"""Reading a torch.profiler stretch: device time by kernel and group, the
busy union of the device's operations, the longest idle gaps by what the
host was doing, and the check that the trace holds the host's launches.

Frozen copies, from ``chip_smoke.py`` at commit 504420a:

  * ``category`` is ``chip_smoke.py::_category`` (kernel name -> K1-K11,
    conv, gemm, elementwise, reduce, copy, other);
  * the launch check is ``chip_smoke.py::kernel_times``'s: a pass counts
    only if its kernel records on the card fall short of the host's kernel
    launches by at most ``MISSING_SHARE`` (torch.profiler on the H100 host
    drops kernel records now and then).
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Dict, List, Tuple

MISSING_SHARE = 0.01
_KERNEL_TAGS = (("lstm_stacked_fwd_", "K7 lstm_stacked"),
                ("lstm_stacked_steps_", "K8 lstm_stacked_bwd"),
                ("lstm_stacked_bwd_", "K8 lstm_stacked_bwd"),
                ("log_mel_kernel", "K1 log_mel"), ("lstm_fwd_kernel", "K2 lstm"),
                ("lstm_fwd_pair_kernel", "K2 lstm"),
                ("lstm_bwd_kernel", "K3 lstm_bwd"), ("lstm_bwd_gates_kernel", "K3 lstm_bwd"),
                ("lstm_bwd_pair_kernel", "K3 lstm_bwd"), ("lstm_bwd_dw_kernel", "K3 lstm_bwd"),
                ("ctc_alpha_kernel", "K4 ctc_alpha"),
                ("ctc_beta_kernel", "K5 ctc_beta"), ("extend_kernel", "K6 extend_preemph"),
                ("sepconv_fwd", "K9 sepconv_fwd"), ("sepconv_dz", "K10 sepconv_bwd"),
                ("sepconv_bwd_dw", "K10 sepconv_bwd"), ("sepconv_wp_grad", "K10 sepconv_bwd"),
                ("dw_wgrad_", "K11 dw_wgrad"), ("sum_partials_kernel", "K10/K11 partial sums"))


def category(name: str) -> str:
    low = name.lower()
    for tag, cat in _KERNEL_TAGS:
        if tag in low:
            return cat
    if "memcpy" in low or "memset" in low:
        return "copy"
    if any(s in low for s in ("conv", "fprop", "dgrad", "wgrad", "cudnn", "implicit")):
        return "conv"
    if "gemm" in low or "cutlass" in low:
        return "gemm"
    if "elementwise" in low or "vectorized" in low:
        return "elementwise"
    if "reduce" in low:
        return "reduce"
    return "other"


def _union(intervals: List[Tuple[float, float]]) -> Tuple[float, List[Tuple[float, float]]]:
    """(covered length, the gaps between covered stretches), intervals in us."""
    covered, gaps, end = 0.0, [], None
    for s, e in sorted(intervals):
        if end is None:
            covered, end = e - s, e
        elif s > end:
            gaps.append((end, s))
            covered += e - s
            end = e
        elif e > end:
            covered += e - end
            end = e
    return covered, gaps


def read_profile(prof) -> dict:
    """The stretch a ``torch.profiler.profile`` recorded, from its Chrome
    trace: ``kernels`` {name: ms}, ``groups`` {category: ms}, ``busy_s`` (the
    union of device operations), ``launches`` (host kernel launches),
    ``records`` (kernel records), ``complete`` (the launch check),
    ``top_ops`` and ``idle_gaps`` (the 10 largest of each, [name,
    seconds])."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.unlink(path)
    events = events["traceEvents"] if isinstance(events, dict) else events
    device, runtime, host_ops = [], {}, []
    launches = 0
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            device.append(ev)
        elif cat in ("cuda_runtime", "cuda_driver"):
            if "LaunchKernel" in ev.get("name", "") or "cuLaunch" in ev.get("name", ""):
                launches += 1
            corr = (ev.get("args") or {}).get("correlation")
            if corr is not None:
                runtime[corr] = ev
        elif cat in ("cpu_op", "python_function", "user_annotation"):
            host_ops.append(ev)
    kernels: Dict[str, float] = {}
    intervals = []
    records = 0
    for ev in device:
        s, d = float(ev["ts"]), float(ev.get("dur", 0.0))
        intervals.append((s, s + d))
        kernels[ev["name"]] = kernels.get(ev["name"], 0.0) + d / 1e3
        records += ev.get("cat") == "kernel"
    busy_us, gaps = _union(intervals)
    groups: Dict[str, float] = {}
    for name, ms in kernels.items():
        groups[category(name)] = groups.get(category(name), 0.0) + ms
    # a gap's host activity: the innermost host op around the launch of the
    # operation that ends it, else that operation's own name
    starts = {float(ev["ts"]): ev for ev in device}
    labelled = []
    for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        nxt = starts[g1]
        launch = runtime.get((nxt.get("args") or {}).get("correlation"))
        label = f"before {nxt['name'][:80]}"
        if launch is not None:
            t = float(launch["ts"])
            around = [op for op in host_ops
                      if float(op["ts"]) <= t <= float(op["ts"]) + float(op.get("dur", 0))]
            if around:
                label = min(around, key=lambda op: float(op.get("dur", 0)))["name"]
        labelled.append([label, (g1 - g0) / 1e6])
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    return {"kernels": kernels, "groups": groups, "busy_s": busy_us / 1e6,
            "launches": launches, "records": records,
            "complete": bool(device) and launches - records <= MISSING_SHARE * launches,
            "top_ops": [[n, ms / 1e3] for n, ms in top], "idle_gaps": labelled}


def profiled(run_stretch, steps: int, passes: int = 3):
    """Profile ``run_stretch(n)`` (n whole steps, ending in a
    synchronize; returns the host seconds it took) until the launch check
    passes, halving the stretch after a pass
    that fails.  Returns the trace's reading with ``window_s``, ``steps``
    and ``passes``."""
    from torch.profiler import ProfilerActivity, profile

    n = steps
    for attempt in range(1, passes + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            window_s = run_stretch(n)
        out = read_profile(prof)
        out.update(window_s=window_s, steps=n, passes=attempt)
        if out["complete"]:
            return out
        n = max(1, n // 2)
    return out

