"""Per-action wall-time profiler (port of
``lightning_asr_tpu/training/profiler.py``): the reference's
``profiler="simple"`` table at the end of a fit, and ``torch_trace`` to
capture a ``torch.profiler`` trace (Chrome format) of a region."""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager
from pathlib import Path
from typing import Optional


class SimpleProfiler:
    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self._start = time.monotonic()

    @contextmanager
    def profile(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def elapsed(self) -> float:
        return time.monotonic() - self._start

    def summary(self) -> str:
        total = self.elapsed()
        lines = ["", "Profiler Report (simple)",
                 f"{'Action':<32}{'Mean (s)':>12}{'Calls':>10}{'Total (s)':>12}{'%':>8}", "-" * 74]
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            tot, cnt = self.totals[name], self.counts[name]
            lines.append(f"{name:<32}{tot / cnt:>12.5f}{cnt:>10}{tot:>12.3f}"
                         f"{100.0 * tot / max(total, 1e-9):>8.1f}")
        lines.append("-" * 74)
        lines.append(f"{'TOTAL ELAPSED':<32}{'':>12}{'':>10}{total:>12.3f}")
        return "\n".join(lines)


@contextmanager
def torch_trace(log_dir: Optional[str]):
    """Trace the region with ``torch.profiler`` (host and, on a card, device
    activity) into ``<log_dir>/trace.json``; nothing without a log_dir."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=acts) as prof:
        yield
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))
