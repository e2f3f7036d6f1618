"""Per-action wall-time profiler (port of
``lightning_asr_tpu/training/profiler.py``): the reference's
``profiler="simple"`` table at the end of a fit, and the port's spans.

A span (``span(name)``) marks a phase of the program where its work
happens (the train step's ``features``, ``forward``, ``backward``,
``all_reduce`` and ``update``, ``training/steps.py``).  Spans are off by
default: ``span`` then reads one module global and returns a shared no-op
context, with no clock read, no allocation and no device work.  Inside
``tracing(profiler)`` each span is recorded into ``profiler`` as
``SimpleProfiler.profile`` records an action: its host time from
``time.perf_counter_ns`` at entry and exit, under its nested name
(``train_step/update``), with its parent kept so that its self time can be
read, and inside ``torch.profiler.record_function("lasr/<nested name>")``,
so that under an active torch.profiler it is an annotation on the clock of
the CUDA runtime's and the kernels' records.  Spans nest per profiler, in
the thread that opens them.

A route counter (``count(name, route)``) counts, tracing or not, which way
a piece of the program went each time Python ran it, as
``train_step.graphs.counts`` counts the step's routes: ``COUNTERS[name]``
is a ``collections.Counter`` of routes (``conformer.attention.backend``:
the attention's forced SDPA backend set, ``models/conformer.py``).  A
replayed CUDA graph runs no Python, so it counts nothing.
"""

from __future__ import annotations

import contextlib
import time
from collections import Counter, defaultdict
from typing import Dict, Optional

from torch.profiler import record_function

_clock = time.perf_counter_ns
_OFF = contextlib.nullcontext()
_TRACING: Optional["SimpleProfiler"] = None
ANNOTATION_PREFIX = "lasr/"
COUNTERS: Dict[str, Counter] = defaultdict(Counter)


class SimpleProfiler:
    """Host seconds and calls by action (``totals``, ``counts``), each
    action under its nested name, with its enclosing action in
    ``parents``."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self.parents = {}
        self._open = []
        self._start = time.monotonic()

    @contextlib.contextmanager
    def profile(self, name: str):
        parent = self._open[-1] if self._open else None
        full = name if parent is None else f"{parent}/{name}"
        self.parents.setdefault(full, parent)
        self._open.append(full)
        try:
            with record_function(ANNOTATION_PREFIX + full):
                t0 = _clock()
                try:
                    yield
                finally:
                    self.totals[full] += (_clock() - t0) / 1e9
                    self.counts[full] += 1
        finally:
            self._open.pop()

    def self_seconds(self, name: str) -> float:
        """``name``'s host seconds less those of the actions inside it."""
        inner = sum(t for n, t in self.totals.items() if self.parents.get(n) == name)
        return self.totals[name] - inner

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


def span(name: str):
    """A context that records the phase ``name`` into the profiler of the
    enclosing ``tracing``; a shared no-op outside one."""
    prof = _TRACING
    return _OFF if prof is None else prof.profile(name)


@contextlib.contextmanager
def tracing(profiler: SimpleProfiler):
    """Route ``span``s into ``profiler`` inside the block."""
    global _TRACING
    prev, _TRACING = _TRACING, profiler
    try:
        yield profiler
    finally:
        _TRACING = prev


def count(name: str, route: str) -> None:
    """One more ``route`` in the counter ``name`` (``COUNTERS``)."""
    COUNTERS[name][route] += 1
