"""Mean host milliseconds inside the train step call (its enqueue), over a
cycle of steps timed by the benchmark around each call, before the
profiled stretch."""


def read(rec: dict):
    spans = rec.get("step_host_ms")
    return sum(spans) / len(spans) if spans else None
