"""Device milliseconds a step, in the profiled stretch, of the
memory-bound rest: the "elementwise", "reduce" and "other" groups (the
frozen kernel categories of ``trace.py``) less any attention core among
them: LayerNorm, Swish, GLU, the log-softmax, the position term's shift,
scale and mask, the residual sums, BatchNorm, the optimizer's passes."""

from h100_bench.trace import category

GROUPS = ("elementwise", "reduce", "other")
TAGS = ("fmha", "attention", "flash")


def read(rec: dict):
    tr = rec.get("trace")
    if not tr or not tr["steps"] or not any(g in tr["groups"] for g in GROUPS):
        return None
    ms = sum(ms for name, ms in tr["kernels"].items()
             if category(name) in GROUPS and not any(t in name.lower() for t in TAGS))
    return ms / tr["steps"]
