"""Device milliseconds a step, in the profiled stretch, of the attention
cores: the kernels whose name holds "fmha", "attention" or "flash" (the
memory-efficient SDPA kernel's forward and backward)."""

TAGS = ("fmha", "attention", "flash")


def read(rec: dict):
    tr = rec.get("trace")
    if not tr or not tr["steps"]:
        return None
    ms = sum(ms for name, ms in tr["kernels"].items() if any(t in name.lower() for t in TAGS))
    return ms / tr["steps"] if ms > 0 else None
