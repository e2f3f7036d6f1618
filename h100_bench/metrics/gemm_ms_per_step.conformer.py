"""Device milliseconds a step, in the profiled stretch, of the "gemm" group
(the frozen kernel categories of ``trace.py``) less the attention cores
that fall in it (``attention_ms_per_step.conformer``'s kernels): the
Linears' GEMMs, forward and backward, and the position term's products."""

from h100_bench.trace import category

TAGS = ("fmha", "attention", "flash")


def read(rec: dict):
    tr = rec.get("trace")
    if not tr or "gemm" not in tr["groups"] or not tr["steps"]:
        return None
    attention = sum(ms for name, ms in tr["kernels"].items()
                    if category(name) == "gemm" and any(t in name.lower() for t in TAGS))
    return (tr["groups"]["gemm"] - attention) / tr["steps"]
