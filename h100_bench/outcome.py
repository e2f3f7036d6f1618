"""What a driver returns to the harness: correctness, counts, the records
the metric readers read, the result's ``device`` and a traced run's
breakdown."""

from __future__ import annotations

import torch


def device_info(dev, chips: int, tr: dict = None) -> dict:
    """The result's ``device``: the platform, the card's name, the cards
    the run used and the peak of allocated memory; with a traced stretch
    ``tr``, its busy seconds and its length."""
    cuda = dev.type == "cuda"
    out = {"platform": "gpu" if cuda else dev.type,
           "kind": torch.cuda.get_device_name(dev) if cuda else dev.type, "count": chips,
           "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev)) if cuda else 0}
    if tr is not None:
        out.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
    return out


def result(records: dict, device: dict, checks: list, attempted: int, failed: int) -> dict:
    """The driver's output for ``run.result_line``."""
    out = {"correct": all(c["ok"] for c in checks), "attempted": attempted, "failed": failed,
           "records": records, "device": device,
           "checks": [{k: c[k] for k in ("name", "value", "limit")} for c in checks]}
    if "trace" in records:
        tr = records["trace"]
        out["breakdown"] = {"device_ops": tr["top_ops"], "idle_gaps": tr["idle_gaps"]}
    return out
