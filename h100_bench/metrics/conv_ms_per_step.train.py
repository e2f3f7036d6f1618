"""Device milliseconds of the "conv" group (the frozen kernel
categories of ``trace.py``) a step in the profiled stretch."""


def read(rec: dict):
    tr = rec.get("trace")
    if not tr or "conv" not in tr["groups"] or not tr["steps"]:
        return None
    return tr["groups"]["conv"] / tr["steps"]
