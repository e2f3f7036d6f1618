"""Device milliseconds of the "elementwise" group (the frozen kernel
categories of ``trace.py``) a step in the profiled stretch."""


def read(rec: dict):
    tr = rec.get("trace")
    if not tr or "elementwise" not in tr["groups"] or not tr["steps"]:
        return None
    return tr["groups"]["elementwise"] / tr["steps"]
