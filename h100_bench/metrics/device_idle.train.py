"""1 - the union of the device's operations / the profiled stretch's host
seconds, in %."""


def read(rec: dict):
    tr = rec.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
