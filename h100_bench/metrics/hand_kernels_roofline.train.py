"""The roofline-bound time of K1-K6's calls in the profiled stretch
(``counts.py``, from each call's inputs, against the H100's published
peaks) over their device time, in %."""

GROUPS = ("K1 log_mel", "K2 lstm", "K3 lstm_bwd", "K4 ctc_alpha", "K5 ctc_beta",
          "K6 extend_preemph")


def read(rec: dict):
    tr = rec.get("trace")
    if not tr:
        return None
    ms = sum(tr["groups"].get(g, 0.0) for g in GROUPS)
    if ms <= 0 or not tr.get("hand_bound_ms"):
        return None
    return 100.0 * tr["hand_bound_ms"] / ms
