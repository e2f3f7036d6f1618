"""Seconds from process start to the first timed step or request: loading,
building the kernels on a first run, the weights, the traffic and the
warm-up of every shape the cell uses."""


def read(rec: dict):
    return rec.get("setup_s")
