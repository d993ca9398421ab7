"""Seconds from process start to the first timed call: imports, data,
load, the kernels' build where it runs, and the warm-up (host clock)."""


def read(rec):
    return rec.setup_s
