"""Seconds of the PQ encode of the loaded rows: the self seconds of the
``vdb/pq.encode`` span."""

from vdbbench.spans import self_seconds


def read(rec):
    return self_seconds(rec, ("vdb/pq.encode",))
