"""Seconds of the store's bulk load (``reserve`` and each
``restore_snapshot_chunk``): the self seconds of ``vdb/store.load``."""

from vdbbench.spans import self_seconds


def read(rec):
    return self_seconds(rec, ("vdb/store.load",))
