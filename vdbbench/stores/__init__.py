"""Makers of the store under test, one module a kind, found by the
``kind`` key of a configuration's ``store``. Only these modules import
the program (``vectordb_tpu_torch``)."""

from __future__ import annotations

import numpy as np


def load(store, rows: np.ndarray, ids: list, chunk: int) -> None:
    """Load ``rows`` under the string ids ``ids`` through the store's bulk
    path for arrays (``reserve``, then ``restore_snapshot_chunk`` in
    chunks): row i takes internal id i, no metadata, and no per-row
    objects are made to load it. For the f32 rows loaded here it places
    the same rows as ``insert_batch`` would."""
    n, d = rows.shape
    store.reserve(n, d)
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        store.restore_snapshot_chunk(np.arange(lo, hi, dtype=np.int64),
                                     ids[lo:hi], rows[lo:hi], {})


def batches(queries: np.ndarray, per_call: int, k: int) -> list:
    """The entry's inputs: one list of (Vector, k) a call, ``per_call``
    queries each, over the rows of ``queries`` in order."""
    from vectordb_tpu_torch import Vector
    return [[(Vector(q), k) for q in queries[lo:lo + per_call]]
            for lo in range(0, queries.shape[0], per_call)]
