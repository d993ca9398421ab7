"""Dynamic query batching: coalesce concurrent searches into one device call.

Port of ``vectordb_tpu/server/batcher.py``. Each device search has a fixed
cost per call on top of its work (the host side of the submit, the kernel
launches, the device-to-host copy), so serving one query per call caps
throughput well below what one batched call over the same queries gives.
The batcher queues incoming search requests for up to ``window_ms`` (or
``max_batch`` requests, whichever first), executes them as one
``search_batch`` per structural filter key, and hands each caller its
slice. A request that fails validation (dimension, a zero query under
cosine) fails alone.

This is the scheduler/executor slot of the serving runtime (the reference
has no equivalent: axum handles requests one store call at a time,
src/server/routes.rs:235-282).
"""

from __future__ import annotations

import json
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional

from ..distance import DistanceMetric
from ..errors import DimensionMismatchError, InvalidVectorError

from ..metadata import MetadataFilter
from ..store import SearchResult, VectorStore
from ..vector import Vector


@dataclass
class _Pending:
    query: Vector
    k: int
    filter: Optional[MetadataFilter]
    done: threading.Event = field(default_factory=threading.Event)
    results: Optional[List[SearchResult]] = None
    error: Optional[BaseException] = None


class QueryBatcher:
    """Background coalescing executor for store searches."""

    def __init__(self, store: VectorStore, lock, window_ms: float = 2.0,
                 max_batch: int = 256):
        self._store = store
        self._lock = lock
        self._window_s = window_ms / 1000.0
        self._max_batch = max_batch
        self._queue: "queue.Queue[_Pending]" = queue.Queue()
        self._closed = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    # -- client side --------------------------------------------------------

    def search(self, query: Vector, k: int,
               filter: Optional[MetadataFilter] = None,
               timeout: float = 60.0) -> List[SearchResult]:
        item = _Pending(query=query, k=int(k), filter=filter)
        self._queue.put(item)
        if not item.done.wait(timeout):
            raise TimeoutError("batched search timed out")
        if item.error is not None:
            raise item.error
        return item.results or []

    def close(self) -> None:
        self._closed = True
        self._queue.put(None)  # wake the worker
        self._thread.join(timeout=5)

    # -- worker -------------------------------------------------------------

    def _collect(self) -> List[_Pending]:
        first = self._queue.get()
        if first is None:
            return []
        batch = [first]
        # gather whatever arrives within the window, up to max_batch
        end = self._window_s
        t0 = time.perf_counter()
        while len(batch) < self._max_batch:
            remaining = end - (time.perf_counter() - t0)
            if remaining <= 0:
                break
            try:
                item = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if item is None:
                break
            batch.append(item)
        return batch

    def _run(self) -> None:
        while not self._closed:
            batch = self._collect()
            if not batch:
                continue
            self._execute(batch)

    def _execute(self, batch: List[_Pending]) -> None:
        # per-request validation up front, so one malformed query fails
        # alone instead of poisoning its whole coalesced batch: dimension
        # mismatches, and zero-norm queries under the cosine metric
        expected = self._store.dimension
        cosine = self._store.metric is DistanceMetric.COSINE
        ready = []
        for item in batch:
            if (expected is not None and len(self._store)
                    and item.query.dimension != expected):
                item.error = DimensionMismatchError(expected,
                                                    item.query.dimension)
                item.done.set()
            elif cosine and item.query.norm() == 0.0 and len(self._store):
                item.error = InvalidVectorError(
                    "Cannot compute cosine distance with zero vector")
                item.done.set()
            else:
                ready.append(item)
        batch = ready
        # group by STRUCTURAL filter key so identical filters from
        # different requests coalesce into one device call
        groups: dict = {}
        for item in batch:
            key = (json.dumps(item.filter.to_dict(), sort_keys=True)
                   if item.filter is not None else None)
            groups.setdefault(key, []).append(item)
        for key, items in groups.items():
            queries = [(it.query, it.k) for it in items]
            flt = items[0].filter
            try:
                with self._lock.read():
                    if flt is None:
                        all_results = self._store.search_batch(queries)
                    else:
                        all_results = self._store.search_batch_with_filter(
                            queries, flt)
                for it, res in zip(items, all_results):
                    it.results = res
            except BaseException as e:  # noqa: BLE001 — route errors to callers
                for it in items:
                    it.error = e
            finally:
                for it in items:
                    it.done.set()


__all__ = ["QueryBatcher"]
