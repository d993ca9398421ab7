"""Abstract index contract.

Parity with reference src/index.rs:11-35: pluggable ANN backends speak
integer internal IDs (the string<->int mapping is owned by the store layer,
see the design note at src/index.rs:8-10). ``search`` returns (internal_id,
distance) pairs sorted ascending by distance.

Device-first extensions beyond the reference trait:
  * ``add_batch`` — amortize device transfers over many rows
  * ``search_batch`` — one device program for Q queries
  * ``search_batch_submit`` — the same search as a handle whose hits
    reach the store as ``HitColumns``, the one form in which a batched
    search hands its hits over
  * ``search_masked`` — exact filtered search with a precompiled slot mask
    (may be unsupported by approximate indexes, in which case the store
    falls back to over-fetch post-filtering)
"""

from __future__ import annotations

import abc
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..distance import DistanceMetric
from ..vector import Vector


class HitColumns:
    """A batched search's hits as columns, each query's row ascending by
    distance: ``ids`` (Q, w) int64 internal ids, -1 past the query's
    count; ``dists`` (Q, w), the producer's floats; ``counts`` (Q,) the
    hits a query has. The store maps a whole call from these in one
    gather; ``rows()`` is the per-query [(internal_id, dist)] form."""

    __slots__ = ("ids", "dists", "counts")

    def __init__(self, ids: np.ndarray, dists: np.ndarray,
                 counts: np.ndarray):
        self.ids, self.dists, self.counts = ids, dists, counts

    @classmethod
    def cut(cls, ids: np.ndarray, dists: np.ndarray, keep: np.ndarray,
            k: int, id_of: Optional[np.ndarray] = None) -> "HitColumns":
        """Hits from (Q, w) candidates in each query's ranked order: a row
        stops at ``k`` or at its first element outside ``keep`` (the
        producer's dead hit), and its ids past the stop are -1. With
        ``id_of``, ``ids`` are slots and only the kept ones are read
        through it."""
        w = min(int(k), dists.shape[1])
        run = np.logical_and.accumulate(keep[:, :w], axis=1)
        ids = ids[:, :w]
        if id_of is not None:
            ids = id_of[np.where(run, ids, 0)]
        return cls(np.where(run, ids, -1), dists[:, :w], run.sum(axis=1))

    @classmethod
    def from_rows(cls, rows: Sequence[Sequence[Tuple[int, float]]]
                  ) -> "HitColumns":
        """Per-query [(internal_id, dist)] rows as columns, for producers
        whose work is per-query host work; float64 distances hold each
        Python float exactly."""
        counts = np.fromiter(map(len, rows), np.int64, len(rows))
        held = np.arange(counts.max(initial=0)) < counts[:, None]
        ids = np.full(held.shape, -1, np.int64)
        dists = np.full(held.shape, np.inf, np.float64)
        if held.any():
            ids[held], dists[held] = zip(*(p for row in rows for p in row))
        return cls(ids, dists, counts)

    @classmethod
    def concat(cls, parts: Sequence["HitColumns"]) -> "HitColumns":
        """Blocks of queries of one call, in order."""
        if not parts:
            return cls.from_rows([])
        return cls(*(np.concatenate(c) for c in
                     zip(*((p.ids, p.dists, p.counts) for p in parts))))

    def put(self, qidx, other: "HitColumns") -> "HitColumns":
        """A copy of these hits whose rows ``qidx`` are ``other``'s rows,
        in order (a repair of some queries of a call), as wide as the
        wider of the two."""
        n = other.ids.shape[1]
        pad = ((0, 0), (0, max(n - self.ids.shape[1], 0)))
        out = HitColumns(np.pad(self.ids, pad, constant_values=-1),
                         np.pad(self.dists, pad, constant_values=np.inf),
                         self.counts.copy())
        out.ids[qidx] = -1
        out.ids[qidx, :n], out.dists[qidx, :n] = other.ids, other.dists
        out.counts[qidx] = other.counts
        return out

    def rows(self) -> List[List[Tuple[int, float]]]:
        return [list(zip(i[:n], d[:n])) for i, d, n in
                zip(self.ids.tolist(), self.dists.tolist(),
                    self.counts.tolist())]


class SearchBatchHandle:
    """An in-flight index-level batched search (search_batch_submit).

    ``collect_columns()`` blocks on the device result and returns the
    HitColumns; ``collect()`` returns their per-query [(internal_id,
    dist)] rows. The first of them releases the index's in-flight mark —
    exactly once, even if called repeatedly or if the device work failed.
    An abandoned handle releases the mark from ``__del__`` so writes don't
    stay pinned to the copy-scatter path forever."""

    __slots__ = ("_fn", "_on_done", "_hits")

    def __init__(self, fn, on_done=None):
        self._fn = fn
        self._on_done = on_done
        self._hits: Optional[HitColumns] = None

    @classmethod
    def ready(cls, hits: HitColumns) -> "SearchBatchHandle":
        """A finished handle."""
        handle = cls(None)
        handle._hits = hits
        return handle

    def collect_columns(self) -> HitColumns:
        if self._hits is None:
            try:
                self._hits = self._fn()
            finally:
                self._release()
        return self._hits

    def collect(self) -> List[List[Tuple[int, float]]]:
        return self.collect_columns().rows()

    def _release(self):
        done, self._on_done = self._on_done, None
        if done is not None:
            done()

    def __del__(self):
        try:
            self._release()
        except Exception:
            pass


class Index(abc.ABC):
    """Contract every index backend implements (reference: src/index.rs:11-35)."""

    @abc.abstractmethod
    def add(self, internal_id: int, vector: Vector) -> None:
        """Add a vector under an internal ID (overwrite if the ID exists)."""

    @abc.abstractmethod
    def remove(self, internal_id: int) -> None:
        """Remove a vector; unknown IDs are ignored (reference behavior)."""

    @abc.abstractmethod
    def search(self, query: Vector, k: int) -> List[Tuple[int, float]]:
        """k nearest (internal_id, distance), ascending by distance."""

    @abc.abstractmethod
    def get_vector(self, internal_id: int) -> Optional[Vector]:
        """Look up a stored vector by internal ID."""

    @property
    @abc.abstractmethod
    def metric(self) -> DistanceMetric:
        """The distance metric this index was built with."""

    @abc.abstractmethod
    def __len__(self) -> int:
        """Number of live vectors."""

    def is_empty(self) -> bool:
        return len(self) == 0

    # -- batched extensions (default: loop over the scalar path) -----------

    def add_batch(self, items: Sequence[Tuple[int, Vector]]) -> None:
        for internal_id, vector in items:
            self.add(internal_id, vector)

    def search_batch(self, queries: np.ndarray,
                     k: int) -> List[List[Tuple[int, float]]]:
        return [self.search(Vector(queries[i]), k)
                for i in range(queries.shape[0])]

    def search_batch_submit(self, queries: np.ndarray,
                            k: int) -> SearchBatchHandle:
        """``search_batch`` as a handle over its HitColumns. Served
        eagerly here; an index with an asynchronous device search or a
        columnar producer overrides it."""
        return SearchBatchHandle.ready(
            HitColumns.from_rows(self.search_batch(queries, k)))

    def search_radius(self, query: Vector, radius: float,
                      limit: int) -> List[Tuple[int, float]]:
        """All rows with distance <= radius, ascending, capped at
        ``limit`` (beyond the reference; the cap keeps device shapes
        static). Distances follow this framework's smaller-is-better
        convention, so for DOT_PRODUCT the threshold applies to the
        NEGATED dot product. Exact on exact backends (their k=limit
        search already ranks every row); approximate backends inherit
        this over-search implementation — candidates are bounded by
        their own k=limit search quality."""
        raw = self.search(query, int(limit))
        return self.refine_radius(raw, query, radius)

    def refine_radius(self, raw: List[Tuple[int, float]], query: Vector,
                      radius: float) -> List[Tuple[int, float]]:
        """Re-threshold radius candidates with direct-form host distances.

        The batched scan scores rows via the norm-expansion form
        ``|x|^2 + |q|^2 - 2 q.x``, which loses ~eps*(|x|^2 + |q|^2) to
        cancellation when the true distance is tiny — enough to report
        0.0 for a near-duplicate row and to flip inclusion at the radius
        boundary (found by tests/test_properties.py's differential
        radius property). Radius candidates are bounded by ``limit``, so
        recomputing each in the scalar direct form (diff-then-dot,
        distance.py) is O(limit*d) host work and makes both the reported
        distance and the threshold decision exact at f32."""
        out: List[Tuple[int, float]] = []
        for internal_id, _ in raw:
            stored = self.get_vector(internal_id)
            if stored is None:   # raced a delete; drop it
                continue
            d = self.metric.distance(query, stored)
            if d <= radius:
                out.append((internal_id, d))
        out.sort(key=lambda t: (t[1], t[0]))
        return out

    def search_masked(self, query: Vector, k: int, slot_mask: np.ndarray,
                      mask_layout_version: Optional[int] = None
                      ) -> Optional[List[Tuple[int, float]]]:
        """Exact filtered search over a bool[capacity] slot mask (see
        ``slot_of``/``capacity``). Returns None when the backend cannot do
        exact masked search (the store then falls back to over-fetch
        post-filtering, the reference's strategy at src/storage.rs:268-287).
        ``mask_layout_version``: the slot_layout_version the mask was
        compiled against; backends that repack slots raise
        StaleSlotMaskError on mismatch so the caller can recompile."""
        return None

    # -- slot addressing (for columnar metadata masks) ----------------------

    @property
    def capacity(self) -> int:
        """Size of the slot space masks must cover. 0 until first add."""
        return 0

    @property
    def slot_layout_version(self) -> int:
        """Bumped whenever existing IDs' slots are REORDERED wholesale
        (e.g. an IVF repack). Slot-addressed caches (the store's columnar
        filter mirror) must rebuild when this changes. Indexes that never
        move a live ID's slot keep it at 0."""
        return 0

    def slot_of(self, internal_id: int) -> Optional[int]:
        """Packed-storage slot currently holding this internal ID."""
        return None

    def iter_items(self) -> Iterator[Tuple[int, Vector]]:
        """Iterate (internal_id, vector) pairs — used by snapshot builders
        (reference: src/flat_index.rs:32)."""
        raise NotImplementedError
