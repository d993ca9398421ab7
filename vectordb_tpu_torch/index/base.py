"""Abstract index contract.

Parity with reference src/index.rs:11-35: pluggable ANN backends speak
integer internal IDs (the string<->int mapping is owned by the store layer,
see the design note at src/index.rs:8-10). ``search`` returns (internal_id,
distance) pairs sorted ascending by distance.

Device-first extensions beyond the reference trait:
  * ``add_batch`` — amortize device transfers over many rows
  * ``search_batch`` — one device program for Q queries
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
