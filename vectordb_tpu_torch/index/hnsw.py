"""Index-trait adapter over the HNSW graph.

Port of ``vectordb_tpu/index/hnsw.py``. Capability parity with reference
src/hnsw/mod.rs:14-81: ``add``/``remove``/``search`` (with the params'
ef_search), ``get_vector``, ``build_batch`` bulk loading (mod.rs:37) and
``search_with_ef`` runtime tuning (mod.rs:45-53). The graph and its search
stay on the host, as in the JAX package's ``HnswIndex``.

Not ported yet (ROADMAP queue 1 item 10b, the HNSW device programs): the
device bulk build (``bulk_build="device"`` raises; "auto" takes the host
build, as the JAX package's "auto" does off a TPU) and the batched device
traversal (``device_searcher``, ``search_batch_device``).
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..distance import DistanceMetric
from ..vector import Vector, as_f32_array
from .base import Index
from .hnsw_graph import HnswGraph, HnswParams

_ITEM_10B = ("{} is not ported yet (ROADMAP queue 1 item 10b, the HNSW "
             "device programs); the graph and its search run on the host")


class HnswIndex(Index):
    """Approximate k-NN via hierarchical navigable small-world graphs.

    ``backend``: "auto" (native C++ core when available, ~50x faster
    build), "native" (require it), or "python" (the pure-Python graph).
    Both backends share the packed-array model, the padded device-table
    export, and the reference's algorithm parameters/semantics.
    """

    def __init__(self, metric: DistanceMetric,
                 params: Optional[HnswParams] = None,
                 backend: str = "auto", bulk_build: str = "auto"):
        if backend not in ("auto", "native", "python"):
            raise ValueError(f"unknown backend: {backend!r}")
        if bulk_build not in ("auto", "device", "host"):
            raise ValueError(f"unknown bulk_build: {bulk_build!r}")
        if bulk_build == "device":
            raise NotImplementedError(_ITEM_10B.format(
                "the device bulk build (bulk_build='device')"))
        # "host" and "auto" build on the host (Algorithm-1 inserts or the
        # native batch path); "auto" takes the device build for large
        # fresh batches once it is ported
        graph = None
        if backend in ("auto", "native"):
            from .hnsw_native import NativeHnswGraph, native_available
            if native_available():
                graph = NativeHnswGraph(metric, params)
            elif backend == "native":
                raise RuntimeError("native HNSW core unavailable")
        self._graph = graph if graph is not None else HnswGraph(metric, params)

    @classmethod
    def with_params(cls, metric: DistanceMetric,
                    params: HnswParams) -> "HnswIndex":
        return cls(metric, params)

    @property
    def metric(self) -> DistanceMetric:
        return self._graph.metric

    @property
    def params(self) -> HnswParams:
        return self._graph.params

    @property
    def graph(self) -> HnswGraph:
        return self._graph

    @property
    def dimension(self) -> Optional[int]:
        return self._graph.dimension

    @property
    def capacity(self) -> int:
        return self._graph.capacity

    def slot_of(self, internal_id: int) -> Optional[int]:
        return self._graph.slot_of(internal_id)

    def __len__(self) -> int:
        return len(self._graph)

    # -- mutation ------------------------------------------------------------

    def add(self, internal_id: int, vector: Vector) -> None:
        self._graph.insert(internal_id, as_f32_array(vector))

    def add_batch(self, items: Sequence[Tuple[int, Vector]]) -> None:
        self.build_batch(items)

    def build_batch(self, items: Sequence[Tuple[int, Vector]]) -> None:
        """Bulk load. With the native core this runs the batch path (the
        reference's docstring promises rayon parallelism but is
        sequential, src/hnsw/mod.rs:34-37; here an unseeded graph builds
        on several threads)."""
        batch_fn = getattr(self._graph, "insert_batch", None)
        if batch_fn is not None and len(items) >= 64:
            batch_fn([(iid, as_f32_array(v)) for iid, v in items])
            return
        for internal_id, vector in items:
            self._graph.insert(internal_id, as_f32_array(vector))

    def remove(self, internal_id: int) -> None:
        self._graph.remove(internal_id)

    # -- search --------------------------------------------------------------

    def search(self, query: Vector, k: int) -> List[Tuple[int, float]]:
        return self._graph.search_knn(as_f32_array(query), k)

    def search_with_ef(self, query: Vector, k: int,
                       ef: int) -> List[Tuple[int, float]]:
        return self._graph.search_knn(as_f32_array(query), k, ef=ef)

    def search_batch(self, queries: np.ndarray,
                     k: int) -> List[List[Tuple[int, float]]]:
        return [self._graph.search_knn(queries[i], k)
                for i in range(queries.shape[0])]

    def search_radius(self, query: Vector, radius: float,
                      limit: int) -> List[Tuple[int, float]]:
        """Radius via over-search with the beam widened to the limit:
        the default ef (50) would cap recall when limit exceeds it."""
        ef = max(self.params.ef_search, int(limit))
        raw = self.search_with_ef(query, int(limit), ef)
        return self.refine_radius(raw, query, radius)

    def search_masked(self, query: Vector, k: int, slot_mask: np.ndarray,
                      mask_layout_version=None, ef=None):
        """Exact filtered traversal (retires the reference's 3x over-fetch
        from the HNSW hot path, storage.rs:268-287): the layer-0 beam
        admits only mask-passing slots to the result set while navigation
        stays unmasked (the standard filtered-HNSW shape). ef (the
        caller's per-query beam width when given, else the index default)
        scales with the mask's selectivity, and a visit budget bounds the
        expansion; a shortfall (< k results) returns None so the store's
        over-fetch fallback decides — exactness of the filter is
        unconditional, the recall story is the same best-effort as
        unfiltered HNSW."""
        if (mask_layout_version is not None
                and mask_layout_version != self.slot_layout_version):
            from ..errors import StaleSlotMaskError
            raise StaleSlotMaskError(mask_layout_version,
                                     self.slot_layout_version)
        mask = np.asarray(slot_mask, dtype=bool)
        if mask.size == 0 or not mask.any():
            return []
        cap = self.capacity
        if mask.shape[0] < cap:   # mask compiled before a capacity grow
            mask = np.concatenate(
                [mask, np.zeros(cap - mask.shape[0], bool)])
        sel = float(mask.mean())
        ef = max(int(ef) if ef is not None else self.params.ef_search, k)
        ef = min(int(ef / max(sel, 0.05)), max(4 * ef, 512))
        res = self._graph.search_knn(as_f32_array(query), k, ef=ef,
                                     mask=mask, visit_budget=64 * ef)
        if len(res) >= min(k, int(mask.sum())):
            return res
        return None

    # -- device traversal (ROADMAP queue 1 item 10b) --------------------------

    def device_searcher(self):
        raise NotImplementedError(_ITEM_10B.format(
            "the batched device traversal (device_searcher)"))

    def search_batch_device(self, queries: np.ndarray, k: int,
                            ef: Optional[int] = None, slot_mask=None):
        raise NotImplementedError(_ITEM_10B.format(
            "the batched device traversal (search_batch_device)"))

    # -- lookups -------------------------------------------------------------

    def get_vector(self, internal_id: int) -> Optional[Vector]:
        arr = self._graph.get_vector(internal_id)
        return None if arr is None else Vector(arr)

    def iter_items(self) -> Iterator[Tuple[int, Vector]]:
        return ((iid, Vector(arr)) for iid, arr in self._graph.iter_items())

    def __repr__(self) -> str:
        return (f"HnswIndex(metric={self.metric.value}, len={len(self)}, "
                f"m={self.params.m}, ef_search={self.params.ef_search})")
