"""Index-trait adapter over the HNSW graph.

Port of ``vectordb_tpu/index/hnsw.py``. Capability parity with reference
src/hnsw/mod.rs:14-81: ``add``/``remove``/``search`` (with the params'
ef_search), ``get_vector``, ``build_batch`` bulk loading (mod.rs:37) and
``search_with_ef`` runtime tuning (mod.rs:45-53). The graph and its
per-query search stay on the host, as in the JAX package's ``HnswIndex``;
``device`` (the port's own parameter, default "cuda") is where the two
device programs run: the bulk build of a large fresh batch
(``bulk_build``, index/hnsw_build_device.py, over the flat index's
kernels) and the batched traversal (``device_searcher``,
``search_batch_device``: kernel H1, ops/hnsw_device.py). A CPU device runs
their plain versions. The device is resolved at first use, so an index
that never runs a device program needs no card.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..distance import DistanceMetric
from ..vector import Vector, as_f32_array
from .base import Index
from .hnsw_graph import HnswGraph, HnswParams


class HnswIndex(Index):
    """Approximate k-NN via hierarchical navigable small-world graphs.

    ``backend``: "auto" (native C++ core when available, ~50x faster
    build), "native" (require it), or "python" (the pure-Python graph).
    Both backends share the packed-array model, the padded device-table
    export, and the reference's algorithm parameters/semantics.
    """

    def __init__(self, metric: DistanceMetric,
                 params: Optional[HnswParams] = None,
                 backend: str = "auto", bulk_build: str = "auto",
                 device="cuda"):
        if backend not in ("auto", "native", "python"):
            raise ValueError(f"unknown backend: {backend!r}")
        if bulk_build not in ("auto", "device", "host"):
            raise ValueError(f"unknown bulk_build: {bulk_build!r}")
        # bulk_build selects how build_batch constructs a fresh graph:
        # "device" = exact batched candidate generation on ``device``
        # (hnsw_build_device.py), "host" = sequential Algorithm-1 inserts,
        # "auto" = device when the batch is large, the graph is empty and
        # ``device`` is a card (the JAX package's "a TPU backend is
        # present"). A build or launch failure on the card raises.
        self._bulk_build = bulk_build
        self._device = device
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

    # auto device-build threshold: below this the sequential C++ build
    # is faster than the device path's set-up
    _AUTO_DEVICE_BUILD_MIN = 65536

    def build_batch(self, items: Sequence[Tuple[int, Vector]]) -> None:
        """Bulk load. Large fresh batches on a card route through the
        device bulk builder (hnsw_build_device.py: exact batched candidate
        generation on the flat index's kernels). Otherwise, with the
        native core this runs the batch path (the reference's docstring
        promises rayon parallelism but is sequential,
        src/hnsw/mod.rs:34-37; here an unseeded graph builds on several
        threads)."""
        if self._bulk_build != "host" and self._device_buildable(items):
            from .hnsw_build_device import build_device_tables
            ids = np.fromiter((int(i) for i, _ in items), dtype=np.int64,
                              count=len(items))
            data = np.stack([as_f32_array(v) for _, v in items])
            tables = build_device_tables(ids, data, self.metric,
                                         self.params, device=self._device)
            self._graph.import_padded_tables(tables)
            return
        batch_fn = getattr(self._graph, "insert_batch", None)
        if batch_fn is not None and len(items) >= 64:
            batch_fn([(iid, as_f32_array(v)) for iid, v in items])
            return
        for internal_id, vector in items:
            self._graph.insert(internal_id, as_f32_array(vector))

    def _device_buildable(self, items) -> bool:
        """Can/should build_batch use the device bulk builder?"""
        if len(self._graph) != 0:
            if self._bulk_build == "device":
                raise RuntimeError(
                    "bulk_build='device' requires an empty graph")
            return False
        ids = {int(i) for i, _ in items}
        if len(ids) != len(items):
            if self._bulk_build == "device":
                raise ValueError("duplicate ids in device bulk build")
            return False
        if self._bulk_build == "device":
            # the explicit request holds at any size and on any device
            # (MIN_DEVICE_BUILD is a heuristic of the auto path)
            return True
        from .hnsw_build_device import MIN_DEVICE_BUILD
        if len(items) < max(MIN_DEVICE_BUILD, self._AUTO_DEVICE_BUILD_MIN):
            return False
        return torch.device(self._device).type == "cuda"

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

    # -- device traversal (batched beam search, kernel H1) --------------------

    def device_searcher(self):
        """Frozen device tables + the batched traversal for the current
        graph version (rebuilt lazily after mutations)."""
        from ..ops.hnsw_device import DeviceHnswSearcher
        cached = getattr(self, "_device_searcher", None)
        if cached is None or cached[0] != self._graph.version:
            cached = (self._graph.version,
                      DeviceHnswSearcher(self._graph, self.metric,
                                         device=self._device))
            self._device_searcher = cached
        return cached[1]

    def search_batch_device(self, queries: np.ndarray, k: int,
                            ef: Optional[int] = None, slot_mask=None):
        """Batched search on the device tables (one launch for Q queries)
        instead of the host traversal per query. ``slot_mask``: exact
        filtered search (a result track of eligible slots in the beam, no
        over-fetch)."""
        ef = self.params.ef_search if ef is None else int(ef)
        return self.device_searcher().search_batch(queries, k, ef,
                                                   slot_mask=slot_mask)

    # -- lookups -------------------------------------------------------------

    def get_vector(self, internal_id: int) -> Optional[Vector]:
        arr = self._graph.get_vector(internal_id)
        return None if arr is None else Vector(arr)

    def iter_items(self) -> Iterator[Tuple[int, Vector]]:
        return ((iid, Vector(arr)) for iid, arr in self._graph.iter_items())

    def __repr__(self) -> str:
        return (f"HnswIndex(metric={self.metric.value}, len={len(self)}, "
                f"m={self.params.m}, ef_search={self.params.ef_search})")
