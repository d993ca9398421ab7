"""Python wrapper for the native C++ HNSW core.

Port of ``vectordb_tpu/index/hnsw_native.py`` over the port's build of
``hnswcore.cpp`` (``persistence/native_lib.py``: the JAX package's source,
read by path). One difference by design: a seeded ``HnswParams`` builds
batches on one thread, so its graph is reproducible; the JAX package's
batch build runs on up to 8 threads whatever the seed, and the order in
which they link nodes changes the graph from run to run.

Same interface as the pure-Python ``HnswGraph`` (index/hnsw_graph.py):
insert/remove/search_knn/get_vector/iter_items/export_padded_tables plus
the slot accessors the store layer uses for columnar metadata. The build
and traversal hot loops run in C++ (persistence/native/hnswcore.cpp); the
id<->slot bookkeeping stays in Python.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..distance import DistanceMetric
from ..errors import DimensionMismatchError, InvalidVectorError
from ..persistence import native_lib
from .hnsw_graph import HnswParams

_METRIC_CODE = {
    DistanceMetric.EUCLIDEAN: 0,
    DistanceMetric.COSINE: 1,
    DistanceMetric.DOT_PRODUCT: 2,
}

_F32P = ctypes.POINTER(ctypes.c_float)
_I64P = ctypes.POINTER(ctypes.c_int64)


def native_available() -> bool:
    return native_lib.get_native() is not None


class NativeHnswGraph:
    """HNSW graph backed by the C++ core."""

    def __init__(self, metric: DistanceMetric,
                 params: Optional[HnswParams] = None):
        self.metric = metric
        self.params = params or HnswParams()
        self._native = native_lib.get_native()
        if self._native is None:
            raise RuntimeError("native HNSW core unavailable")
        self._handle = None
        self._dim: Optional[int] = None
        self._slot_of_id: Dict[int, int] = {}
        self._id_of_slot: Dict[int, int] = {}
        self._zero_live = 0
        self.version = 0

    def __del__(self):
        try:
            handle = getattr(self, "_handle", None)
            if handle:
                self._native.vdb_hnsw_free(handle)
                self._handle = None
        except Exception:
            pass  # interpreter teardown may have unloaded the library

    # -- properties ---------------------------------------------------------

    @property
    def dimension(self) -> Optional[int]:
        return self._dim

    @property
    def capacity(self) -> int:
        return int(self._native.vdb_hnsw_capacity(self._handle)) \
            if self._handle else 0

    def __len__(self) -> int:
        return int(self._native.vdb_hnsw_len(self._handle)) \
            if self._handle else 0

    def slot_of(self, internal_id: int) -> Optional[int]:
        return self._slot_of_id.get(internal_id)

    def id_of(self, slot: int) -> int:
        return self._id_of_slot.get(slot, -1)

    @property
    def _entry(self) -> Optional[int]:
        """Entry-point slot (interface parity with HnswGraph)."""
        if not self._handle:
            return None
        e = int(self._native.vdb_hnsw_entry(self._handle))
        return None if e < 0 else e

    # -- mutation -----------------------------------------------------------

    def _ensure_handle(self, dim: int) -> None:
        if self._handle is not None:
            return
        self._dim = dim
        seed = self.params.seed if self.params.seed is not None else 0
        self._handle = self._native.vdb_hnsw_create(
            dim, self.params.m, self.params.m_max0,
            self.params.ef_construction, self.params.max_layers,
            _METRIC_CODE[self.metric], seed, float(self.params.ml))
        if not self._handle:
            raise RuntimeError("vdb_hnsw_create failed")

    def insert(self, internal_id: int, vector: np.ndarray) -> None:
        arr = np.ascontiguousarray(vector, dtype=np.float32).reshape(-1)
        dim = arr.shape[0]
        if self._dim is not None and dim != self._dim:
            raise DimensionMismatchError(self._dim, dim)
        self._ensure_handle(dim)
        is_zero = float(np.dot(arr, arr)) == 0.0
        if self.metric is DistanceMetric.COSINE and len(self) > 0:
            # distances get computed during graph descent, so a zero vector
            # (either the new one or one already stored) errors at insert —
            # matching the pure-Python graph / reference error propagation
            if is_zero or self._zero_live > 0:
                raise InvalidVectorError(
                    "Cannot compute cosine distance with zero vector")
        if internal_id in self._slot_of_id:
            self.remove(internal_id)
        if is_zero:
            self._zero_live += 1
        slot = self._native.vdb_hnsw_insert(
            self._handle, int(internal_id), arr.ctypes.data_as(_F32P))
        if slot < 0:
            raise RuntimeError("native HNSW insert failed")
        self._slot_of_id[internal_id] = int(slot)
        self._id_of_slot[int(slot)] = internal_id
        self.version += 1

    def insert_batch(self, items, n_threads: Optional[int] = None) -> None:
        """Parallel bulk insert of (internal_id, vector) pairs.

        Fresh unique IDs go through the C++ batch path (striped node
        locks when multithreaded); duplicates fall back to serial inserts.
        ``n_threads`` defaults to 1 for a seeded graph (reproducible: the
        same rows give the same graph, whatever the batching) and to
        min(8, cores) otherwise.
        """
        import os
        fresh = []
        seen = set()
        dupes = []
        for internal_id, vec in items:
            if internal_id in self._slot_of_id or internal_id in seen:
                dupes.append((internal_id, vec))
            else:
                seen.add(internal_id)
                fresh.append((internal_id, vec))
        if fresh:
            arr = np.ascontiguousarray(
                np.stack([np.asarray(v, dtype=np.float32).reshape(-1)
                          for _, v in fresh]), dtype=np.float32)
            dim = arr.shape[1]
            if self._dim is not None and dim != self._dim:
                raise DimensionMismatchError(self._dim, dim)
            self._ensure_handle(dim)
            if self.metric is DistanceMetric.COSINE:
                sqs = np.einsum("ij,ij->i", arr, arr)
                n_zero = int((sqs == 0.0).sum())
                if (n_zero and (len(self) > 0 or len(fresh) > 1)) or \
                        (self._zero_live > 0 and len(self) > 0):
                    # matches the serial path: any distance involving a
                    # zero vector (new or already stored) errors
                    raise InvalidVectorError(
                        "Cannot compute cosine distance with zero vector")
                self._zero_live += n_zero
            ids64 = np.ascontiguousarray(
                np.array([iid for iid, _ in fresh], dtype=np.int64))
            out_slots = np.empty(len(fresh), dtype=np.int32)
            if n_threads is None:
                n_threads = (1 if self.params.seed is not None
                             else min(8, os.cpu_count() or 1))
            self._native.vdb_hnsw_insert_batch(
                self._handle,
                ids64.ctypes.data_as(_I64P),
                arr.ctypes.data_as(_F32P),
                len(fresh), int(n_threads),
                out_slots.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
            for (iid, _), slot in zip(fresh, out_slots):
                self._slot_of_id[iid] = int(slot)
                self._id_of_slot[int(slot)] = iid
            self.version += 1
        for internal_id, vec in dupes:
            self.insert(internal_id, np.asarray(vec, dtype=np.float32))

    def remove(self, internal_id: int) -> None:
        slot = self._slot_of_id.pop(internal_id, None)
        if slot is None:
            return
        vec = None
        if self._zero_live:
            vec = self.get_vector_by_slot(slot)
        self._id_of_slot.pop(slot, None)
        self._native.vdb_hnsw_remove_slot(self._handle, int(slot))
        if vec is not None and float(np.dot(vec, vec)) == 0.0:
            self._zero_live -= 1
        self.version += 1

    def get_vector_by_slot(self, slot: int) -> Optional[np.ndarray]:
        out = np.empty(self._dim, dtype=np.float32)
        rc = self._native.vdb_hnsw_get_slot(
            self._handle, int(slot), out.ctypes.data_as(_F32P))
        return out if rc == 0 else None

    # -- search -------------------------------------------------------------

    def search_knn(self, query: np.ndarray, k: int,
                   ef: Optional[int] = None,
                   mask: Optional[np.ndarray] = None,
                   visit_budget: int = 0) -> List[Tuple[int, float]]:
        """k nearest (internal_id, distance) ascending. ``mask``: exact
        filtered search — bool[capacity] slot mask applied to the layer-0
        result set (navigation unmasked); ``visit_budget`` bounds the
        filtered expansion (0 = unbounded)."""
        if self._handle is None or len(self) == 0 or k <= 0:
            return []
        arr = np.ascontiguousarray(query, dtype=np.float32).reshape(-1)
        if arr.shape[0] != self._dim:
            raise DimensionMismatchError(self._dim, arr.shape[0])
        ef = self.params.ef_search if ef is None else int(ef)
        out_ids = np.empty(int(k), dtype=np.int64)
        out_dists = np.empty(int(k), dtype=np.float32)
        if mask is not None:
            m8 = np.ascontiguousarray(
                np.asarray(mask[:self.capacity]).astype(np.uint8))
            if m8.shape[0] < self.capacity:
                m8 = np.concatenate(
                    [m8, np.zeros(self.capacity - m8.shape[0], np.uint8)])
            n = self._native.vdb_hnsw_search_masked(
                self._handle, arr.ctypes.data_as(_F32P), int(k), ef,
                m8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                int(visit_budget),
                out_ids.ctypes.data_as(_I64P),
                out_dists.ctypes.data_as(_F32P))
        else:
            n = self._native.vdb_hnsw_search(
                self._handle, arr.ctypes.data_as(_F32P), int(k), ef,
                out_ids.ctypes.data_as(_I64P),
                out_dists.ctypes.data_as(_F32P))
        if n == -2:
            raise InvalidVectorError(
                "Cannot compute cosine distance with zero vector")
        if n < 0:
            raise RuntimeError("native HNSW search failed")
        return [(int(out_ids[i]), float(out_dists[i])) for i in range(n)]

    # -- lookups / export ----------------------------------------------------

    def get_vector(self, internal_id: int) -> Optional[np.ndarray]:
        slot = self._slot_of_id.get(internal_id)
        if slot is None:
            return None
        out = np.empty(self._dim, dtype=np.float32)
        rc = self._native.vdb_hnsw_get_slot(
            self._handle, int(slot), out.ctypes.data_as(_F32P))
        return out if rc == 0 else None

    def iter_items(self):
        for internal_id in list(self._slot_of_id):
            vec = self.get_vector(internal_id)
            if vec is not None:
                yield internal_id, vec

    def import_padded_tables(self, tables: dict) -> None:
        """Restore a graph from export_padded_tables output (fast reopen:
        O(read) instead of O(rebuild))."""
        if len(self) != 0:
            raise RuntimeError("import requires an empty graph")
        vectors = np.ascontiguousarray(tables["vectors"], dtype=np.float32)
        cap, dim = vectors.shape
        if cap == 0:
            return
        self._ensure_handle(dim)
        neighbors = np.ascontiguousarray(tables["neighbors"], dtype=np.int32)
        levels = np.ascontiguousarray(tables["levels"], dtype=np.int32)
        ids = np.ascontiguousarray(tables["id_of_slot"], dtype=np.int64)
        valid = np.ascontiguousarray(
            np.asarray(tables["valid"]).astype(np.uint8))
        if neighbors.shape != (cap, self.params.max_layers,
                               self.params.m_max0):
            raise ValueError("neighbor table shape mismatch")
        rc = self._native.vdb_hnsw_import(
            self._handle, vectors.ctypes.data_as(_F32P),
            neighbors.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            levels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ids.ctypes.data_as(_I64P),
            valid.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            cap, int(tables["entry"]), int(tables["max_level"]))
        if rc != 0:
            raise RuntimeError("native HNSW import failed")
        self._slot_of_id.clear()
        self._id_of_slot.clear()
        self._zero_live = 0
        sqs = np.einsum("ij,ij->i", vectors, vectors)
        for slot in np.nonzero(valid)[0]:
            iid = int(ids[slot])
            self._slot_of_id[iid] = int(slot)
            self._id_of_slot[int(slot)] = iid
            if sqs[slot] == 0.0:
                self._zero_live += 1
        self.version += 1

    def export_padded_tables(self) -> dict:
        cap = self.capacity
        dim = self._dim or 0
        L = self.params.max_layers
        M = self.params.m_max0
        vectors = np.zeros((cap, dim), dtype=np.float32)
        norms = np.zeros(cap, dtype=np.float32)
        table = np.full((cap, L, M), -1, dtype=np.int32)
        levels = np.full(cap, -1, dtype=np.int32)
        ids = np.full(cap, -1, dtype=np.int64)
        valid = np.zeros(cap, dtype=np.uint8)
        if cap:
            rc = self._native.vdb_hnsw_export(
                self._handle,
                vectors.ctypes.data_as(_F32P), norms.ctypes.data_as(_F32P),
                table.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                levels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                ids.ctypes.data_as(_I64P),
                valid.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
            if rc != 0:
                raise RuntimeError("native HNSW export failed")
        return {
            "vectors": vectors,
            "norms": norms,
            "neighbors": table,
            "levels": levels,
            "valid": valid.astype(bool),
            "id_of_slot": ids,
            "entry": int(self._native.vdb_hnsw_entry(self._handle))
            if self._handle else -1,
            "max_level": int(self._native.vdb_hnsw_max_level(self._handle))
            if self._handle else 0,
        }


__all__ = ["NativeHnswGraph", "native_available"]
