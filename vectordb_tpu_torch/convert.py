"""Carry a store's state across from the JAX package.

``store_from_reference`` builds a port store with the identical slot
layout from the numpy arrays ``vectordb_tpu`` exports:
``FlatIndex.packed_arrays()`` gives (vectors, valid, id_of_slot) and
``VectorStore.internal_to_string_ids()`` the id map. Same slots give the
same candidate tiles, so the two packages' results compare position by
position. Only numpy crosses over: this module imports no JAX, and a bf16
store's rows (ml_dtypes' bfloat16) are read by their bits, so the port
needs no ml_dtypes.

``pq_store_from_reference`` does the same for a ``PqFlatIndex`` store and
adds its trained state (``export_trained_state()``: codebook, rotation)
and, optionally, the JAX index's per-slot ``_codes``, so the two scans
read the same codes slot for slot.

``hnsw_store_from_reference`` carries an ``HnswIndex`` store across: the
graph's ``export_padded_tables()`` (numpy arrays: rows, adjacency, levels,
entry point) are imported into a port graph of the same parameters, so
the two traversals walk the same graph.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from .distance import DistanceMetric
from .index.flat import FlatIndex
from .index.hnsw import HnswIndex, HnswParams
from .index.pq import PqFlatIndex
from .store import VectorStore


def store_from_reference(vectors: np.ndarray, valid: np.ndarray,
                         id_of_slot: np.ndarray,
                         internal_to_string: Dict[int, str],
                         metric: DistanceMetric, device="cuda",
                         search_mode: str = "exact",
                         metadata: Optional[Dict[int, Dict[str, str]]] = None,
                         storage: str = "f32") -> VectorStore:
    """A port ``VectorStore`` over ``FlatIndex(metric, search_mode,
    storage, device=device)`` holding the exported rows in their original
    slots, under their original internal and string ids. ``metadata`` maps
    internal id -> fields (the JAX store's ``get_metadata`` per id).
    ``storage`` should be the exporting index's own mode: its stored
    values then pass through unchanged."""
    index = FlatIndex(metric, search_mode=search_mode, storage=storage,
                      device=device)
    index.adopt_packed(vectors, valid, id_of_slot)
    return _wrap(index, valid, id_of_slot, internal_to_string, metadata)


def pq_store_from_reference(vectors: np.ndarray, valid: np.ndarray,
                            id_of_slot: np.ndarray,
                            internal_to_string: Dict[int, str],
                            metric: DistanceMetric,
                            trained_state: Optional[dict],
                            codes: Optional[np.ndarray] = None,
                            device="cuda",
                            metadata: Optional[Dict[int, Dict[str, str]]]
                            = None, **pq_kwargs) -> VectorStore:
    """A port ``VectorStore`` over ``PqFlatIndex(metric, device=device,
    **pq_kwargs)`` with the exported rows in their original slots and
    ids, trained with the JAX index's ``export_trained_state()`` (None:
    left untrained). ``codes`` (capacity, m) uint8, the JAX index's
    ``_codes``, are taken as they are; without them the port encodes the
    rows itself at the first search."""
    index = PqFlatIndex(metric, device=device, **pq_kwargs)
    index.adopt_packed(vectors, valid, id_of_slot)
    if trained_state is not None:
        index.import_trained_state(trained_state)
        if codes is not None:
            index.adopt_codes(codes)
    elif codes is not None:
        raise ValueError("codes need the trained state they came from")
    return _wrap(index, valid, id_of_slot, internal_to_string, metadata)


def hnsw_store_from_reference(tables: dict,
                              internal_to_string: Dict[int, str],
                              metric: DistanceMetric, params: HnswParams,
                              backend: str = "auto",
                              metadata: Optional[Dict[int, Dict[str, str]]]
                              = None) -> VectorStore:
    """A port ``VectorStore`` over ``HnswIndex(metric, params, backend)``
    whose graph is the JAX index's, from its ``graph.export_padded_tables()``
    (``params`` must match the exporting graph's m, m_max0 and
    max_layers). ``metadata`` maps internal id -> fields."""
    index = HnswIndex(metric, params, backend=backend)
    if np.asarray(tables["vectors"]).shape[0]:
        index.graph.import_padded_tables(tables)
    valid = np.asarray(tables["valid"], bool)
    id_of_slot = np.asarray(tables["id_of_slot"], np.int64)
    return _wrap(index, valid, id_of_slot, internal_to_string, metadata)


def _wrap(index, valid, id_of_slot, internal_to_string, metadata
          ) -> VectorStore:
    live_ids = set(np.asarray(id_of_slot)[np.asarray(valid, bool)].tolist())
    id_map = {int(iid): str(sid) for iid, sid in internal_to_string.items()}
    if set(id_map) != live_ids:
        raise ValueError("internal_to_string must name exactly the live "
                         "slots' internal ids")
    store = VectorStore(index)
    store.adopt_index_state(id_map, metadata or {},
                            next_id=max(id_map, default=-1) + 1,
                            dimension=index.dimension)
    return store


__all__ = ["store_from_reference", "pq_store_from_reference",
           "hnsw_store_from_reference"]
