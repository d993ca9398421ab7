"""HNSW graph (Malkov & Yashunin) over packed array storage.

Algorithmic parity with reference src/hnsw/graph.rs:19-424:
  * params m / m_max0=2m / ef_construction / ef_search / ml=1/ln(m) /
    max_layers (graph.rs:19-60) with the same defaults;
  * geometric level sampling  level = floor(-ln(U) * ml)  capped at
    max_layers-1 (graph.rs:119-123);
  * Algorithm 2 beam search per layer with a visited set, a candidate
    min-heap and an ef-bounded result max-heap (graph.rs:143-199);
  * Algorithm 1 insert: greedy descent with ef=1 above the node's level,
    then per-layer ef_construction search + bidirectional linking with
    re-scoring prune (graph.rs:245-342);
  * removal strips back-edges from the node's own neighbors and promotes a
    new entry point when needed (graph.rs:345-381); traversal skips dead
    slots, so stale in-links are harmless;
  * Algorithm 5 search: descend to layer 1 with ef=1, then a layer-0 search
    with ef=max(ef, k) (graph.rs:386-414).

Port of ``vectordb_tpu/index/hnsw_graph.py``: the graph and its search stay
on the host in numpy, as in the JAX package, so the same seed and rows
give the same tables and answers in both packages. Vectors live in a packed
``f32[capacity, d]`` matrix, per-hop neighbor distance evaluations are
*batched* numpy ops over gathered rows (one BLAS call per expansion instead
of m scalar loops), and the adjacency exports as padded
``int32[N, layers, m_max]`` tables (``export_padded_tables``: the engine's
``hnsw_graph.npz``, and the input of the device traversal, ROADMAP queue 1
item 10b).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..distance import DistanceMetric
from ..errors import DimensionMismatchError, InvalidVectorError
from ..ops.topk import next_pow2
from .neighbor_heap import BoundedMaxHeap, MinHeap

_MIN_CAPACITY = 256


@dataclass
class HnswParams:
    """Construction/search parameters (reference defaults graph.rs:35-47)."""

    m: int = 16
    m_max0: Optional[int] = None          # defaults to 2*m
    ef_construction: int = 200
    ef_search: int = 50
    ml: Optional[float] = None            # defaults to 1/ln(m)
    max_layers: int = 16
    # RNG seed for level sampling; a seeded graph also builds on one
    # thread (hnsw_native.NativeHnswGraph.insert_batch), so the same seed
    # and rows always give the same graph
    seed: Optional[int] = None

    def __post_init__(self):
        if self.m_max0 is None:
            self.m_max0 = 2 * self.m
        if self.ml is None:
            self.ml = 1.0 / math.log(self.m)

    def max_degree(self, layer: int) -> int:
        return self.m_max0 if layer == 0 else self.m


class HnswGraph:
    """Hierarchical navigable small-world graph on packed arrays."""

    def __init__(self, metric: DistanceMetric, params: Optional[HnswParams] = None):
        self.metric = metric
        self.params = params or HnswParams()
        self._rng = np.random.default_rng(self.params.seed)
        self._dim: Optional[int] = None
        self._capacity = 0
        self._len = 0
        self._vectors: Optional[np.ndarray] = None    # f32[capacity, d]
        self._norms: Optional[np.ndarray] = None      # f32[capacity]
        self._sq_norms: Optional[np.ndarray] = None   # f32[capacity]
        self._valid: Optional[np.ndarray] = None      # bool[capacity]
        self._levels: Optional[np.ndarray] = None     # int32[capacity], -1 dead
        # adjacency: per slot, a list over layers 0..level of neighbor slot lists
        self._neighbors: List[List[List[int]]] = []
        self._id_of_slot: Optional[np.ndarray] = None  # int64[capacity]
        self._slot_of_id: Dict[int, int] = {}
        self._free_slots: List[int] = []
        self._entry: Optional[int] = None   # entry point slot
        self._max_level = 0
        self.version = 0  # bumped on every mutation (device-table caching)

    # -- properties ---------------------------------------------------------

    @property
    def dimension(self) -> Optional[int]:
        return self._dim

    @property
    def capacity(self) -> int:
        return self._capacity

    def __len__(self) -> int:
        return self._len

    def slot_of(self, internal_id: int) -> Optional[int]:
        return self._slot_of_id.get(internal_id)

    def id_of(self, slot: int) -> int:
        return int(self._id_of_slot[slot])

    # -- storage ------------------------------------------------------------

    def _ensure_storage(self, dim: int, want_rows: int) -> None:
        if self._dim is None:
            self._dim = dim
        needed = max(want_rows, _MIN_CAPACITY)
        if self._capacity >= needed:
            return
        new_cap = next_pow2(needed, floor=_MIN_CAPACITY)
        new_vectors = np.zeros((new_cap, self._dim), dtype=np.float32)
        new_norms = np.zeros(new_cap, dtype=np.float32)
        new_sq = np.zeros(new_cap, dtype=np.float32)
        new_valid = np.zeros(new_cap, dtype=bool)
        new_levels = np.full(new_cap, -1, dtype=np.int32)
        new_ids = np.full(new_cap, -1, dtype=np.int64)
        if self._capacity:
            new_vectors[: self._capacity] = self._vectors
            new_norms[: self._capacity] = self._norms
            new_sq[: self._capacity] = self._sq_norms
            new_valid[: self._capacity] = self._valid
            new_levels[: self._capacity] = self._levels
            new_ids[: self._capacity] = self._id_of_slot
        self._free_slots.extend(range(new_cap - 1, self._capacity - 1, -1))
        self._neighbors.extend([] for _ in range(new_cap - self._capacity))
        self._vectors, self._norms, self._sq_norms = (new_vectors, new_norms,
                                                      new_sq)
        self._valid, self._levels, self._id_of_slot = new_valid, new_levels, new_ids
        self._capacity = new_cap

    def _take_slot(self) -> int:
        if not self._free_slots:
            self._ensure_storage(self._dim,
                                 self._capacity * 2 if self._capacity else 1)
        return self._free_slots.pop()

    # -- distances (batched per expansion) ----------------------------------

    def _dists_to_slots(self, query: np.ndarray, query_norm: float,
                        slots: np.ndarray) -> np.ndarray:
        """Distances from ``query`` (d,) to the given slots, one BLAS call.

        Euclidean uses |x|^2 + |q|^2 - 2 x.q with precomputed squared row
        norms: one gemv + two vector ops instead of materializing the
        difference matrix (the build hot loop calls this ~100x per insert).
        """
        rows = self._vectors[slots]
        dots = rows @ query
        if self.metric is DistanceMetric.EUCLIDEAN:
            d2 = self._sq_norms[slots] + query_norm * query_norm - 2.0 * dots
            return np.sqrt(np.maximum(d2, 0.0))
        if self.metric is DistanceMetric.DOT_PRODUCT:
            return -dots
        norms = self._norms[slots]
        if query_norm == 0.0 or np.any(norms == 0.0):
            raise InvalidVectorError(
                "Cannot compute cosine distance with zero vector")
        sim = np.clip(dots / (norms * query_norm), -1.0, 1.0)
        return 1.0 - sim

    # -- Algorithm 2: layer beam search (reference graph.rs:143-199) ---------

    def _search_layer(self, query: np.ndarray, query_norm: float,
                      entry_points: List[Tuple[float, int]], ef: int,
                      layer: int, mask: Optional[np.ndarray] = None,
                      visit_budget: int = 0) -> List[Tuple[float, int]]:
        """Algorithm 2. With ``mask`` only mask-passing slots enter the
        RESULT set (navigation expands every neighbor — the standard
        filtered-HNSW shape); ``visit_budget`` bounds the expansion when
        eligible nodes are rare (0 = unbounded)."""
        visited = set()
        candidates = MinHeap()
        results = BoundedMaxHeap(ef)
        visits = 0
        for dist, slot in entry_points:
            if slot in visited:
                continue
            visited.add(slot)
            candidates.push(dist, slot)
            if mask is None or mask[slot]:
                results.push_bounded(dist, slot)
        valid = self._valid
        neighbors = self._neighbors
        visited_add = visited.add
        while candidates:
            c_dist, c_slot = candidates.pop()
            full = results.is_full()
            worst = results.worst_distance() if full else math.inf
            if full and c_dist > worst:
                break
            if visit_budget and visits > visit_budget:
                break
            layer_lists = neighbors[c_slot]
            if layer >= len(layer_lists):
                continue
            fresh = [s for s in layer_lists[layer]
                     if s not in visited and valid[s]]
            if not fresh:
                continue
            for s in fresh:
                visited_add(s)
            visits += len(fresh)
            dists = self._dists_to_slots(query, query_norm,
                                         np.asarray(fresh, dtype=np.int64))
            # vectorized pre-filter: only candidates that can improve the
            # result set reach the heaps (conservative — ``worst`` only
            # shrinks as pushes land, and push_bounded re-checks)
            if full:
                keep = np.nonzero(dists < worst)[0]
                if keep.shape[0] == 0:
                    continue
                pairs = [(float(dists[i]), fresh[i]) for i in keep]
            else:
                pairs = [(float(d), s) for d, s in zip(dists, fresh)]
            for dist, slot in pairs:
                if mask is None:
                    if results.push_bounded(dist, slot):
                        candidates.push(dist, slot)
                else:
                    # navigation is unmasked: a node can guide the beam
                    # even when ineligible for the result set
                    if not full or dist < worst:
                        candidates.push(dist, slot)
                    if mask[slot]:
                        results.push_bounded(dist, slot)
        return results.into_sorted()

    # -- pruning (reference graph.rs:202-242) --------------------------------

    def _prune_neighbors(self, slot: int, layer: int) -> None:
        """Re-score this node's layer adjacency and keep the closest
        max_degree entries."""
        neigh = [s for s in self._neighbors[slot][layer] if self._valid[s]]
        limit = self.params.max_degree(layer)
        if len(neigh) <= limit:
            self._neighbors[slot][layer] = neigh
            return
        q = self._vectors[slot]
        qn = float(self._norms[slot])
        dists = self._dists_to_slots(q, qn, np.asarray(neigh, dtype=np.int64))
        order = np.argsort(dists, kind="stable")[:limit]
        self._neighbors[slot][layer] = [neigh[i] for i in order]

    # -- level sampling (reference graph.rs:119-123) -------------------------

    def _random_level(self) -> int:
        u = self._rng.random()
        u = max(u, 1e-12)
        level = int(-math.log(u) * self.params.ml)
        return min(level, self.params.max_layers - 1)

    # -- Algorithm 1: insert (reference graph.rs:245-342) --------------------

    def insert(self, internal_id: int, vector: np.ndarray) -> None:
        arr = np.asarray(vector, dtype=np.float32).reshape(-1)
        dim = arr.shape[0]
        if self._dim is not None and dim != self._dim:
            raise DimensionMismatchError(self._dim, dim)
        if internal_id in self._slot_of_id:
            self.remove(internal_id)
        self._ensure_storage(dim, self._len + 1)
        slot = self._take_slot()
        level = self._random_level()
        self._vectors[slot] = arr
        sq = float(np.dot(arr, arr))
        self._sq_norms[slot] = sq
        self._norms[slot] = math.sqrt(sq)
        self._levels[slot] = level
        self._valid[slot] = True
        self._id_of_slot[slot] = internal_id
        self._slot_of_id[internal_id] = slot
        self._neighbors[slot] = [[] for _ in range(level + 1)]
        self._len += 1
        self.version += 1

        if self._entry is None:
            self._entry = slot
            self._max_level = level
            return

        qn = float(self._norms[slot])
        ep_dist = float(self._dists_to_slots(
            arr, qn, np.asarray([self._entry], dtype=np.int64))[0])
        eps: List[Tuple[float, int]] = [(ep_dist, self._entry)]

        # Phase 1: greedy descent with ef=1 above the node's level
        for layer in range(self._max_level, level, -1):
            eps = self._search_layer(arr, qn, eps, 1, layer)

        # Phase 2: connect on each layer from min(level, max_level) down to 0
        for layer in range(min(level, self._max_level), -1, -1):
            found = self._search_layer(arr, qn, eps,
                                       self.params.ef_construction, layer)
            # select_neighbors_simple: take the m closest (graph.rs:202-204)
            selected = [s for _, s in found[: self.params.m]]
            self._neighbors[slot][layer] = list(selected)
            limit = self.params.max_degree(layer)
            for nb in selected:
                nb_layers = self._neighbors[nb]
                if layer >= len(nb_layers):
                    continue
                nb_layers[layer].append(slot)
                if len(nb_layers[layer]) > limit:
                    self._prune_neighbors(nb, layer)
            eps = found

        if level > self._max_level:
            self._entry = slot
            self._max_level = level

    # -- removal (reference graph.rs:345-381) --------------------------------

    def remove(self, internal_id: int) -> None:
        slot = self._slot_of_id.pop(internal_id, None)
        if slot is None:
            return
        for layer, neigh in enumerate(self._neighbors[slot]):
            for nb in neigh:
                nb_layers = self._neighbors[nb]
                if layer < len(nb_layers) and slot in nb_layers[layer]:
                    nb_layers[layer].remove(slot)
        self._neighbors[slot] = []
        self._valid[slot] = False
        self._levels[slot] = -1
        self._id_of_slot[slot] = -1
        self._free_slots.append(slot)
        self._len -= 1
        self.version += 1
        if self._entry == slot:
            self._entry = None
            self._max_level = 0
            if self._len:
                live = np.nonzero(self._valid)[0]
                best = live[np.argmax(self._levels[live])]
                self._entry = int(best)
                self._max_level = int(self._levels[best])

    # -- Algorithm 5: k-NN search (reference graph.rs:386-414) ---------------

    def search_knn(self, query: np.ndarray, k: int,
                   ef: Optional[int] = None,
                   mask: Optional[np.ndarray] = None,
                   visit_budget: int = 0) -> List[Tuple[int, float]]:
        """k nearest as (internal_id, distance) ascending. ``mask``
        (bool[capacity] over slots) makes the layer-0 result set admit
        only eligible slots — exact filtered search without the 3x
        over-fetch (navigation stays unmasked)."""
        if self._entry is None or self._len == 0 or k <= 0:
            return []
        arr = np.asarray(query, dtype=np.float32).reshape(-1)
        if self._dim is not None and arr.shape[0] != self._dim:
            raise DimensionMismatchError(self._dim, arr.shape[0])
        ef = self.params.ef_search if ef is None else int(ef)
        ef = max(ef, k)
        qn = float(np.sqrt(np.dot(arr, arr)))
        ep_dist = float(self._dists_to_slots(
            arr, qn, np.asarray([self._entry], dtype=np.int64))[0])
        eps: List[Tuple[float, int]] = [(ep_dist, self._entry)]
        for layer in range(self._max_level, 0, -1):
            eps = self._search_layer(arr, qn, eps, 1, layer)
        found = self._search_layer(arr, qn, eps, ef, 0, mask=mask,
                                   visit_budget=visit_budget)
        return [(self.id_of(slot), dist) for dist, slot in found[:k]]

    # -- lookups / export ----------------------------------------------------

    def get_vector(self, internal_id: int) -> Optional[np.ndarray]:
        slot = self._slot_of_id.get(internal_id)
        if slot is None:
            return None
        return self._vectors[slot].copy()

    def iter_items(self):
        for slot in np.nonzero(self._valid)[0] if self._valid is not None else []:
            yield int(self._id_of_slot[slot]), self._vectors[slot].copy()

    def import_padded_tables(self, tables: dict) -> None:
        """Restore a graph from export_padded_tables output."""
        if self._len != 0:
            raise RuntimeError("import requires an empty graph")
        vectors = np.asarray(tables["vectors"], dtype=np.float32)
        cap, dim = vectors.shape
        if cap == 0:
            return
        # validate before mutating: corrupt tables must fail cleanly so the
        # engine can fall back to a rebuild
        levels_in = np.asarray(tables["levels"], dtype=np.int32)
        valid_in = np.asarray(tables["valid"], dtype=bool)
        neighbors_in = np.asarray(tables["neighbors"], dtype=np.int32)
        if int(tables["entry"]) >= cap or \
                int(tables["max_level"]) >= self.params.max_layers:
            raise ValueError("graph tables out of range")
        if np.any((levels_in[valid_in] < 0)
                  | (levels_in[valid_in] >= self.params.max_layers)):
            raise ValueError("graph levels out of range")
        if np.any(neighbors_in >= cap):
            raise ValueError("graph neighbor slots out of range")
        self._ensure_storage(dim, cap)
        cap_eff = self._capacity  # >= cap after pow2 rounding
        self._vectors[:cap] = vectors
        self._sq_norms[:cap] = np.einsum("ij,ij->i", vectors, vectors)
        self._norms[:cap] = np.sqrt(self._sq_norms[:cap])
        self._levels[:cap] = np.asarray(tables["levels"], dtype=np.int32)
        self._id_of_slot[:cap] = np.asarray(tables["id_of_slot"],
                                            dtype=np.int64)
        valid = np.asarray(tables["valid"], dtype=bool)
        self._valid[:cap] = valid
        neighbors = np.asarray(tables["neighbors"], dtype=np.int32)
        self._free_slots = [s for s in range(cap_eff - 1, -1, -1)
                            if s >= cap or not valid[s]]
        self._slot_of_id.clear()
        self._len = 0
        for slot in np.nonzero(valid)[0]:
            slot = int(slot)
            iid = int(self._id_of_slot[slot])
            self._slot_of_id[iid] = slot
            level = int(self._levels[slot])
            self._neighbors[slot] = [
                [int(x) for x in neighbors[slot, layer]
                 if x >= 0]
                for layer in range(level + 1)
            ]
            self._len += 1
        self._entry = int(tables["entry"]) if int(tables["entry"]) >= 0 \
            else None
        self._max_level = int(tables["max_level"])
        self.version += 1

    def export_padded_tables(self) -> dict:
        """Pack adjacency into padded device tables.

        Returns vectors f32[capacity, d], neighbor table int32[capacity,
        max_layers, m_max0] (-1 padded), levels int32[capacity], valid
        bool[capacity], entry slot and max_level — the structure-of-arrays
        form consumed by the device-side traversal (ops/hnsw_device.py).
        """
        pad = self.params.m_max0
        layers = self.params.max_layers
        if self._vectors is None:  # empty graph: nothing allocated yet
            return {
                "vectors": np.zeros((0, 0), dtype=np.float32),
                "norms": np.zeros(0, dtype=np.float32),
                "neighbors": np.full((0, layers, pad), -1, dtype=np.int32),
                "levels": np.zeros(0, dtype=np.int32),
                "valid": np.zeros(0, dtype=bool),
                "id_of_slot": np.zeros(0, dtype=np.int64),
                "entry": -1,
                "max_level": 0,
            }
        table = np.full((self._capacity, layers, pad), -1, dtype=np.int32)
        for slot in range(self._capacity):
            if not self._valid[slot]:
                continue
            for layer, neigh in enumerate(self._neighbors[slot]):
                trimmed = neigh[:pad]
                table[slot, layer, : len(trimmed)] = trimmed
        return {
            "vectors": self._vectors.copy(),
            "norms": self._norms.copy(),
            "neighbors": table,
            "levels": self._levels.copy(),
            "valid": self._valid.copy(),
            "id_of_slot": self._id_of_slot.copy(),
            "entry": -1 if self._entry is None else int(self._entry),
            "max_level": int(self._max_level),
        }


__all__ = ["HnswGraph", "HnswParams"]
