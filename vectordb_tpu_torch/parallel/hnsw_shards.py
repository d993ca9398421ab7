"""Sharded HNSW: independent per-shard graphs + top-k merge.

Port of ``vectordb_tpu/parallel/hnsw_shards.py``. Rows are partitioned
round-robin (internal id mod S) into S independent HNSW graphs on the
host; a query fans out to every shard and the S local top-k lists are
merged by ``heapq.merge`` on (distance, id). Shard ``s`` seeds its level
sampling with ``seed + s``, as in the JAX package, so the same rows give
the same graphs. Recall matches a single graph at equal ef because every
shard is searched.
"""

from __future__ import annotations

import heapq
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..distance import DistanceMetric
from ..index.hnsw import HnswIndex, HnswParams
from ..vector import Vector


class ShardedHnswIndex:
    def __init__(self, n_shards: int, metric: DistanceMetric,
                 params: Optional[HnswParams] = None):
        if n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        base = params or HnswParams()
        self.n_shards = n_shards
        self.metric = metric
        self._shards = []
        for s in range(n_shards):
            seed = None if base.seed is None else base.seed + s
            # the graphs live on the host: rows arrive one at a time, so no
            # device build runs
            self._shards.append(HnswIndex(metric, HnswParams(
                m=base.m, m_max0=base.m_max0,
                ef_construction=base.ef_construction,
                ef_search=base.ef_search, ml=base.ml,
                max_layers=base.max_layers, seed=seed),
                bulk_build="host", device="cpu"))

    def _shard_of(self, internal_id: int) -> HnswIndex:
        return self._shards[internal_id % self.n_shards]

    def add(self, internal_id: int, vector: Vector) -> None:
        self._shard_of(internal_id).add(internal_id, vector)

    def build_batch(self, items: Sequence[Tuple[int, Vector]]) -> None:
        for internal_id, vector in items:
            self.add(internal_id, vector)

    def remove(self, internal_id: int) -> None:
        self._shard_of(internal_id).remove(internal_id)

    def __len__(self) -> int:
        return sum(len(s) for s in self._shards)

    def search(self, query: Vector, k: int,
               ef: Optional[int] = None) -> List[Tuple[int, float]]:
        """Fan out to every shard, merge the S local top-k lists."""
        per_shard = []
        for shard in self._shards:
            if ef is None:
                per_shard.append(shard.search(query, k))
            else:
                per_shard.append(shard.search_with_ef(query, k, ef))
        merged = heapq.merge(*per_shard, key=lambda t: (t[1], t[0]))
        return [item for _, item in zip(range(k), merged)]

    def search_batch(self, queries: np.ndarray, k: int,
                     ef: Optional[int] = None
                     ) -> List[List[Tuple[int, float]]]:
        return [self.search(Vector(queries[i]), k, ef)
                for i in range(queries.shape[0])]


__all__ = ["ShardedHnswIndex"]
