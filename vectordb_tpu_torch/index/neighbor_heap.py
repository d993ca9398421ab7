"""Bounded priority queues for graph traversal.

Port of ``vectordb_tpu/index/neighbor_heap.py`` (pure Python, unchanged).
Capability parity with reference src/hnsw/neighbor_queue.rs:7-140: the HNSW
beam search needs a min-heap of candidates and a size-bounded max-heap of
current-best results, with a deterministic total order on (distance, id)
(the reference builds a total order over f32 by comparing distance then id;
Python tuples of (float, int) give the same ordering as long as distances
are never NaN, which the distance layer guarantees).
"""

from __future__ import annotations

import heapq
from typing import List, Tuple


class MinHeap:
    """Candidate queue: pop returns the closest (distance, id) first."""

    __slots__ = ("_heap",)

    def __init__(self):
        self._heap: List[Tuple[float, int]] = []

    def push(self, distance: float, node_id: int) -> None:
        heapq.heappush(self._heap, (distance, node_id))

    def pop(self) -> Tuple[float, int]:
        return heapq.heappop(self._heap)

    def peek(self) -> Tuple[float, int]:
        return self._heap[0]

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)


class BoundedMaxHeap:
    """Result set bounded to ``bound`` elements; tracks the *worst* kept
    distance at the top so beam search can early-terminate
    (reference push_bounded: src/hnsw/neighbor_queue.rs:78-83)."""

    __slots__ = ("_heap", "bound")

    def __init__(self, bound: int):
        self.bound = bound
        # stored as (-distance, -id) so heapq's min-heap acts as a max-heap
        # with the same (distance, id) tie ordering as the reference
        self._heap: List[Tuple[float, int]] = []

    def push_bounded(self, distance: float, node_id: int) -> bool:
        """Insert if it improves the set; returns True if inserted."""
        item = (-distance, -node_id)
        if len(self._heap) < self.bound:
            heapq.heappush(self._heap, item)
            return True
        if item > self._heap[0]:  # better than current worst
            heapq.heapreplace(self._heap, item)
            return True
        return False

    def worst_distance(self) -> float:
        return -self._heap[0][0]

    def is_full(self) -> bool:
        return len(self._heap) >= self.bound

    def into_sorted(self) -> List[Tuple[float, int]]:
        """(distance, id) ascending by distance (then id)."""
        return sorted((-d, -i) for d, i in self._heap)

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)


__all__ = ["MinHeap", "BoundedMaxHeap"]
