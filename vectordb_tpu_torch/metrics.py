"""Observability metrics: query latency, insert/delete counters.

Capability parity with reference src/metrics.rs:7-73 (record_query /
record_insert / record_delete, avg, rounded-rank percentile). Latencies are
recorded in microseconds. Unlike the reference's unbounded Vec, the latency
reservoir is bounded (default 1<<20 samples, ring-buffer) so a long-running
server does not grow without limit; within the bound the percentile math is
identical (sort a copy, index = round(p/100 * (n-1))).
"""

from __future__ import annotations

import threading


class MetricsCollector:
    def __init__(self, max_samples: int = 1 << 20):
        self._max_samples = max(1, max_samples)
        self._latencies_us: list[float] = []
        self._ring_pos = 0
        self._total_queries = 0
        self._total_inserts = 0
        self._total_deletes = 0
        self._lock = threading.Lock()

    # -- recording ---------------------------------------------------------

    def record_query(self, duration_seconds: float) -> None:
        us = float(duration_seconds) * 1e6
        with self._lock:
            self._total_queries += 1
            if len(self._latencies_us) < self._max_samples:
                self._latencies_us.append(us)
            else:
                self._latencies_us[self._ring_pos] = us
                self._ring_pos = (self._ring_pos + 1) % self._max_samples

    def record_insert(self, n: int = 1) -> None:
        with self._lock:
            self._total_inserts += n

    def record_delete(self, n: int = 1) -> None:
        with self._lock:
            self._total_deletes += n

    # -- totals ------------------------------------------------------------

    @property
    def total_queries(self) -> int:
        return self._total_queries

    @property
    def total_inserts(self) -> int:
        return self._total_inserts

    @property
    def total_deletes(self) -> int:
        return self._total_deletes

    # -- aggregates (reference: src/metrics.rs:53-72) ----------------------

    def avg_query_latency_us(self) -> float:
        with self._lock:
            if not self._latencies_us:
                return 0.0
            return sum(self._latencies_us) / len(self._latencies_us)

    def percentile_query_latency_us(self, percentile: float) -> float:
        with self._lock:
            if not self._latencies_us:
                return 0.0
            ordered = sorted(self._latencies_us)
        index = round((percentile / 100.0) * (len(ordered) - 1))
        index = min(max(index, 0), len(ordered) - 1)
        return ordered[index]

    def snapshot(self) -> dict:
        """All metrics as a JSON-able dict (shape of GET /metrics,
        reference: src/server/routes.rs:84-93)."""
        return {
            "total_queries": self.total_queries,
            "total_inserts": self.total_inserts,
            "total_deletes": self.total_deletes,
            "avg_query_latency_us": self.avg_query_latency_us(),
            "p50_query_latency_us": self.percentile_query_latency_us(50.0),
            "p95_query_latency_us": self.percentile_query_latency_us(95.0),
            "p99_query_latency_us": self.percentile_query_latency_us(99.0),
        }


__all__ = ["MetricsCollector"]
