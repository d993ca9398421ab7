"""One caller in a closed loop of synchronous batched searches.

Each call is ``search(batch)`` on the next batch of the pool, cycling it,
back to back, until ``seconds`` have passed since the first call started;
the call under way then finishes. Inside the window the driver opens one
profiler range around each call, reads the clock, writes the latency into
a preallocated array and keeps the answers of the first ``keep`` calls:
nothing else.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

CALL_RANGE = "vdbbench/search_batch"
_MAX_CALLS = 1 << 20


@dataclass
class Window:
    latencies: np.ndarray          # seconds, one a call
    start: float                   # perf_counter at the first call's start
    end: float                     # perf_counter at the last call's end
    queries: int                   # queries answered in the window
    kept: list                     # answers of the first ``keep`` calls
    failed: int = 0
    errors: list = field(default_factory=list)

    @property
    def calls(self) -> int:
        return int(self.latencies.shape[0])


def run(search, pool, seconds: float, keep: int) -> Window:
    """Drive ``search`` over ``pool`` (a list of batches) for ``seconds``.
    ``keep`` <= len(pool): the kept answers are of distinct batches."""
    lat = np.zeros(_MAX_CALLS, dtype=np.float64)
    kept = [None] * keep
    errors = []
    size = len(pool)
    per_call = len(pool[0])
    record = torch.profiler.record_function
    clock = time.perf_counter
    n = failed = 0
    start = t0 = clock()
    deadline = start + seconds
    while True:
        with record(CALL_RANGE):
            try:
                res = search(pool[n % size])
            except Exception as exc:    # counted; the run is then not correct
                res = None
                failed += 1
                if len(errors) < 4:
                    errors.append(repr(exc))
        t1 = clock()
        lat[n] = t1 - t0
        if n < keep:
            kept[n] = res
        n += 1
        if t1 >= deadline or n == _MAX_CALLS:
            break
        t0 = t1
    return Window(lat[:n].copy(), start, t1, n * per_call, kept, failed,
                  errors)
