"""Tracing / profiling hooks.

The reference's observability is wall-clock timing feeding MetricsCollector
(src/server/routes.rs:242-271). On the GPU the interesting half lives on
the device, so this module adds torch.profiler integration:

  * ``trace(path)`` — capture a CPU + CUDA trace around any block and
    write it as a Chrome trace
  * ``annotate(name)`` — a named ``record_function`` range so store/index
    phases show up inside the device trace
  * ``timed()`` — wall-clock timing helper that synchronises the device
    on exit, so recorded latencies include real device time (asynchronous
    launches otherwise under-report)
"""

from __future__ import annotations

import contextlib
import time

import torch


@contextlib.contextmanager
def trace(path: str):
    """Capture a torch.profiler trace of the enclosed block into ``path``
    (Chrome trace JSON)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(path)


def annotate(name: str):
    """Named range visible in profiler traces."""
    return torch.profiler.record_function(name)


class timed:
    """Context manager measuring wall-clock seconds; synchronises the
    device of a registered tensor (``block_on``) before stopping."""

    def __init__(self):
        self.seconds = 0.0
        self._block = None

    def block_on(self, value):
        self._block = value
        return value

    def __enter__(self):
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if isinstance(self._block, torch.Tensor) and self._block.is_cuda:
            torch.cuda.synchronize(self._block.device)
        self.seconds = time.perf_counter() - self._start
        return False


__all__ = ["trace", "annotate", "timed"]
