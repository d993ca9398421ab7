"""Tracing / profiling hooks.

The reference's observability is wall-clock timing feeding MetricsCollector
(src/server/routes.rs:242-271). On the GPU the interesting half lives on
the device, so this module adds torch.profiler integration:

  * ``trace(logdir)`` — capture a CPU + CUDA trace around any block and
    write it as a Chrome trace
  * ``annotate(name)`` — the program's one kind of span: it adds to an
    in-process table (``spans()``: count, total and self seconds by name)
    and, while a profiler records, opens a ``record_function`` range of
    the same name, so the range lands in the device trace on its clock
  * ``count(name, n)`` — a named integer counter beside the span table
    (``counters()``), for work that a span's time cannot show: how many
    queries a tier re-ran. One locked dict update, no clock read
  * ``python/gc`` — the interpreter's collections, as spans (a hook in
    ``gc.callbacks``, registered at import), and each collection counted
    by its generation in ``python/gc.gen0``, ``gen1`` and ``gen2`` (a
    full pass of the heap)
  * ``timed()`` — wall-clock timing helper that synchronises the device
    on exit, so recorded latencies include real device time (asynchronous
    launches otherwise under-report)

A span's self seconds are its total less the spans nested in it on the
same thread (a thread-local stack gives the nesting) and less the
collections that ran inside its interval on that thread: each thread
keeps a running sum of its collections' time, read with each clock
reading. With no profiler recording, a span costs two clock reads and
one table update.
"""

from __future__ import annotations

import contextlib
import gc
import threading
import time

import torch

GC_SPAN = "python/gc"

_clock = time.perf_counter_ns
_profiler_enabled = torch._C._autograd._profiler_enabled
# name -> [count, total ns, self ns]; an RLock because a collection (and
# so the gc hook) may start between any two bytecodes, also inside the
# update that holds it
_table: dict = {}
# name -> int, under the same lock
_counts: dict = {}
_lock = threading.RLock()
_local = threading.local()


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a torch.profiler trace of the enclosed block into
    ``logdir``, a Chrome trace JSON file (the JAX package's name for the
    parameter, whose ``jax.profiler`` writes a directory)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(logdir)


def _thread() -> list:
    """This thread's [span stack, ns of its collections so far, the open
    collection's (record_function or None, start ns) or None]."""
    try:
        return _local.state
    except AttributeError:
        _local.state = [[], 0, None]
        return _local.state


def _now(state: list) -> tuple:
    """(clock ns, the thread's collection ns) with no collection between
    the two readings: one that runs right after the clock is read (the
    interpreter runs them at such points) makes the pair read again."""
    while True:
        gc_ns = state[1]
        now = _clock()
        if state[1] == gc_ns:
            return now, gc_ns


def _open(name: str) -> list:
    """Push a frame [name, record_function or None, start ns, children's
    ns less their collections, collection ns at the start]."""
    rf = None
    if _profiler_enabled():
        rf = torch.profiler.record_function(name)
        rf.__enter__()
    state = _thread()
    frame = [name, rf, 0, 0, 0]
    state[0].append(frame)
    frame[2], frame[4] = _now(state)
    return frame


def _close(frame: list) -> None:
    state = _thread()
    end, gc_ns = _now(state)
    stack = state[0]
    stack.pop()                 # ``frame``: spans nest on a thread
    total = end - frame[2]
    own = total - (gc_ns - frame[4])    # less the collections inside
    if stack:
        stack[-1][3] += own
    _add(frame[0], total, own - frame[3])
    if frame[1] is not None:
        frame[1].__exit__(None, None, None)


def _add(name: str, total: int, self_ns: int) -> None:
    with _lock:
        entry = _table.get(name)
        if entry is None:
            entry = _table[name] = [0, 0, 0]
        entry[0] += 1
        entry[1] += total
        entry[2] += self_ns


class annotate:
    """A named span (see the module docstring); a context manager."""

    __slots__ = ("name", "_frame")

    def __init__(self, name: str):
        self.name = name
        self._frame = None

    def __enter__(self):
        self._frame = _open(self.name)
        return self

    def __exit__(self, *exc):
        _close(self._frame)
        return False


def spans() -> dict:
    """A copy of the span table: name -> {"count", "total_s", "self_s"}."""
    with _lock:
        # one C call: a collection's hook cannot add a name mid-iteration
        items = list(_table.items())
        items = [(name, tuple(entry)) for name, entry in items]
    return {name: {"count": c, "total_s": t * 1e-9, "self_s": s * 1e-9}
            for name, (c, t, s) in items}


def reset_spans() -> None:
    """Clear the span table and the counters."""
    with _lock:
        _table.clear()
        _counts.clear()


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    with _lock:
        _counts[name] = _counts.get(name, 0) + int(n)


def counters() -> dict:
    """A copy of the counters: name -> int. The table also holds the
    collector's ``python/gc.gen*`` counts, which a collection can add at
    any allocation: an exact comparison of the table leaves them out."""
    with _lock:
        return dict(_counts)


def _on_gc(phase: str, info: dict) -> None:
    """``gc.callbacks`` hook: a collection is the span ``python/gc``, its
    time added to the thread's collection ns, and one more of the counter
    ``python/gc.gen<generation>``. Never raises."""
    try:
        state = _thread()
        if phase == "start":
            rf = None
            if _profiler_enabled():
                rf = torch.profiler.record_function(GC_SPAN)
                rf.__enter__()
            state[2] = (rf, _clock())
            return
        opened = state[2]
        if opened is None:
            return
        state[2] = None
        rf, start = opened
        pause = _clock() - start
        state[1] += pause
        _add(GC_SPAN, pause, pause)
        count(f"{GC_SPAN}.gen{info['generation']}")
        if rf is not None:
            rf.__exit__(None, None, None)
    except Exception:       # noqa: BLE001 - a hook that raises is printed
        pass                # by the interpreter at every collection


gc.callbacks.append(_on_gc)


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


__all__ = ["trace", "annotate", "spans", "reset_spans", "count",
           "counters", "timed"]
