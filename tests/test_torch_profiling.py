"""The port's spans (``utils/profiling``) on the CPU: the table's total and
self seconds, the collector's span, the profiler ranges they leave, no
profiler call outside a profiler, threads, and the set-up stages of a
small IVF-PQ store."""

import gc
import sys
import threading
import time

import numpy as np
import pytest
import torch

from vectordb_tpu_torch import DistanceMetric, Vector, VectorStore
from vectordb_tpu_torch.index.ivfpq import IvfPqIndex
from vectordb_tpu_torch.utils import profiling
from vectordb_tpu_torch.utils.profiling import annotate


@pytest.fixture(autouse=True)
def _fresh_table():
    profiling.reset_spans()
    yield
    profiling.reset_spans()


@pytest.fixture
def no_automatic_gc():
    """Only the test's own collections (gc.collect runs all the same)."""
    gc.disable()
    try:
        yield
    finally:
        gc.enable()


def _busy(seconds: float) -> None:
    end = time.perf_counter() + seconds
    while time.perf_counter() < end:
        pass


def test_nested_spans_total_and_self(no_automatic_gc):
    with annotate("t/outer"):
        _busy(0.01)
        with annotate("t/inner"):
            _busy(0.02)
        with annotate("t/inner"):
            _busy(0.01)
    got = profiling.spans()
    outer, inner = got["t/outer"], got["t/inner"]
    assert outer["count"] == 1 and inner["count"] == 2
    assert inner["total_s"] == pytest.approx(inner["self_s"])
    assert inner["total_s"] >= 0.03
    assert outer["total_s"] >= inner["total_s"] + 0.01
    assert "python/gc" not in got
    # self: the total less what the children took
    assert outer["self_s"] == pytest.approx(
        outer["total_s"] - inner["total_s"], abs=1e-6)


def test_spans_is_a_copy_and_reset_clears():
    with annotate("t/a"):
        pass
    got = profiling.spans()
    got["t/a"]["count"] = 99
    assert profiling.spans()["t/a"]["count"] == 1
    profiling.reset_spans()
    assert "t/a" not in profiling.spans()


def test_a_collection_is_a_span_out_of_its_parents_self_time(
        no_automatic_gc):
    junk = [[i] for i in range(200_000)]    # something to traverse
    profiling.reset_spans()
    with annotate("t/outer"):
        gc.collect()
        gc.collect(0)
    got = profiling.spans()
    del junk
    pause = got["python/gc"]
    assert pause["count"] == 2 and pause["total_s"] > 0
    assert pause["self_s"] == pytest.approx(pause["total_s"])
    outer = got["t/outer"]
    assert outer["self_s"] == pytest.approx(
        outer["total_s"] - pause["total_s"], abs=1e-6)
    assert outer["self_s"] < outer["total_s"]


@pytest.mark.parametrize("generation", [0, 1, 2])
def test_a_collection_counts_one_of_its_generation(no_automatic_gc,
                                                    generation):
    # gc.collect() is a full pass: one more python/gc.gen2
    before = profiling.counters()
    if generation == 2:
        gc.collect()
    else:
        gc.collect(generation)
    got = profiling.counters()
    for g in range(3):
        name = f"python/gc.gen{g}"
        assert got.get(name, 0) - before.get(name, 0) == (g == generation)


@pytest.mark.parametrize("span_end", ["open", "close"])
@pytest.mark.parametrize("collect_at", ["before", "after"])
def test_a_collection_at_a_spans_clock_reading_is_charged_once(
        monkeypatch, no_automatic_gc, span_end, collect_at):
    """A collection that runs while a span opens or closes, just before or
    just after its clock is read, lies either inside the span's interval
    or outside it: the spans' self seconds and the collections' seconds
    still partition the outer span's interval."""
    real = profiling._clock
    armed = []

    def clock():
        fire = armed and armed.pop()
        if fire and collect_at == "before":
            gc.collect()
        now = real()
        if fire and collect_at == "after":
            gc.collect()
        return now
    monkeypatch.setattr(profiling, "_clock", clock)
    junk = [[i] for i in range(100_000)]     # something to traverse
    with annotate("t/outer"):
        _busy(0.002)
        if span_end == "open":
            armed.append(True)
        with annotate("t/inner"):
            _busy(0.002)
            if span_end == "close":
                armed.append(True)
        _busy(0.002)
    del junk
    got = profiling.spans()
    outer, inner, pause = got["t/outer"], got["t/inner"], got["python/gc"]
    assert pause["count"] == 1 and not armed
    assert inner["self_s"] >= 0.002 and outer["self_s"] >= 0.004
    assert outer["self_s"] + inner["self_s"] + pause["total_s"] == \
        pytest.approx(outer["total_s"], abs=1e-6)


def test_the_collector_hook_is_registered_once():
    hooks = [cb for cb in gc.callbacks
             if getattr(cb, "__qualname__", None) == "_on_gc"
             and cb.__module__ == profiling.__name__]
    assert hooks == [profiling._on_gc]


def _annotations(prof):
    return [(ev.name(), ev.start_ns(), ev.end_ns())
            for ev in prof.profiler.kineto_results.events()
            if ev.device_type() == torch.autograd.DeviceType.CPU
            and "user_annotation" in str(ev.activity_type())]


def test_profiler_ranges_nest_as_the_spans_do():
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with annotate("t/outer"):
            torch.ones(8).sum()
            with annotate("t/inner"):
                torch.ones(8).sum()
                gc.collect()
    ranges = {}
    for name, s, e in _annotations(prof):
        ranges.setdefault(name, []).append((s, e))
    (o0, o1), = ranges["t/outer"]
    (i0, i1), = ranges["t/inner"]
    assert o0 <= i0 <= i1 <= o1
    # the collection that gc.collect() ran, inside the inner span
    assert any(i0 <= s <= e <= i1 for s, e in ranges["python/gc"])
    assert profiling.spans()["t/outer"]["count"] == 1


def test_no_profiler_call_outside_a_profiler(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function outside a profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with annotate("t/quiet"):
        gc.collect()
    got = profiling.spans()
    assert got["t/quiet"]["count"] == 1 and got["python/gc"]["count"] >= 1


def test_spans_from_threads_add_up():
    per_thread, n_threads = 2000, 4
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(per_thread):
                with annotate("t/thread"):
                    with annotate("t/child"):
                        pass
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    got = profiling.spans()
    assert got["t/thread"]["count"] == per_thread * n_threads
    assert got["t/child"]["count"] == per_thread * n_threads
    # each thread's own stack: a child's time leaves only its own parent
    assert got["t/thread"]["self_s"] >= 0


SETUP_SPANS = ("vdb/store.load", "vdb/ivf.kmeans", "vdb/ivf.assign",
               "vdb/ivf.repack", "vdb/pq.spill_cids", "vdb/pq.opq",
               "vdb/pq.codebook", "vdb/pq.encode")


def test_ivfpq_setup_leaves_its_spans():
    rng = np.random.default_rng(3)
    n, d = 2048, 16
    rows = rng.standard_normal((n, d)).astype(np.float32)
    store = VectorStore.with_index(IvfPqIndex(
        DistanceMetric.EUCLIDEAN, nlist=16, m=4, ksub=16, refine=32,
        device="cpu"))
    store.reserve(n, d)
    for lo in range(0, n, 1024):
        store.restore_snapshot_chunk(
            np.arange(lo, lo + 1024, dtype=np.int64),
            [str(i) for i in range(lo, lo + 1024)], rows[lo:lo + 1024], {})
    store.index.train()
    first = store.search_batch([(Vector(rows[0]), 5)])    # the full encode
    assert first[0][0].id == "0"
    store.insert("new", Vector(rows[1] + 0.5))            # a dirty slot
    store.search_batch([(Vector(rows[1]), 5)])
    got = profiling.spans()
    missing = [name for name in SETUP_SPANS if name not in got]
    assert not missing
    assert got["vdb/store.load"]["count"] == 3            # reserve + 2
    assert got["vdb/pq.encode"]["count"] == 2             # all, then 1
    for name in SETUP_SPANS:
        assert 0 <= got[name]["self_s"] <= got[name]["total_s"] + 1e-6
    # the kernels' build and load run only where there is a card
    assert "vdb/kernels.build" not in got and "vdb/kernels.load" not in got
