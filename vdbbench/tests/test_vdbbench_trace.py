"""The trace reduction and each reader of the trace, on a small synthetic
profiler timeline (times in ns)."""

import pytest

from vdbbench.drivers.batch import CALL_RANGE
from vdbbench.harness import Record
from vdbbench.manifest import load_module
from vdbbench.trace import OUTSIDE, build

# Two calls of 100 ns each, 10 ns apart. In the first, the index submits
# at 10-20 (launching a kernel, run 20-40, and a copy, run 40-45) and
# collects at 50-70; in the second, the PQ scan launches two kernels
# (110-130, 130-140) and its device re-rank, nested in it, a third
# (140-150).
RANGES = [
    (CALL_RANGE, 0, 100), ("vdb/flat.submit", 10, 20),
    ("vdb/flat.collect", 50, 70),
    (CALL_RANGE, 110, 210), ("vdb/pq.scan", 112, 160),
    ("vdb/pq.rerank_dev", 135, 150),
]
LAUNCHES = {1: 12, 2: 15, 3: 113, 4: 120, 5: 140}
OPS = [("k_coarse", 20, 40, "kernel", 1),
       ("Memcpy DtoH", 40, 45, "gpu_memcpy", 2),
       ("k_decode", 114, 130, "kernel", 3),
       ("k_topk", 130, 140, "kernel", 4),
       ("k_rerank", 140, 150, "kernel", 5)]


@pytest.fixture
def trace():
    return build(RANGES, LAUNCHES, OPS, CALL_RANGE)


def test_window_busy_and_idle(trace):
    assert trace.window == (0, 210)
    assert trace.calls == 2
    assert trace.busy == [(20, 45), (114, 150)]
    assert trace.busy_s == pytest.approx(61e-9)
    assert trace.idle_s == pytest.approx(149e-9)


def test_idle_by_innermost_range(trace):
    got = {k: round(v * 1e9) for k, v in trace.idle_by_range.items()}
    # call 1: idle 0-20 and 45-100; submit covers 10-20, collect 50-70.
    # call 2: idle 110-114 and 150-210; scan covers 112-114 and 150-160
    assert got == {CALL_RANGE: 10 + 35 + 2 + 50, "vdb/flat.submit": 10,
                   "vdb/flat.collect": 20, "vdb/pq.scan": 2 + 10,
                   OUTSIDE: 10}
    assert sum(got.values()) == 149


def test_launch_ranges(trace):
    assert [op.launched_in for op in trace.ops] == [
        "vdb/flat.submit", "vdb/flat.submit", "vdb/pq.scan", "vdb/pq.scan",
        "vdb/pq.rerank_dev"]


def test_ops_outside_the_window_are_dropped():
    ops = OPS + [("late", 300, 310, "kernel", 9)]
    tr = build(RANGES, LAUNCHES, ops, CALL_RANGE)
    assert len(tr.ops) == len(OPS) and tr.unlinked_ops == 0


def test_breakdown_orders_by_time(trace):
    b = trace.breakdown()
    assert b["device_ops"][0][0] == "k_coarse"
    assert b["idle_gaps"][0][0] == CALL_RANGE
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


class _Cell:
    config = {"rows": 1000, "dim": 8}
    traffic = {"queries_per_call": 4}


def _record(trace):
    return Record(_Cell(), None, 0.0, {}, trace)


def test_readers(trace):
    rec = _record(trace)
    read = {name: load_module("metrics", name).read(rec) for name in (
        "store.self_ms", "index.host_ms", "device.idle_share",
        "ivfpq.scan_device_ms")}
    assert read["store.self_ms"] == pytest.approx(97e-9 / 2 * 1e3)
    assert read["index.host_ms"] == pytest.approx(42e-9 / 2 * 1e3)
    assert read["device.idle_share"] == pytest.approx(149 / 210)
    # the scan's two kernels, not the nested re-rank's
    assert read["ivfpq.scan_device_ms"] == pytest.approx(26e-6 / 2)


def test_readers_find_nothing_without_a_trace(trace):
    for name in ("store.self_ms", "index.host_ms", "device.idle_share",
                 "ivfpq.scan_device_ms"):
        assert load_module("metrics", name).read(_record(None)) is None
    # a trace without the scan's range reads nothing either
    flat = build(RANGES[:3], LAUNCHES, OPS[:2], CALL_RANGE)
    assert load_module("metrics", "ivfpq.scan_device_ms").read(
        _record(flat)) is None
