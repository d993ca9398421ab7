"""The readers of the program's spans: ``runtime.gc_ms`` on a synthetic
profiler timeline (times in ns), and the ``program_span`` readers on a
span table set by hand."""

import pytest

from vdbbench.drivers.batch import CALL_RANGE
from vdbbench.harness import Record
from vdbbench.manifest import load_module
from vdbbench.trace import build

from vectordb_tpu_torch.utils import profiling

# One call of 100 ns: the scan (10-90) launches a kernel at 12 that runs
# 20-30; a collection (40-60) interrupts the scan.
SCAN = [(CALL_RANGE, 0, 100), ("vdb/pq.scan", 10, 90)]
GC = [("python/gc", 40, 60)]
LAUNCHES = {1: 12}
OPS = [("k_decode", 20, 30, "kernel", 1)]


def _read(name, trace):
    return load_module("metrics", name).read(Record(None, None, 0.0, {},
                                                    trace))


def test_gc_ms_takes_the_pause_out_of_index_host_ms():
    with_gc = build(SCAN + GC, LAUNCHES, OPS, CALL_RANGE)
    without = build(SCAN, LAUNCHES, OPS, CALL_RANGE)
    # idle 0-20 and 30-100: the scan holds 10-20, 30-40 and 60-90, the
    # collection 40-60
    assert _read("runtime.gc_ms", with_gc) == pytest.approx(20e-9 * 1e3)
    assert _read("index.host_ms", with_gc) == pytest.approx(50e-9 * 1e3)
    assert _read("index.host_ms", without) == pytest.approx(70e-9 * 1e3)
    # the store's own time and the scan's kernels do not move
    for name in ("store.self_ms", "ivfpq.scan_device_ms"):
        assert _read(name, with_gc) == pytest.approx(_read(name, without))


def test_gc_ms_reads_nothing_without_the_span():
    assert _read("runtime.gc_ms", None) is None
    without = build(SCAN, LAUNCHES, OPS, CALL_RANGE)
    assert _read("runtime.gc_ms", without) is None


TABLE = {
    "vdb/ivf.kmeans": 4.0, "vdb/ivf.assign": 2.0, "vdb/ivf.repack": 1.5,
    "vdb/pq.spill_cids": 0.25, "vdb/pq.opq": 3.0, "vdb/pq.codebook": 5.0,
    "vdb/pq.encode": 7.0, "vdb/store.load": 6.0,
    "vdb/kernels.build": 18.0, "vdb/kernels.load": 0.5,
    "vdb/pq.scan": 100.0, "python/gc": 9.0,
}
SUMS = {"index.train_s": 15.75, "index.encode_s": 7.0, "store.load_s": 6.0}


def _table(self_s):
    return {name: {"count": 1, "total_s": s + 1.0, "self_s": s}
            for name, s in self_s.items()}


@pytest.fixture
def card_trace():
    """A traced window that holds a device operation."""
    return build(SCAN, LAUNCHES, OPS, CALL_RANGE)


@pytest.mark.parametrize("metric", sorted(SUMS))
def test_span_readers_sum_self_seconds(monkeypatch, card_trace, metric):
    monkeypatch.setattr(profiling, "spans", lambda: _table(TABLE))
    assert _read(metric, card_trace) == pytest.approx(SUMS[metric])


@pytest.mark.parametrize("metric", sorted(SUMS))
def test_span_readers_read_nothing_from_an_empty_table(monkeypatch,
                                                       card_trace, metric):
    monkeypatch.setattr(profiling, "spans", lambda: {})
    assert _read(metric, card_trace) is None


@pytest.mark.parametrize("metric", sorted(SUMS))
def test_span_readers_read_nothing_without_a_table(monkeypatch, card_trace,
                                                   metric):
    # a program that keeps no span table (one before the table came)
    monkeypatch.delattr(profiling, "spans")
    assert _read(metric, card_trace) is None


@pytest.mark.parametrize("metric", sorted(SUMS))
def test_span_readers_read_nothing_without_a_device_window(monkeypatch,
                                                           metric):
    monkeypatch.setattr(profiling, "spans", lambda: _table(TABLE))
    assert _read(metric, None) is None
    host_only = build(SCAN, {}, [], CALL_RANGE)
    assert _read(metric, host_only) is None
