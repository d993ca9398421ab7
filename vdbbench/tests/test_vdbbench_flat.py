"""The exact flat cell (``cohere768-1m-flat.q64-k100``) on the CPU: tiny
runs through the harness come out correct with tier 1 running and with
every query forced to tier 2, and not correct with the timed path broken
or the TF32 control in the program's place; the readers of the ladder's
spans and counters on synthetic timelines; the roofline's bound at the
cell's shapes."""

import time

import pytest

from vdbbench import control, harness
from vdbbench.drivers.batch import CALL_RANGE
from vdbbench.harness import Record
from vdbbench.manifest import Cell, load_manifest, load_module
from vdbbench.trace import build
from vectordb_tpu_torch.ops import coarse_kernel as ck
from vectordb_tpu_torch.ops import topk
from vectordb_tpu_torch.store import VectorStore
from vectordb_tpu_torch.utils import profiling

CONFIG, TRAFFIC = "cohere768-1m-flat", "q64-k100"
WORKLOAD = f"{CONFIG}.{TRAFFIC}"
METRICS = ("flat.scan_device_ms", "flat.fallback_device_ms",
           "flat.uncertified_share", "kernels.flat_roofline")


@pytest.fixture(autouse=True)
def _tier1(monkeypatch):
    # tier 1 runs from 2^18 rows; the tiny cell's store has 4096
    monkeypatch.setattr(topk, "_EXACT1P_MIN_N", 512)
    profiling.reset_spans()
    yield
    profiling.reset_spans()


def _run(cell, trace=False, seconds=2.0, seed=2 ** 31 + 11):
    return harness.run(cell, seed, seconds, trace, "cpu",
                       time.perf_counter())


def test_sound_run_is_correct(tiny):
    cell = tiny(CONFIG, TRAFFIC)
    out = _run(cell)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0
    assert set(out["metrics"]) == {"qps", "setup_s"}
    got = profiling.counters()
    assert got["flat.queries"] >= 16 * cell.traffic["kept_calls"]


def test_every_query_through_tier2_is_correct(tiny, monkeypatch):
    # tier 1's certificate holds for no query: all re-run through tier 2
    monkeypatch.setattr(ck, "_coarse_body",
                        lambda src, arr, passes, *a: "forced"
                        if passes == 1 else "plain")
    monkeypatch.setitem(ck._ACCUM_COEFF, "forced", 1e6)
    out = _run(tiny(CONFIG, TRAFFIC))
    assert out["correct"], out["checks"]
    got = profiling.counters()
    assert got["flat.tier2_queries"] == got["flat.queries"] > 0


def test_traced_run_reads_no_device_metric_on_the_cpu(tiny):
    out = _run(tiny(CONFIG, TRAFFIC), trace=True)
    assert out["correct"]
    assert out["metrics"] == {}          # no device operation to read
    gaps = dict(out["breakdown"]["idle_gaps"])
    assert "vdb/flat.submit" in gaps and "vdb/flat.collect" in gaps


def _broken(monkeypatch, alter):
    real = VectorStore.search_batch
    state = {}

    def search_batch(self, queries, **kw):
        state["rows"] = len(self)
        return alter(real(self, queries, **kw), state)

    monkeypatch.setattr(VectorStore, "search_batch", search_batch)


@pytest.mark.parametrize("fault", sorted(control.FAULTS))
def test_broken_path_is_not_correct(tiny, monkeypatch, fault):
    _broken(monkeypatch, control.FAULTS[fault])
    out = _run(tiny(CONFIG, TRAFFIC))
    assert not out["correct"], out["checks"]


def test_tf32_control_is_not_correct(tiny):
    # at a size a test holds, but at the cell's own width and k
    cell = tiny(CONFIG, TRAFFIC, rows=8192, dim=768)
    for seed in (1, 2, 3):
        nums = control.readings(cell, seed, "cpu", program=False)["control"]
        correct, checks = harness.compare.judge(nums, cell.limits)
        assert not correct, checks


def test_the_cell_reports_its_metrics():
    cell = Cell(WORKLOAD, load_manifest())
    assert {m["name"] for m in cell.metrics("end_to_end")} == {"qps",
                                                               "setup_s"}
    assert set(METRICS) <= {m["name"] for m in cell.metrics("per_layer")}
    assert cell.config["store"] == {"kind": "flat", "params": {}}


# -- the readers, on a synthetic timeline (ns) ------------------------------
# One call of 100 ns: the submit (5-30) launches K1 at 6 (runs 10-20) and
# K2 at 8 (runs 20-24); the collect (30-95) holds a tier-2 re-run (40-80)
# that launches K3 at 45 (runs 50-60), inside which a tier-3 re-run
# (65-75) launches its scan at 66 (runs 70-72).
TIMELINE = [(CALL_RANGE, 0, 100), ("vdb/flat.submit", 5, 30),
            ("vdb/flat.collect", 30, 95), ("vdb/flat.tier2", 40, 80),
            ("vdb/flat.tier3", 65, 75)]
LAUNCHES = {1: 6, 2: 8, 3: 45, 4: 66, 5: 9}
OPS = [("k1", 10, 20, "kernel", 1), ("k2", 20, 24, "kernel", 2),
       ("k3", 50, 60, "kernel", 3), ("scan", 70, 72, "kernel", 4),
       ("Memcpy HtoD", 24, 26, "gpu_memcpy", 5)]
CELL = Cell(WORKLOAD, load_manifest())


def _read(name, trace, cell=CELL):
    return load_module("metrics", name).read(Record(cell, None, 0.0, {},
                                                    trace))


def test_device_readers_split_the_ladder_by_span():
    tr = build(TIMELINE, LAUNCHES, OPS, CALL_RANGE)
    # kernels only: the query copy is no kernel
    assert _read("flat.scan_device_ms", tr) == pytest.approx(14e-6)
    assert _read("flat.fallback_device_ms", tr) == pytest.approx(12e-6)
    bound = load_module("metrics", "kernels.flat_roofline").bound(
        1_000_000, 768, 64, 100)["ms"]
    assert _read("kernels.flat_roofline", tr) == pytest.approx(
        100.0 * bound / 14e-6)


def test_fallback_reads_zero_without_a_rerun_and_none_without_a_trace():
    no_rerun = build(TIMELINE[:3], LAUNCHES, OPS[:2], CALL_RANGE)
    assert _read("flat.fallback_device_ms", no_rerun) == 0.0
    for name in METRICS:
        assert _read(name, None) is None
    host_only = build(TIMELINE, {}, [], CALL_RANGE)
    for name in METRICS:
        assert _read(name, host_only) is None, name


def test_uncertified_share_reads_the_counters(monkeypatch):
    tr = build(TIMELINE, LAUNCHES, OPS, CALL_RANGE)
    monkeypatch.setattr(profiling, "counters",
                        lambda: {"flat.queries": 640,
                                 "flat.tier2_queries": 8,
                                 "flat.tier3_queries": 1})
    assert _read("flat.uncertified_share", tr) == pytest.approx(8 / 640)
    monkeypatch.setattr(profiling, "counters",
                        lambda: {"flat.queries": 640})
    assert _read("flat.uncertified_share", tr) == 0.0
    monkeypatch.setattr(profiling, "counters", lambda: {})
    assert _read("flat.uncertified_share", tr) is None


def test_uncertified_share_reads_nothing_without_counters(monkeypatch):
    # a program that keeps no counters (one before they came)
    tr = build(TIMELINE, LAUNCHES, OPS, CALL_RANGE)
    monkeypatch.delattr(profiling, "counters")
    assert _read("flat.uncertified_share", tr) is None


def test_roofline_bound_at_the_cells_shapes():
    roof = load_module("metrics", "kernels.flat_roofline")
    got = roof.bound(1_000_000, 768, 64, 100)
    assert got["m"] == 201
    # K1: 1.536 GB of bf16 rows at 3.35 TB/s against 98.3 GFLOP at 989
    assert got["K1"]["by"] == "bytes"
    assert got["K1"]["ms"] == pytest.approx(0.4585, abs=5e-5)
    assert got["K1"]["ops"] / roof.PEAK_BF16 * 1e3 == pytest.approx(
        0.0994, abs=5e-5)
    assert got["K2"]["by"] == "ops"
    assert got["ms"] == pytest.approx(got["K1"]["ms"] + got["K2"]["ms"])
    # the pool is the program's at the cell's shape (capacity 2^20)
    assert ck._exact1p_pool(100, (1 << 20) // ck.SUB)[1] == got["m"]
