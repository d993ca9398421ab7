"""Tiny end-to-end runs of the harness on the CPU, through its functions
(the look for a card is ``__main__``'s, and is skipped here): sound runs
come out correct, and runs with the timed path broken underneath, or the
TF32 control in the program's place, come out not correct."""

import time

import pytest
import torch

from vdbbench import control, harness
from vdbbench.data import inputs
from vectordb_tpu_torch.store import VectorStore

# (config, traffic, rows, k). IVF-PQ runs at k=10 here: at a size a
# test holds, 8 rows a cluster at 64 wide, its recall at the cell's
# k=100 is low by the data (0.59), not by a fault.
CELLS = [("cohere768-1m-ivfpq", "q64-k100", 16384, 10)]


def _run(cell, trace=False, seconds=2.0, seed=2 ** 31 + 11):
    # a window long enough for the kept calls on a loaded machine: calls
    # the window never made leave their kept answers empty (not correct)
    return harness.run(cell, seed, seconds, trace, "cpu",
                       time.perf_counter())


@pytest.mark.parametrize("config,traffic,rows,k", CELLS)
def test_sound_run_is_correct(tiny, config, traffic, rows, k):
    cell = tiny(config, traffic, rows=rows, k=k)
    out = _run(cell)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= cell.traffic[
        "kept_calls"]
    assert list(out)[-1] == "checks"
    names = {m["name"] for m in cell.metrics("end_to_end")}
    # a CPU run reports the host-clock metrics; none is a device's
    assert set(out["metrics"]) == names
    assert out["device"]["platform"] == "cpu"


def test_traced_run_reads_no_device_metric_on_the_cpu(tiny):
    out = _run(tiny(*CELLS[0][:2], rows=CELLS[0][2], k=CELLS[0][3]),
               trace=True)
    assert out["correct"]
    assert out["metrics"] == {}          # no device operation to read
    gaps = dict(out["breakdown"]["idle_gaps"])
    assert "vdbbench/search_batch" in gaps
    # the harness opens no range of its own but the one around each call
    assert not [g for g in gaps if g.startswith("vdbbench/")
                and g != "vdbbench/search_batch"]


def test_same_seed_same_inputs(tiny):
    cell = tiny(*CELLS[0][:2])
    gen = harness.load_module("data", "clustered_intrinsic")
    a = gen.make(5, 100, 16, 8, cell.config["data"], torch.device("cpu"))
    b = gen.make(5, 100, 16, 8, cell.config["data"], torch.device("cpu"))
    c = gen.make(6, 100, 16, 8, cell.config["data"], torch.device("cpu"))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])


def test_every_seed_sends_the_same_queries_in_another_order(tiny):
    conf = tiny(*CELLS[0][:2], rows=100, dim=16).config
    cpu = torch.device("cpu")
    rows_a, q_a = inputs(conf, 32, 5, cpu)
    rows_b, q_b = inputs(conf, 32, 5, cpu)
    rows_c, q_c = inputs(conf, 32, 6, cpu)
    assert torch.equal(rows_a, rows_b) and torch.equal(q_a, q_b)
    assert torch.equal(rows_a, rows_c) and not torch.equal(q_a, q_c)
    key = lambda q: sorted(map(tuple, q.tolist()))  # noqa: E731
    assert key(q_a) == key(q_c)


def _broken(monkeypatch, alter):
    real = VectorStore.search_batch
    state = {}

    def search_batch(self, queries, **kw):
        state["rows"] = len(self)
        return alter(real(self, queries, **kw), state)

    monkeypatch.setattr(VectorStore, "search_batch", search_batch)


@pytest.mark.parametrize("config,traffic,rows,k", CELLS)
@pytest.mark.parametrize("fault", sorted(control.FAULTS))
def test_broken_path_is_not_correct(tiny, monkeypatch, config, traffic,
                                    rows, k, fault):
    # the timed path broken underneath: the store's own entry
    _broken(monkeypatch, control.FAULTS[fault])
    out = _run(tiny(config, traffic, rows=rows, k=k))
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("config,traffic,rows,k", CELLS)
def test_tf32_control_is_not_correct(tiny, config, traffic, rows, k):
    # the control at a size a test holds, but at the cell's own width
    # and k
    cell = tiny(config, traffic, rows=8192, dim=768)
    for seed in (1, 2, 3):
        nums = control.readings(cell, seed, "cpu", program=False)["control"]
        correct, checks = harness.compare.judge(nums, cell.limits)
        assert not correct, checks
