"""The flat store's certified ladder on the CPU against the benchmark's
plain reference (``vdbbench/references/exact_topk.py``, float64), and the
counters and spans that name each tier's re-runs.

Three ways: as it runs (tier 1, with whatever its certificate leaves to
tier 2); tier 1's accumulation coefficient inflated, so that its
certificate holds for no query and every query re-runs through tier 2
(bf16x3); and both tiers' coefficients inflated, so that every query
reaches tier 3 (the plain tiled f32 scan). Every way returns the exact
top-k. (The collect's mapping of slots to internal ids is held in
``test_torch_hit_columns.py``.)"""

import gc

import numpy as np
import pytest
import torch

from vdbbench.references import exact_topk
from vectordb_tpu_torch import DistanceMetric, Vector, VectorStore
from vectordb_tpu_torch.ops import coarse_kernel as ck
from vectordb_tpu_torch.ops import topk
from vectordb_tpu_torch.store import BatchInsertItem
from vectordb_tpu_torch.utils import profiling

N, D, NQ, K = 4096, 64, 16, 10
FORCED = 1e6        # a coefficient under which no certificate holds
# f32 distances of the named rows against float64: a d=64 dot, a norm
# and a sqrt round at 2^-24 (6e-8) relative each, ~1e-6 at most here;
# 1e-5 leaves ten times that, and TF32 operands (2^-11) would fail it
TOL = 1e-5
METRICS = {DistanceMetric.COSINE: "cosine",
           DistanceMetric.EUCLIDEAN: "euclidean"}


@pytest.fixture(autouse=True)
def _ladder(monkeypatch):
    # tier 1 runs from 2^18 rows; the test's store has 4096
    monkeypatch.setattr(topk, "_EXACT1P_MIN_N", 512)
    profiling.reset_spans()
    yield
    profiling.reset_spans()


def _force(monkeypatch, tiers):
    """Inflate the coefficient of the coarse passes of ``tiers`` (1: the
    1-pass K1 of tier 1; 2: the 3-pass K3 of tier 2)."""
    real = ck._coarse_body

    def body(src, arr, passes, emit_super, lo=None):
        tier = 1 if passes == 1 else 2
        if tier in tiers:
            return f"forced{tier}"
        return real(src, arr, passes, emit_super, lo)

    monkeypatch.setattr(ck, "_coarse_body", body)
    for tier in tiers:
        monkeypatch.setitem(ck._ACCUM_COEFF, f"forced{tier}", FORCED)


def _spy_rejects(monkeypatch):
    """{tier: queries whose certificate failed}, as the tiers run."""
    seen = {1: 0, 2: 0}
    real_1p, real_2 = ck.coarse_search_1p, ck.coarse_search

    def one_pass(*a, **kw):
        out = real_1p(*a, **kw)
        seen[1] += int((~out[2]).sum())
        return out

    def bf16x3(*a, **kw):
        out = real_2(*a, **kw)
        if kw.get("exact", True):
            seen[2] += int((~out[2]).sum())
        return out

    monkeypatch.setattr(ck, "coarse_search_1p", one_pass)
    monkeypatch.setattr(ck, "coarse_search", bf16x3)
    return seen


def _store(metric, device="cpu", seed=0):
    rng = np.random.default_rng(seed)
    rows = rng.standard_normal((N, D), dtype=np.float32)
    queries = rng.standard_normal((NQ, D), dtype=np.float32)
    store = VectorStore.with_flat_index(metric, device=device)
    store.insert_batch([BatchInsertItem(str(i), Vector(rows[i]))
                        for i in range(N)])
    return store, rows, queries


def _check_exact(results, rows, queries, metric):
    q, x = torch.from_numpy(queries), torch.from_numpy(rows)
    ref_d, ref_i = exact_topk.topk(q, x, METRICS[metric], K, "f64")
    ids = np.array([[int(r.id) for r in res] for res in results])
    dists = np.array([[r.distance for r in res] for res in results])
    np.testing.assert_array_equal(ids, ref_i.numpy())
    np.testing.assert_allclose(dists, ref_d.numpy(), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("metric", sorted(METRICS, key=str))
@pytest.mark.parametrize("forced", [(), (1,), (1, 2)],
                         ids=["as_run", "tier2", "tier3"])
def test_ladder_is_exact_and_counts_its_reruns(monkeypatch, metric, forced):
    store, rows, queries = _store(metric)
    _force(monkeypatch, forced)
    seen = _spy_rejects(monkeypatch)
    results = store.search_batch([(Vector(q), K) for q in queries])
    _check_exact(results, rows, queries, metric)

    got = profiling.counters()
    assert got["flat.queries"] == NQ
    assert got.get("flat.tier2_queries", 0) == seen[1]
    assert got.get("flat.tier3_queries", 0) == seen[2]
    if 1 in forced:
        assert seen[1] == NQ
    if 2 in forced:
        assert seen[2] == NQ
    spans = profiling.spans()
    for tier, rerun in (("tier2", seen[1]), ("tier3", seen[2])):
        assert (f"vdb/flat.{tier}" in spans) == (rerun > 0), tier
    if 1 in forced:
        # tier 3's re-runs nest inside tier 2's
        assert spans["vdb/flat.tier2"]["count"] == 1


def test_reset_spans_clears_the_counters():
    # no automatic collection: it would add its ``python/gc.gen*`` counter
    gc.disable()
    try:
        profiling.reset_spans()
        profiling.count("flat.queries", 3)
        profiling.count("flat.queries")
        assert profiling.counters() == {"flat.queries": 4}
        got = profiling.counters()
        got["flat.queries"] = 0
        assert profiling.counters() == {"flat.queries": 4}     # a copy
        profiling.reset_spans()
        assert profiling.counters() == {}
    finally:
        gc.enable()
