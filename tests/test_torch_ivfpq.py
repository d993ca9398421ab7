"""IVF-PQ in the port, on the CPU, against the JAX package.

The same seeded numpy inputs go through ``vectordb_tpu`` (its XLA decode,
``pallas_decode=False``, which equals kernel K8 bit for bit:
tests/test_pq_ops.py; its exact fallback's kernels in Pallas interpret
mode) and through ``vectordb_tpu_torch`` on ``device="cpu"`` (K8's plain
version):

  * ``ivfpq_scan_topr``: the same slots on tie-free data, scores within
    ``SCAN_RTOL`` of ``max|score|`` (the port widens bf16 operands to f32
    on the CPU, XLA sums bf16 products in its own order), for all three
    metrics, with and without OPQ, with a padded tail chunk, a spill
    region holding dead slots, and ``r`` past a tail's rows;
  * whole indexes on the JAX package's trained layout, codebook, spill
    ids and rotation (``ivfpq_store_from_reference`` /
    ``import_trained_state``: torch's generator cannot give
    ``jax.random``'s centroids or codewords): the same residual codes,
    ids and distances (rtol 2e-5);
  * every test of tests/test_ivfpq.py and
    ``test_pq_index::test_ivfpq_device_rerank_matches_host`` on the
    port's own training, but for the residual-vs-raw recall gate, which
    runs on the JAX package's trained states (each package's own
    training lands on either side of that gate from seed to seed);
  * ``ivfpq_state.npz``: the JAX package's bytes; each package reopens
    the other's directory without retraining;
  * the bf16 rounding through torch's cast, bit for bit ml_dtypes';
  * the engine, the CLI, the routes and the native front end.
"""

import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import vectordb_tpu as J
from vectordb_tpu.index.ivfpq import IvfPqIndex as JIvfPq
from vectordb_tpu.ops import pq as jpq
from vectordb_tpu.ops import topk as jtopk

from vectordb_tpu_torch import (BatchInsertItem, DistanceMetric, Metadata,
                                MetadataFilter, PqFlatIndex, Vector,
                                VectorStore)
from vectordb_tpu_torch import cli
from vectordb_tpu_torch.convert import ivfpq_store_from_reference
from vectordb_tpu_torch.errors import IndexOpError
from vectordb_tpu_torch.index import ivfpq as ivfpq_mod
from vectordb_tpu_torch.index.ivfpq import IvfPqIndex
from vectordb_tpu_torch.ops import pq as tpq
from vectordb_tpu_torch.ops import topk as ttopk
from vectordb_tpu_torch.persistence import EngineConfig, StorageEngine

torch.set_num_threads(1)
EUC = DistanceMetric.EUCLIDEAN
METRICS = list(DistanceMetric)
# |port score - JAX score| <= SCAN_RTOL * max|score| (+ SCAN_RTOL * |score|)
SCAN_RTOL = 2e-6


@pytest.fixture(autouse=True)
def _tiers(monkeypatch):
    monkeypatch.setenv("VDB_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setattr(jtopk, "_EXACT1P_MIN_N", 512)
    monkeypatch.setattr(ttopk, "_EXACT1P_MIN_N", 512)


def IvfPq(metric=EUC, **kw):
    return IvfPqIndex(metric, device="cpu", **kw)


def _jm(metric):
    return J.DistanceMetric(metric.value)


def _clustered(rng, n, d, n_centers=64, scale=0.15):
    centers = rng.standard_normal((n_centers, d)).astype(np.float32)
    which = rng.integers(0, n_centers, n)
    return (centers[which]
            + scale * rng.standard_normal((n, d)).astype(np.float32))


def _np_dists(queries, db, metric):
    q, x = queries.astype(np.float64), db.astype(np.float64)
    dots = q @ x.T
    if metric is DistanceMetric.DOT_PRODUCT:
        return -dots
    if metric is DistanceMetric.EUCLIDEAN:
        sq = (q * q).sum(1)[:, None] + (x * x).sum(1)[None, :] - 2 * dots
        return np.sqrt(np.maximum(sq, 0.0))
    den = np.linalg.norm(q, axis=1)[:, None] * np.linalg.norm(x, axis=1)
    return 1.0 - np.clip(dots / den, -1.0, 1.0)


def _flat_topk(queries, db, metric, k):
    return np.argsort(_np_dists(queries, db, metric), axis=1,
                      kind="stable")[:, :k]


def _recall(results, want, k):
    return float(np.mean([len({i for i, _ in got} & set(w.tolist())) / k
                          for got, w in zip(results, want)]))


def _assert_same(got, want, rtol=2e-5):
    """Same ids, distances at rtol / atol 2e-5."""
    assert [[i for i, _ in r] for r in got] == \
        [[i for i, _ in r] for r in want]
    np.testing.assert_allclose([d for r in got for _, d in r],
                               [d for r in want for _, d in r], rtol=rtol,
                               atol=2e-5)


def _bf16(x):
    import ml_dtypes
    return np.asarray(x, np.float32).astype(ml_dtypes.bfloat16).astype(
        np.float32)


# -- the scan -----------------------------------------------------------------

def _scan_case(seed, nlist, cpc, span, s_rows, m=8, dsub=4, ksub=32, q=12,
               dead=0.1):
    rng = np.random.default_rng(seed)
    d = m * dsub
    cb = _bf16(rng.standard_normal((m, ksub, dsub)) * 0.3)
    n = nlist * span + s_rows
    codes = rng.integers(0, ksub, (n, m), dtype=np.uint8)
    valid = rng.random(n) >= dead
    cents = _bf16(rng.standard_normal((nlist, d)))
    csq = np.sum(cents * cents, axis=1, dtype=np.float32)
    cid_sp = rng.integers(0, nlist, s_rows).astype(np.int32)
    cid_sp[~valid[nlist * span:]] = -1            # dead spill: unresolved
    queries = rng.standard_normal((q, d)).astype(np.float32)
    cnorm = np.sum(cb * cb, axis=-1).astype(np.float32)
    return cb, codes, valid, cents, csq, cid_sp, queries, cnorm


# (nlist, cpc, span, spill rows, r): full chunks only; a tail of one
# cluster (nlist % cpc) with a spill; a tail shorter than r; spill rows
# fewer than r
SCAN_LAYOUTS = [(8, 4, 32, 0, 16), (10, 3, 32, 48, 16), (7, 3, 16, 64, 32),
                (5, 2, 32, 8, 16)]


@pytest.mark.parametrize("layout", SCAN_LAYOUTS)
@pytest.mark.parametrize("rotate", [False, True])
@pytest.mark.parametrize("metric", METRICS)
def test_scan_matches_jax(metric, rotate, layout):
    nlist, cpc, span, s_rows, r = layout
    cb, codes, valid, cents, csq, cid_sp, queries, cnorm = _scan_case(
        nlist * 100 + span + s_rows, nlist, cpc, span, s_rows)
    d = cents.shape[1]
    rot = None
    if rotate:
        rot = np.linalg.qr(np.random.default_rng(5).standard_normal(
            (d, d)))[0].astype(np.float32)
    bd, _ = jpq.pack_codebook(cb)
    js, jl = jpq.ivfpq_scan_topr(
        jnp.asarray(queries), jnp.asarray(codes), jnp.asarray(bd),
        jnp.asarray(cnorm), jnp.asarray(valid), jnp.asarray(cents),
        jnp.asarray(csq), jnp.asarray(cid_sp), _jm(metric), r=r, cpc=cpc,
        span=span, nlist=nlist, recall_target=0.95,
        rot=None if rot is None else jnp.asarray(rot), pallas_decode=False)
    ts, tl = tpq.ivfpq_scan_topr(
        torch.from_numpy(queries), torch.from_numpy(codes),
        torch.from_numpy(cb).to(torch.bfloat16), torch.from_numpy(cnorm),
        torch.from_numpy(valid), torch.from_numpy(cents),
        torch.from_numpy(csq), torch.from_numpy(cid_sp), metric, r=r,
        cpc=cpc, span=span, nlist=nlist,
        rot=None if rot is None else torch.from_numpy(rot))
    js, jl = np.asarray(js), np.asarray(jl)
    assert tl.dtype == torch.int64 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tl.numpy(), jl)
    finite = np.isfinite(js)
    np.testing.assert_array_equal(np.isfinite(ts.numpy()), finite)
    scale = float(np.abs(js[finite]).max())
    np.testing.assert_allclose(ts.numpy()[finite], js[finite],
                               rtol=SCAN_RTOL, atol=SCAN_RTOL * scale)
    assert np.all(np.diff(ts.numpy(), axis=1) >= 0)
    assert not valid[tl.numpy()[np.isfinite(ts.numpy())]].__contains__(
        False)


def test_scan_scores_are_the_residual_reconstruction():
    """Euclidean scores are |c + r_hat|^2 - 2 q.(c + r_hat) of the decoded
    rows, the spill rows against their own centroid, to f32 rounding."""
    nlist, cpc, span, s_rows = 6, 4, 16, 32
    cb, codes, valid, cents, csq, cid_sp, queries, cnorm = _scan_case(
        3, nlist, cpc, span, s_rows, dead=0.0)
    n = len(codes)
    ts, tl = tpq.ivfpq_scan_topr(
        torch.from_numpy(queries), torch.from_numpy(codes),
        torch.from_numpy(cb).to(torch.bfloat16), torch.from_numpy(cnorm),
        torch.from_numpy(valid), torch.from_numpy(cents),
        torch.from_numpy(csq), torch.from_numpy(cid_sp), EUC, r=n // 4,
        cpc=cpc, span=span, nlist=nlist)
    m = cb.shape[0]
    dec = np.concatenate([cb[j, codes[:, j]] for j in range(m)], axis=1)
    cid = np.concatenate([np.arange(nlist * span) // span, cid_sp])
    x = (dec + cents[cid]).astype(np.float64)
    want = (x * x).sum(1)[None, :] - 2 * queries.astype(np.float64) @ x.T
    got_w = np.take_along_axis(want, tl.numpy(), axis=1)
    np.testing.assert_allclose(ts.numpy(), got_w, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    # and they are the exact top of those reconstruction scores
    np.testing.assert_array_equal(
        np.sort(tl.numpy(), axis=1),
        np.sort(np.argsort(want, axis=1)[:, :n // 4], axis=1))


def test_scan_rejects_r_past_a_chunk():
    cb, codes, valid, cents, csq, cid_sp, queries, cnorm = _scan_case(
        1, 4, 2, 16, 0)
    with pytest.raises(ValueError, match="exceeds chunk"):
        tpq.ivfpq_scan_topr(
            torch.from_numpy(queries), torch.from_numpy(codes),
            torch.from_numpy(cb).to(torch.bfloat16),
            torch.from_numpy(cnorm), torch.from_numpy(valid),
            torch.from_numpy(cents), torch.from_numpy(csq),
            torch.from_numpy(cid_sp), EUC, r=64, cpc=2, span=16, nlist=4)


# -- the rounding -------------------------------------------------------------

def test_bf16_rounding_is_ml_dtypes_bit_for_bit():
    """torch's cast rounds to nearest even as ml_dtypes does: random
    values of every scale, exact halfway cases both ways, the largest
    finite values, subnormals, zeros and infinities."""
    rng = np.random.default_rng(0)
    vals = [rng.standard_normal(4096) * 10.0 ** rng.integers(-30, 30, 4096)]
    base = rng.integers(0, 1 << 16, 2048).astype(np.uint32) << 16
    for low in (0x8000, 0x7FFF, 0x8001, 0x0001, 0xFFFF):   # ties and near
        vals.append((base | low).view(np.float32))
    vals.append(np.array([0.0, -0.0, np.inf, -np.inf, 3.3895e38, -3.3895e38,
                          1e-40, -1e-45, np.finfo(np.float32).max],
                         np.float32))
    x = np.concatenate([np.asarray(v, np.float32) for v in vals])
    x = x[~np.isnan(x)]
    from vectordb_tpu_torch.index.flat import _quantize_bf16
    np.testing.assert_array_equal(_quantize_bf16(x).view(np.uint32),
                                  _bf16(x).view(np.uint32))


# -- whole indexes on the JAX package's trained state -------------------------

def _jax_trained(metric, n=3000, d=32, nlist=16, m=8, ksub=32, refine=32,
                 seed=1, rotate=True, rng_seed=10, deletes=0, **kw):
    rng = np.random.default_rng(rng_seed)
    db = _clustered(rng, n, d, n_centers=nlist, scale=0.3)
    if metric is DistanceMetric.COSINE:
        db = db + 2.0
    j = JIvfPq(_jm(metric), nlist=nlist, m=m, ksub=ksub, refine=refine,
               seed=seed, rotate=rotate, **kw)
    j.add_batch([(i, db[i]) for i in range(n)])
    j.train()
    for i in range(0, n, max(1, n // deletes) if deletes else n + 1):
        j.remove(i)
    j.search_batch(db[1:2], 1)                   # sync: the JAX codes
    return db, j


def _port_of(j, metric, **kw):
    state = j.export_trained_state()
    ids = state["id_of_slot"][state["id_of_slot"] >= 0]
    rows = {int(i): np.asarray(j.get_vector(int(i)).as_array(), np.float32)
            for i in ids}
    t = IvfPq(metric, refine=j.refine, m=j._m, ksub=j.ksub, **kw)
    t.import_trained_state(state, rows, len(next(iter(rows.values()))))
    return t


@pytest.fixture(scope="module", params=METRICS, ids=lambda m: m.value)
def jax_pair(request):
    metric = request.param
    db, j = _jax_trained(metric, deletes=97)
    return metric, db, j, _port_of(j, metric)


def test_index_matches_jax_on_its_state(jax_pair):
    metric, db, j, t = jax_pair
    rng = np.random.default_rng(11)
    queries = np.concatenate([db[:16] + 0.01,
                              _clustered(rng, 16, 32, n_centers=4)])
    if metric is DistanceMetric.COSINE:
        queries[16:] += 2.0
    for refine in (None, 8, 128):
        kw = {} if refine is None else {"refine": refine}
        _assert_same(t.search_batch(queries, 10, **kw),
                     j.search_batch(queries, 10, **kw))
    # the residual codes are the JAX package's, slot for slot
    np.testing.assert_array_equal(t._codes[t._valid],
                                  np.asarray(j._codes)[j._valid])
    np.testing.assert_array_equal(t._scan_cents().view(np.uint32),
                                  j._scan_cents().view(np.uint32))
    # a filter (the masked scan) and the device venue over the same pool
    mask = np.random.default_rng(3).random(t.capacity) < 0.6
    _assert_same(t.search_batch(queries, 7, slot_mask=mask),
                 j.search_batch(queries, 7, slot_mask=mask))
    t.rerank_mode = "device"
    try:
        assert t._rerank_venue() == "mirror"
        _assert_same(t.search_batch(queries, 10),
                     j.search_batch(queries, 10))
    finally:
        t.rerank_mode = "auto"


def test_scan_geometry_is_the_jax_packages(jax_pair):
    _, _, j, t = jax_pair
    assert t._span == j._span and t._spill_base == j._spill_base
    assert t._scan_cpc() == j._scan_cpc()
    assert t._scan_r_max() == j._scan_r_max()
    for r in (8, 64):
        assert t._scan_pool_cols(r) == j._scan_pool_cols(r)
        assert t._scan_bytes_per_query(r) == j._scan_bytes_per_query(r)
    np.testing.assert_array_equal(t._spill_cid, np.asarray(j._spill_cid))


def test_constants_are_the_jax_packages():
    import vectordb_tpu.index.ivfpq as jmod
    assert ivfpq_mod._NEAREST_HOST_MAX == jmod._NEAREST_HOST_MAX
    jdef = JIvfPq(J.DistanceMetric.EUCLIDEAN)
    tdef = IvfPq()
    for name in ("refine", "train_iters", "spill_frac", "auto_train_min",
                 "ksub", "scan_recall", "assign_mode", "balance_slack",
                 "_rotate", "rerank_mode", "_seed"):
        assert getattr(tdef, name) == getattr(jdef, name), name


def test_signature_is_the_jax_packages():
    import inspect
    want = list(inspect.signature(JIvfPq.__init__).parameters)
    got = list(inspect.signature(IvfPqIndex.__init__).parameters)
    assert got == want + ["device"]
    for name in want[1:]:
        assert (inspect.signature(IvfPqIndex.__init__).parameters[name]
                .default == inspect.signature(JIvfPq.__init__)
                .parameters[name].default), name


def test_ivfpq_store_from_reference_carries_the_store():
    rng = np.random.default_rng(8)
    data = _clustered(rng, 1500, 16, n_centers=16, scale=0.3)
    js = J.VectorStore.with_index(JIvfPq(J.DistanceMetric.EUCLIDEAN,
                                         nlist=16, m=4, ksub=16, refine=32,
                                         seed=8))
    js.insert_batch([J.BatchInsertItem(f"v{i}", J.Vector(data[i]),
                                       J.Metadata({"p": str(i % 2)}))
                     for i in range(1500)])
    js.delete("v7")
    js.index.train()
    state = js.index.export_trained_state()
    rows = {int(i): js.index.get_vector(int(i)).as_array()
            for i in state["id_of_slot"][state["id_of_slot"] >= 0]}
    meta = {iid: js.get_metadata(sid).fields()
            for iid, sid in js.internal_to_string_ids().items()}
    ts = ivfpq_store_from_reference(state, rows, js.internal_to_string_ids(),
                                    EUC, device="cpu", metadata=meta,
                                    refine=32)
    assert ts.index.is_trained and len(ts) == 1499
    qs = rng.standard_normal((12, 16)).astype(np.float32) + data[:12]
    for refine in (None, 64):
        got = ts.search_batch([(Vector(q), 5) for q in qs], refine=refine)
        want = js.search_batch([(J.Vector(q), 5) for q in qs],
                               refine=refine)
        _assert_same([[(r.id, r.distance) for r in row] for row in got],
                     [[(r.id, r.distance) for r in row] for row in want])
    flt_t, flt_j = MetadataFilter.eq("p", "0"), J.MetadataFilter.eq("p", "0")
    for q in qs[:4]:
        got = ts.search_with_filter(Vector(q), 4, flt_t)
        want = js.search_with_filter(J.Vector(q), 4, flt_j)
        assert [r.id for r in got] == [r.id for r in want]


def test_import_over_a_trained_index_replaces_its_state():
    """A state imported over an index that trained itself replaces its
    centroid table, rotation and codes: the answers are the exporter's."""
    db, j = _jax_trained(EUC, n=1500, d=16, nlist=8, m=4, ksub=16,
                         refine=32, rng_seed=12)
    t = IvfPq(nlist=8, m=4, ksub=16, refine=32, seed=5)
    t.add_batch([(i, db[i]) for i in range(1500)])
    t.train()
    q = np.ascontiguousarray(db[::100] + 0.01)
    t.search_batch(q, 5)                    # builds its own scan tables
    state = j.export_trained_state()
    t.import_trained_state(state, {i: db[i] for i in range(1500)}, 16)
    np.testing.assert_array_equal(t._scan_cents().view(np.uint32),
                                  j._scan_cents().view(np.uint32))
    np.testing.assert_array_equal(t._rot, state["rotation"])
    _assert_same(t.search_batch(q, 5), j.search_batch(q, 5))
    np.testing.assert_array_equal(t._codes[t._valid],
                                  np.asarray(j._codes)[j._valid])


def test_writes_after_import_match_jax():
    """Inserts into clusters and the spill, an upsert and deletes, made
    through both packages' indexes over the same state: the spill ids
    re-resolve the same way and the answers stay the same."""
    db, j = _jax_trained(EUC, n=2000, d=16, nlist=8, m=4, ksub=16,
                         refine=64, rng_seed=4)
    t = _port_of(j, EUC)
    rng = np.random.default_rng(9)
    new = (db[:300] + 0.05 * rng.standard_normal((300, 16))).astype(
        np.float32)
    for k, row in enumerate(new):
        for idx in (j, t):
            idx.add(5000 + k, row)
    # rows near one row overflow its cluster into the spill (short of
    # exhausting it, which would retrain each package its own way)
    k = 0
    while t._valid[t._spill_base:].sum() < 8:
        row = db[0] + 0.3 * rng.standard_normal(16).astype(np.float32)
        for idx in (j, t):
            idx.add(6000 + k, row)
        k += 1
    assert t._spill_free and j._spill_free
    for idx in (j, t):
        idx.add(3, db[9] + 0.003)
        idx.remove(11)
    q = np.ascontiguousarray(new[::25] + 0.001)
    _assert_same(t.search_batch(q, 8), j.search_batch(q, 8))
    np.testing.assert_array_equal(t._spill_cid, np.asarray(j._spill_cid))


# -- tests/test_ivfpq.py on the port's own training ---------------------------

def test_train_and_recall_euclidean(rng):
    n, d, q, k = 4096, 32, 40, 10
    db = _clustered(rng, n, d)
    idx = IvfPq(nlist=32, m=8, ksub=64, refine=64, seed=1)
    idx.add_batch([(i, db[i]) for i in range(n)])
    assert not idx.is_trained
    idx.train()
    assert idx.is_trained
    queries = db[rng.choice(n, q, replace=False)] + 0.005
    results = idx.search_batch(queries, k)
    want = _flat_topk(queries, db, EUC, k)
    assert _recall(results, want, k) >= 0.9
    for qi, got in enumerate(results[:5]):
        for rid, dist in got:
            ref = float(np.linalg.norm(queries[qi] - db[rid]))
            assert abs(dist - ref) < 1e-3, (rid, dist, ref)
    for got in results:
        dd = [dv for _, dv in got]
        assert dd == sorted(dd)


@pytest.mark.parametrize("metric", METRICS)
def test_exact_distances_per_metric(rng, metric):
    n, d, q, k = 2048, 16, 8, 5
    db = _clustered(rng, n, d, n_centers=16)
    if metric is DistanceMetric.COSINE:
        db = db[np.linalg.norm(db, axis=1) > 1e-3]
        n = len(db)
    idx = IvfPq(metric, nlist=16, m=4, ksub=32, refine=64)
    idx.add_batch([(i, db[i]) for i in range(n)])
    idx.train()
    queries = db[:q] * 1.01
    results = idx.search_batch(queries, k)
    exact = _np_dists(queries, db, metric)
    for qi, got in enumerate(results):
        assert len(got) == k
        for rid, dist in got:
            assert abs(dist - float(exact[qi, rid])) < 2e-3


def test_residuals_beat_raw_codes_on_clustered_data(rng):
    """The family's reason to exist: within tight clusters raw-row PQ
    codes tie and recall collapses; residual codes resolve the
    deviations. Same data, same m/ksub/refine. The gate depends on the
    trained clusters and codebooks (from seed to seed each package's own
    training lands on either side of it), so both indexes run on the JAX
    package's trained state."""
    from vectordb_tpu.index.pq import PqFlatIndex as JPq
    n, d, q, k = 16384, 64, 48, 10
    nc = 128
    centers = rng.standard_normal((nc, d)).astype(np.float32)
    db = (centers[rng.integers(0, nc, n)]
          + 0.2 * rng.standard_normal((n, d)).astype(np.float32))
    queries = (centers[rng.integers(0, nc, q)]
               + 0.2 * rng.standard_normal((q, d)).astype(np.float32))
    want = _flat_topk(queries, db, EUC, k)
    ids = np.arange(n, dtype=np.int64)
    jplain = JPq(J.DistanceMetric.EUCLIDEAN, m=8, seed=1)
    jplain.bulk_load_matrix(ids, db)
    jplain.train()
    plain = PqFlatIndex(EUC, m=8, seed=1, device="cpu")
    plain.bulk_load_matrix(ids, db)
    plain.import_trained_state(jplain.export_trained_state())
    r_plain = _recall(plain.search_batch(queries, k, refine=64), want, k)
    jres = JIvfPq(J.DistanceMetric.EUCLIDEAN, nlist=nc, m=8, seed=1)
    jres.bulk_load_matrix(ids, db)
    jres.train()
    res = IvfPq(nlist=nc, m=8, seed=1)
    res.import_trained_state(jres.export_trained_state(),
                             {i: db[i] for i in range(n)}, d)
    r_res = _recall(res.search_batch(queries, k, refine=64), want, k)
    assert r_res >= r_plain + 0.1, (r_res, r_plain)
    assert r_res >= 0.85, r_res


def test_refine_knob_and_search_with_refine(rng):
    n, d, q, k = 4096, 32, 32, 10
    db = _clustered(rng, n, d, n_centers=16, scale=0.5)
    idx = IvfPq(nlist=16, m=16, ksub=16, seed=3)
    idx.add_batch([(i, db[i]) for i in range(n)])
    idx.train()
    queries = db[:q] + 0.01
    want = _flat_topk(queries, db, EUC, k)
    recalls = [_recall(idx.search_batch(queries, k, refine=r), want, k)
               for r in (k, 64, 256)]
    assert recalls[-1] >= recalls[0] - 0.02
    assert recalls[-1] >= 0.95
    one = idx.search_with_refine(Vector(db[0] + 0.01), k, 256)
    assert len(one) == k
    assert idx.search_with_nprobe is None
    assert idx.calibrate_nprobe is None


def test_mutations_after_training(rng):
    n, d, k = 4096, 24, 5
    db = _clustered(rng, n, d, n_centers=32)
    idx = IvfPq(nlist=32, m=8, ksub=32, refine=64)
    idx.add_batch([(i, db[i]) for i in range(n)])
    idx.train()
    new_row = db[7] + 0.002
    idx.add(10_000, new_row)
    got = idx.search_batch(new_row[None, :], 1)[0]
    assert got[0][0] == 10_000 and got[0][1] < 1e-4
    idx.add(10_000, db[9] + 0.003)
    got = idx.search_batch((db[9] + 0.003)[None, :], 1)[0]
    assert got[0][0] == 10_000
    idx.remove(3)
    got = idx.search_batch(db[3][None, :], k)[0]
    assert all(i != 3 for i, _ in got)
    assert len(idx) == n


def test_spill_rows_are_searchable(rng):
    """Rows that overflow their cluster land in the spill region, encoded
    against their NEAREST centroid, and stay findable with exact
    distances."""
    n, d = 2048, 16
    db = _clustered(rng, n, d, n_centers=8, scale=0.3)
    idx = IvfPq(nlist=8, m=4, ksub=16, refine=64)
    idx.add_batch([(i, db[i]) for i in range(n)])
    idx.train()
    base = db[0]
    for j in range(600):
        idx.add(50_000 + j, base + 0.001 * rng.standard_normal(d).astype(
            np.float32))
        if not idx._spill_free:
            break
    assert (np.asarray(idx._spill_cid) >= -1).all()
    spill_live = [s for s in range(idx._spill_base, idx.capacity)
                  if idx._valid[s]]
    assert spill_live, "the layout absorbed every insert"
    sid = int(idx._id_of_slot[spill_live[0]])
    row = np.asarray(idx._vectors[spill_live[0]])
    got = idx.search_batch(row[None, :], 1)[0]
    assert got[0][0] == sid and got[0][1] < 1e-5


def test_filtered_search_exact_through_store(rng):
    n, d, k = 4096, 16, 5
    db = _clustered(rng, n, d, n_centers=16)
    store = VectorStore.with_index(IvfPq(nlist=16, m=4, ksub=32,
                                         refine=128))
    store.insert_batch([
        BatchInsertItem(id=f"v{i}", vector=Vector(db[i]),
                        metadata=Metadata({"par": str(i % 3)}))
        for i in range(n)])
    store.index.train()
    got = store.search_with_filter(Vector(db[5]), k,
                                   MetadataFilter.eq("par", "1"))
    eligible = np.array([i for i in range(n) if i % 3 == 1])
    dists = np.linalg.norm(db[eligible] - db[5][None, :], axis=1)
    order = np.argsort(dists, kind="stable")[:k]
    assert [r.id for r in got] == [f"v{eligible[j]}" for j in order]
    for r, j in zip(got, order):
        assert abs(r.distance - float(dists[j])) < 1e-4


def test_auto_train_threshold(rng):
    n, d = 600, 16
    db = _clustered(rng, n, d, n_centers=8)
    idx = IvfPq(nlist=8, m=4, ksub=16, auto_train_min=512)
    idx.add_batch([(i, db[i]) for i in range(n)])
    assert not idx.is_trained
    got = idx.search_batch(db[:2], 3)
    assert idx.is_trained
    assert got[0][0][0] == 0


def test_untrained_falls_back_to_exact_scan(rng, monkeypatch):
    """Untrained, the exact flat path answers over the layout (kernel K4
    and K2's plain versions: the f32 device rows carry coarse_f32)."""
    from vectordb_tpu_torch.ops import coarse_kernel
    seen = []
    real = coarse_kernel._refine_dots
    monkeypatch.setattr(coarse_kernel, "_refine_dots",
                        lambda *a, **kw: seen.append(1) or real(*a, **kw))
    n, d, k = 1024, 16, 5
    db = _clustered(rng, n, d, n_centers=4)
    idx = IvfPq(nlist=8)
    idx.add_batch([(i, db[i]) for i in range(n)])
    got = idx.search_batch(db[:4] + 0.001, k)
    want = _flat_topk(db[:4] + 0.001, db, EUC, k)
    assert _recall(got, want, k) == 1.0
    assert not idx.is_trained and seen
    with idx._lock:
        assert idx._sync_device()["coarse_f32"]


def test_huge_refine_falls_back_to_exact_scan(rng):
    n, d, k = 2048, 16, 1500
    db = _clustered(rng, n, d, n_centers=8)
    idx = IvfPq(nlist=8, m=4, ksub=16)
    idx.add_batch([(i, db[i]) for i in range(n)])
    idx.train()
    got = idx.search_batch(db[:2], k)
    assert len(got[0]) == k
    dd = [dv for _, dv in got[0]]
    assert dd == sorted(dd)


def test_trained_state_roundtrip_bit_identical(rng, tmp_path):
    """Engine checkpoint -> crash -> reopen restores the trained layout
    and the residual codebook: no retrain, bit-identical results."""
    n, d, k = 1024, 16, 5
    db = _clustered(rng, n, d, n_centers=8)
    cfg = EngineConfig(checkpoint_interval=10_000, index_type="ivfpq",
                       device="cpu")
    eng = StorageEngine.open(tmp_path, cfg)
    for i in range(n):
        eng.insert(f"v{i}", Vector(db[i]))
    eng.store.index.train()
    eng.checkpoint()
    eng.insert("tail", Vector(db[0] + 0.01))
    queries = db[:8] + 0.002
    before = [eng.store.search(Vector(qv), k) for qv in queries]
    assert eng.store.index.is_trained
    eng.close()

    eng2 = StorageEngine.open(tmp_path, cfg)
    idx2 = eng2.store.index
    assert idx2.is_trained, "reopen must not retrain"
    after = [eng2.store.search(Vector(qv), k) for qv in queries]
    for b_row, a_row in zip(before, after):
        assert [r.id for r in b_row] == [r.id for r in a_row]
        for rb, ra in zip(b_row, a_row):
            assert rb.distance == ra.distance
    np.testing.assert_array_equal(eng.store.index._spill_cid,
                                  idx2._spill_cid)
    np.testing.assert_array_equal(eng.store.index._codebook, idx2._codebook)
    eng2.close()


def test_retrain_during_search_retries_cleanly(rng):
    """A retrain (slot repack) racing a search must not re-rank stale slots
    against the new packing: the search re-runs over the new layout."""
    n, d, k = 2048, 16, 5
    db = _clustered(rng, n, d, n_centers=8)
    idx = IvfPq(nlist=8, m=4, ksub=16, refine=256)
    idx.add_batch([(i, db[i]) for i in range(n)])
    idx.train()
    orig = idx._scan_call
    fired = {"n": 0}

    def racy(state, qb, r):
        out = orig(state, qb, r)
        if fired["n"] == 0:
            fired["n"] += 1
            idx.train()
        return out

    idx._scan_call = racy
    queries = db[:4] + 0.001
    got = idx.search_batch(queries, k)
    assert fired["n"] == 1
    want = _flat_topk(queries, db, EUC, k)
    assert _recall(got, want, k) >= 0.8
    for qi, row in enumerate(got):
        for rid, dist in row:
            ref = float(np.linalg.norm(queries[qi] - db[rid]))
            assert abs(dist - ref) < 1e-4


def test_rejects_bad_config():
    for kw in ({"ksub": 512}, {"refine": 0}, {"nlist": 1},
               {"scan_recall": 0.0}, {"rerank": "bogus"}):
        with pytest.raises(ValueError):
            IvfPq(**kw)
    idx = IvfPq(m=5)
    idx.add_batch([(i, np.ones(16, np.float32) * i) for i in range(300)])
    with pytest.raises(IndexOpError):
        idx.train()


def test_store_knob_validation(rng):
    store = VectorStore.with_index(IvfPq(nlist=8, m=4, ksub=16))
    db = _clustered(rng, 512, 16, n_centers=4)
    store.insert_batch([BatchInsertItem(id=f"v{i}", vector=Vector(db[i]))
                        for i in range(len(db))])
    store.index.train()
    q = Vector(db[0])
    assert len(store.search(q, 3, refine=64)) == 3
    with pytest.raises(IndexOpError):
        store.search(q, 3, nprobe=4)
    with pytest.raises(IndexOpError):
        store.search(q, 3, ef=10)


def test_opq_rotation_learned_on_residuals(rng):
    n, d, k = 4096, 32, 10
    centers = (2.0 * rng.standard_normal((32, d))).astype(np.float32)
    w = rng.standard_normal((4, d)).astype(np.float32)
    z = rng.standard_normal((n, 4)).astype(np.float32)
    db = (centers[rng.integers(0, 32, n)] + 0.25 * (z @ w)).astype(
        np.float32)
    queries = db[rng.choice(n, 32, replace=False)] + 0.002
    want = _flat_topk(queries, db, EUC, k)
    recalls = {}
    for rotate in (True, False):
        idx = IvfPq(nlist=32, m=8, ksub=32, refine=16, seed=1,
                    rotate=rotate)
        idx.add_batch([(i, db[i]) for i in range(n)])
        idx.train()
        if rotate:
            np.testing.assert_allclose(idx._rot.T @ idx._rot, np.eye(d),
                                       atol=1e-4)
        else:
            assert idx._rot is None
        recalls[rotate] = _recall(idx.search_batch(queries, k), want, k)
    assert recalls[True] >= recalls[False] - 0.05, recalls
    assert recalls[True] >= 0.6, recalls


def test_opq_rotation_persists_bit_identical(rng):
    n, d, k = 2048, 16, 5
    db = _clustered(rng, n, d, n_centers=16)
    idx = IvfPq(nlist=16, m=4, ksub=32, refine=32, seed=3, rotate=True)
    idx.add_batch([(i, db[i]) for i in range(n)])
    idx.train()
    assert idx._rot is not None
    queries = db[:8] + 0.01
    before = idx.search_batch(queries, k)
    tables = idx.export_trained_state()
    assert "rotation" in tables
    idx2 = IvfPq(nlist=16, m=4, ksub=32, refine=32, seed=3)
    idx2.import_trained_state(tables, {i: db[i] for i in range(n)}, d)
    np.testing.assert_array_equal(idx2._rot, idx._rot)
    assert idx2.search_batch(queries, k) == before


def test_ivfpq_device_rerank_matches_host(rng):
    """tests/test_pq_index.py::test_ivfpq_device_rerank_matches_host: the
    "mirror" venue (device rows, here CPU tensors) ranks as the host."""
    n, d = 4096, 16
    db = _clustered(rng, n, d, n_centers=8)
    ids = np.arange(n, dtype=np.int64)
    host = IvfPq(nlist=8, m=4, ksub=16, refine=64, seed=0, rerank="host")
    dev = IvfPq(nlist=8, m=4, ksub=16, refine=64, seed=0, rerank="device")
    host.bulk_load_matrix(ids, db)
    dev.bulk_load_matrix(ids, db)
    host.train()
    dev.train()
    assert dev._rerank_venue() == "mirror"
    q = np.ascontiguousarray(db[:16] + 0.001)
    want = host.search_batch(q, 5)
    got = dev.search_batch(q, 5)
    for w, g in zip(want, got):
        assert [i for i, _ in w] == [i for i, _ in g]
        np.testing.assert_allclose([x for _, x in w], [x for _, x in g],
                                   rtol=1e-5, atol=1e-5)


def test_nearest_cids_host_and_device_agree(rng, monkeypatch):
    """The bulk (device) nearest-centroid search picks what the host BLAS
    path picks on tie-free rows."""
    db = _clustered(rng, 3000, 16, n_centers=8, scale=0.3)
    idx = IvfPq(nlist=8, m=4, ksub=16)
    idx.add_batch([(i, db[i]) for i in range(3000)])
    idx.train()
    rows = _clustered(np.random.default_rng(1), 500, 16, n_centers=8)
    host = idx._nearest_cids(rows)
    monkeypatch.setattr(ivfpq_mod, "_NEAREST_HOST_MAX", 0)
    monkeypatch.setattr(ivfpq_mod, "_NEAREST_CHUNK", 128)
    np.testing.assert_array_equal(idx._nearest_cids(rows), host)


# -- ivfpq_state.npz: the JAX package's bytes, read by both -------------------

def test_ivfpq_state_bytes_and_cross_read(tmp_path, monkeypatch):
    """The JAX engine trains and checkpoints; the port reopens its
    directory without retraining and answers the same; the port's
    checkpoint of that state writes the same bytes; the JAX engine
    reopens the port's directory without retraining."""
    from vectordb_tpu.persistence import EngineConfig as JCfg
    from vectordb_tpu.persistence import StorageEngine as JEngine
    rng = np.random.default_rng(6)
    data = _clustered(rng, 700, 8, n_centers=8, scale=0.3)
    queries = rng.standard_normal((14, 8)).astype(np.float32)
    jcfg = JCfg(checkpoint_interval=10 ** 9,
                metric=J.DistanceMetric.EUCLIDEAN, index_type="ivfpq")
    tcfg = EngineConfig(checkpoint_interval=10 ** 9, metric=EUC,
                        index_type="ivfpq", device="cpu")
    with JEngine.open(tmp_path, jcfg) as eng:
        eng.insert_batch([J.BatchInsertItem(f"v{i}", J.Vector(data[i]),
                                            J.Metadata({"g": str(i % 3)}))
                          for i in range(700)])
        eng.store.index.train()
        eng.checkpoint()
        want = [[(r.id, r.distance) for r in eng.search(J.Vector(q), 5,
                                                        refine=32)]
                for q in queries]
    jbytes = (tmp_path / "ivfpq_state.npz").read_bytes()

    def boom(self):
        raise AssertionError("reopen must not retrain")

    monkeypatch.setattr(IvfPqIndex, "train", boom)
    monkeypatch.setattr(JIvfPq, "train", boom)
    with StorageEngine.open(tmp_path, tcfg) as eng:
        assert eng.store.index.is_trained
        got = [[(r.id, r.distance) for r in eng.search(Vector(q), 5,
                                                       refine=32)]
               for q in queries]
        _assert_same(got, want)
        eng.checkpoint()
    assert (tmp_path / "ivfpq_state.npz").read_bytes() == jbytes
    with JEngine.open(tmp_path, jcfg) as eng:
        assert eng.store.index.is_trained
        again = [[r.id for r in eng.search(J.Vector(q), 5, refine=32)]
                 for q in queries]
        assert again == [[i for i, _ in r] for r in want]


def test_engines_write_identical_ivfpq_state(tmp_path):
    """Both engines checkpoint the same trained state into the same
    bytes: snapshot and ivfpq_state.npz, with and without OPQ."""
    from vectordb_tpu.persistence import EngineConfig as JCfg
    from vectordb_tpu.persistence import StorageEngine as JEngine
    rng = np.random.default_rng(2)
    data = _clustered(rng, 400, 8, n_centers=4, scale=0.3)
    jdir, tdir = tmp_path / "j", tmp_path / "t"
    with JEngine.open(jdir, JCfg(checkpoint_interval=10 ** 9,
                                 index_type="ivfpq")) as eng:
        for i in range(400):
            eng.insert(f"v{i}", J.Vector(data[i]))
        eng.store.index.train()
        state = eng.store.index.export_trained_state()
        assert "rotation" in state
        eng.checkpoint()
    with StorageEngine.open(tdir, EngineConfig(
            checkpoint_interval=10 ** 9, index_type="ivfpq",
            device="cpu")) as eng:
        for i in range(400):
            eng.insert(f"v{i}", Vector(data[i]))
        eng.store.index.import_trained_state(
            state, {i: data[i] for i in range(400)}, 8)
        eng.checkpoint()
    for name in ("snapshot.bin", "ivfpq_state.npz"):
        assert (jdir / name).read_bytes() == (tdir / name).read_bytes(), name


def test_untrained_checkpoint_removes_stale_state(tmp_path, rng):
    cfg = EngineConfig(checkpoint_interval=10 ** 9, index_type="ivfpq",
                       device="cpu")
    with StorageEngine.open(tmp_path, cfg) as eng:
        eng.insert("a", Vector([1.0, 2.0, 3.0, 4.0]))
        (tmp_path / "ivfpq_state.npz").write_bytes(b"stale")
        eng.checkpoint()
        assert not (tmp_path / "ivfpq_state.npz").exists()
    data = _clustered(rng, 400, 4, n_centers=4)
    with StorageEngine.open(tmp_path / "s", cfg) as eng:
        for i in range(400):
            eng.insert(f"v{i}", Vector(data[i]))
        eng.store.index.train()
        eng.checkpoint()
        eng.insert("late", Vector(data[0]))
        eng.checkpoint()    # a new snapshot: the state is re-bound to it
    (tmp_path / "s" / "ivfpq_state.npz").write_bytes(b"corrupt")
    with StorageEngine.open(tmp_path / "s", cfg) as eng:
        assert not eng.store.index.is_trained      # rebuilt, not bound
        assert eng.search(Vector(data[5]), 1)[0].id == "v5"


# -- the CLI, the routes and the native front end -----------------------------

def test_cli_index_ivfpq(tmp_path, capsys, monkeypatch):
    assert cli.main(["--device", "cpu", "--index", "ivfpq", "insert", "a",
                     "--vector", "1,2,3"]) == 0
    assert cli.main(["--device", "cpu", "--index", "ivfpq", "search",
                     "1,2,3", "-k", "1", "--refine", "16"]) == 0
    assert "No results found" in capsys.readouterr().out   # in-memory
    d = str(tmp_path / "d")
    for i in range(3):
        assert cli.main(["--device", "cpu", "--index", "ivfpq",
                         "--data-dir", d, "insert", f"v{i}", "--vector",
                         f"{i},1,2"]) == 0
    assert cli.main(["--device", "cpu", "--index", "ivfpq", "--data-dir", d,
                     "search", "1,1,2", "-k", "2", "--refine", "8"]) == 0
    assert "1. v1 (distance: 0.0000)" in capsys.readouterr().out
    assert cli.main(["--device", "cpu", "--index", "ivfpq", "--data-dir", d,
                     "search", "1,1,2", "--nprobe", "2"]) == 1
    assert "nprobe" in capsys.readouterr().err
    from vectordb_tpu_torch.server import app
    seen = []
    monkeypatch.setattr(app, "serve", lambda addr, state, **kw:
                        seen.append(state.store.index))
    monkeypatch.setattr(app, "start_durable",
                        lambda addr, dd, c, **kw: seen.append(c))
    assert cli.main(["--device", "cpu", "--index", "ivfpq", "serve",
                     "--addr", "127.0.0.1:0"]) == 0
    assert cli.main(["--device", "cpu", "--index", "ivfpq", "serve",
                     "--durable-dir", d]) == 0
    assert isinstance(seen[0], IvfPqIndex)
    assert seen[1].index_type == "ivfpq" and seen[1].device == "cpu"


def _route_pair():
    from vectordb_tpu.server.app import AppState as JState
    from vectordb_tpu.server.routes import Api as JApi
    from vectordb_tpu_torch.server.app import AppState
    from vectordb_tpu_torch.server.routes import Api
    rng = np.random.default_rng(5)
    data = _clustered(rng, 600, 8, n_centers=8, scale=0.3)
    items = [{"id": f"v{i}", "vector": [float(x) for x in row]}
             for i, row in enumerate(data)]
    jidx = JIvfPq(J.DistanceMetric.EUCLIDEAN, nlist=8, m=4, ksub=16,
                  refine=16, seed=2)
    japi = JApi(JState(J.VectorStore(jidx)))
    assert japi.handle("POST", "/vectors/batch", {"vectors": items})[0] \
        == 201
    jidx.train()
    js = japi.state.store
    state = jidx.export_trained_state()
    rows = {int(i): jidx.get_vector(int(i)).as_array()
            for i in state["id_of_slot"][state["id_of_slot"] >= 0]}
    ts = ivfpq_store_from_reference(state, rows, js.internal_to_string_ids(),
                                    EUC, device="cpu", refine=16)
    return japi, Api(AppState(ts)), items


@pytest.mark.parametrize("body", [
    {"k": 5, "refine": 64},
    {"k": 5},
    {"k": 5, "nprobe": 4},
    {"k": 5, "ef": 10},
    {"k": 5, "refine": 0},
    {"k": 5, "refine": 32, "filter": {"op": "exists", "field": "x"}}],
    ids=["refine", "default", "nprobe", "ef", "refine0", "refine_filter"])
def test_routes_answer_as_the_jax_packages(body):
    japi, tapi, items = _route_pair()
    q = (np.asarray(items[9]["vector"], np.float32) + 0.01).tolist()
    for path, payload in (
            ("/search", {"vector": q, **body}),
            ("/search/batch", {"queries": [{"vector": q, "k": body["k"]}],
                               **{k: v for k, v in body.items()
                                  if k != "k"}})):
        js, jb = japi.handle("POST", path, payload)
        ts, tb = tapi.handle("POST", path, payload)
        assert ts == js, (path, ts, tb, jb)
        if js != 200:
            assert tb == jb
            continue
        flat_j = jb if path == "/search" else jb[0]
        flat_t = tb if path == "/search" else tb[0]
        assert [h["id"] for h in flat_t] == [h["id"] for h in flat_j]
        np.testing.assert_allclose([h["distance"] for h in flat_t],
                                   [h["distance"] for h in flat_j],
                                   rtol=2e-5, atol=2e-5)


def test_refine_over_the_native_front_end(rng):
    """The refine knob reaches the index through the native front end's
    grouped submit as it does through the routes."""
    from vectordb_tpu_torch.server.app import AppState, serve
    idx = IvfPq(nlist=8, m=4, ksub=16, refine=4, auto_train_min=10 ** 9)
    store = VectorStore(idx)
    data = _clustered(rng, 800, 8, n_centers=8)
    store.insert_batch([BatchInsertItem(f"v{i}", Vector(data[i]))
                        for i in range(800)])
    idx.train()
    state = AppState(store)
    ready = threading.Event()
    t = threading.Thread(target=serve, args=("127.0.0.1:0", state),
                         kwargs={"ready_event": ready, "backend": "native"},
                         daemon=True)
    t.start()
    assert ready.wait(60)
    try:
        port = state.server.port

        def post(path, body):
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}{path}",
                data=json.dumps(body).encode(), method="POST",
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as r:
                return json.loads(r.read())

        q = (data[11] + 0.01).tolist()
        for refine in (4, 64):
            want = [r.id for r in store.search(Vector(q), 5, refine=refine)]
            assert [h["id"] for h in post("/search", {
                "vector": q, "k": 5, "refine": refine})] == want
            got = post("/search/batch", {"queries": [{"vector": q, "k": 5}],
                                         "refine": refine})
            assert [h["id"] for h in got[0]] == want
    finally:
        state.server.shutdown()
        t.join(timeout=30)
