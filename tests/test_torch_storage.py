"""The flat index's bf16, int8 and f32-source storage modes of the port
against the JAX package's.

The same numpy inputs go through the JAX function (Pallas in interpret
mode, as its own tests run it on the CPU) and through the port (the plain
PyTorch versions of K1-K7 and K2 on CPU tensors):

  * the quantizers, bit for bit;
  * the plain K4-K7 and K2 over bf16 rows / int8 codes against the JAX
    launchers, within the summation-order bound of
    tests/test_torch_coarse_kernel.py (bf16 x bf16 products are exact in
    f32, so two f32 sums of the same d products differ by at most
    2*d*2^-24*sum|a b|; the bound doubles that once more);
  * the coarse pipelines over each source: same ids, distances at rtol
    2e-5, same certified flags;
  * whole stores carried across with convert.store_from_reference, for
    all three metrics, through writes, fast mode and forced fallbacks.
The data is continuous random, so top-k has no ties. d=32 keeps the JAX
refine on its XLA gather path, as in tests/test_torch_store.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import ml_dtypes

import vectordb_tpu as J
from vectordb_tpu.index import flat as jflat
from vectordb_tpu.ops import coarse_kernel as jck
from vectordb_tpu.ops import topk as jtopk

import vectordb_tpu_torch as T
from vectordb_tpu_torch.convert import store_from_reference
from vectordb_tpu_torch.index import flat as tflat
from vectordb_tpu_torch.ops import coarse_kernel as tck
from vectordb_tpu_torch.ops import topk as ttopk

# One intra-op thread, as in the other test_torch_* files.
torch.set_num_threads(1)

MODES = {"euclidean": "euclidean", "dot_product": "dot", "cosine": "cosine"}
METRICS = list(MODES)
N, D = 2000, 32


@pytest.fixture(autouse=True)
def _tiers(monkeypatch):
    monkeypatch.setenv("VDB_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setattr(jtopk, "_EXACT1P_MIN_N", 512)
    monkeypatch.setattr(ttopk, "_EXACT1P_MIN_N", 512)


def _j(t):
    """A torch tensor as a JAX array (bf16 stays bf16, by value)."""
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(t.numpy())


# ---------------------------------------------------------------------------
# quantizers
# ---------------------------------------------------------------------------

def _hard_rows(seed):
    rng = np.random.default_rng(seed)
    mat = (rng.standard_normal((64, 24)).astype(np.float32)
           * np.exp(rng.uniform(-8, 8, (64, 1))).astype(np.float32))
    mat[0] = 0.0                                   # zero row
    mat[1, :] = 0.5
    mat[1, 3] = 127.0 * 2.0 ** -3                  # max exactly 127 * 2^k
    mat[2, 5] = -127.0 * 2.0 ** 4
    mat[3, 0] = 127.0 * 2.0 ** 5 * (1 + 2.0 ** -20)   # just past it
    # bf16 ties: halfway between two bf16 neighbours (round to even)
    mat[4, :8] = (np.float32(1.0) + np.float32(2.0 ** -8)
                  * np.arange(1, 16, 2)[:8].astype(np.float32))
    mat[5, :4] = [3e38, -3e38, 1e-38, -1e-40]      # huge and subnormal
    return mat


def test_bf16_quantizer_is_bitwise_the_jax_one():
    mat = _hard_rows(0)
    want = mat.astype(ml_dtypes.bfloat16)
    got = tflat._bf16_bits(mat)
    assert np.array_equal(got, want.view(np.uint16))
    assert np.array_equal(tflat._quantize_bf16(mat).view(np.uint32),
                          jflat._quantize_bf16(mat).view(np.uint32))


def test_int8_quantizers_are_bitwise_the_jax_ones():
    mat = _hard_rows(1)
    assert np.array_equal(tflat._int8_row_scales(mat),
                          jflat._int8_row_scales(mat))
    q_t, q_j = tflat._quantize_int8(mat), jflat._quantize_int8(mat)
    assert np.array_equal(q_t.view(np.uint32), q_j.view(np.uint32))
    assert np.array_equal(tflat._quantize_int8(mat[7]),
                          jflat._quantize_int8(mat[7]))
    for got, want in zip(tflat._int8_codes_scales(q_t),
                         jflat._int8_codes_scales(q_j)):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(tflat._quantize_int8(q_t), q_t)   # idempotent
    assert np.array_equal(q_t[0], np.zeros_like(q_t[0]))    # zero row


# ---------------------------------------------------------------------------
# plain K4-K7 and K2 sources against the JAX launchers
# ---------------------------------------------------------------------------

def _data(seed, n, d, q, dead=0.1):
    rng = np.random.default_rng(seed)
    db = rng.standard_normal((n, d)).astype(np.float32)
    valid = np.ones(n, bool)
    valid[rng.choice(n, int(n * dead), replace=False)] = False
    queries = rng.standard_normal((q, d)).astype(np.float32)
    return db, valid, queries


def _terms(db, valid, queries, mode):
    sq = np.einsum("ij,ij->i", db, db).astype(np.float32)
    return tck._query_terms(torch.from_numpy(queries), torch.from_numpy(sq),
                            torch.from_numpy(np.sqrt(sq)),
                            torch.from_numpy(valid), mode)


def _bound(mode, d, db, queries, passes=1):
    xmax = float(np.linalg.norm(db, axis=1).max())
    qmax = float(np.linalg.norm(queries, axis=1).max())
    dot_b = passes * d * 2.0 ** -22 * xmax * qmax
    return {"euclidean": 2 * dot_b + 2.0 ** -22 * (xmax ** 2 + qmax ** 2),
            "dot": dot_b, "cosine": passes * d * 2.0 ** -22 * 1.01}[mode]


def _live_close(got, want, bound):
    live = want < 1e29          # a fully dead tile holds ~PENALTY
    assert np.array_equal(live, got < 1e29)
    assert np.abs(got[live] - want[live]).max() <= bound


def _int8(db):
    codes, scales = jflat._int8_codes_scales(jflat._quantize_int8(db))
    return codes, scales


@pytest.mark.parametrize("src", ["f32", "int8"])
@pytest.mark.parametrize("metric", METRICS)
def test_plain_k4_k7_match_minima_1p_sup(metric, src):
    mode = MODES[metric]
    db, valid, queries = _data(1, 1024, 32, 8)
    scales_t = scales_j = None
    if src == "int8":
        codes, scales = _int8(db)
        db = codes.astype(np.float32) * scales[:, None]     # stored values
        arr = torch.from_numpy(codes)
        scales_t = torch.from_numpy(scales).reshape(1, -1)
        scales_j = jnp.asarray(scales)
    else:
        arr = torch.from_numpy(db)
    qThi, _, _, _, qrow, col, inv_col = _terms(db, valid, queries, mode)
    tile_t, sup_t = tck._minima_1p_sup(qThi, qrow, arr, col, inv_col, mode,
                                       src, scales_t)
    tile_j, sup_j = jck._minima_1p_sup(
        _j(qThi), _j(qrow), jnp.asarray(arr.numpy()), _j(col), _j(inv_col),
        mode, True, src, scales_j)
    assert tile_t.shape == (1024 // 16, 8) and sup_t.shape == (4, 8)
    bound = _bound(mode, 32, db, queries)
    _live_close(tile_t.numpy(), np.asarray(tile_j), bound)
    _live_close(sup_t.numpy(), np.asarray(sup_j), bound)


@pytest.mark.parametrize("passes", [3, 1])
@pytest.mark.parametrize("metric", METRICS)
def test_plain_k5_matches_coarse_minima_f32(metric, passes):
    mode = MODES[metric]
    db, valid, queries = _data(2, 1024, 32, 8)
    qThi, qlo, _, _, qrow, col, inv_col = _terms(db, valid, queries, mode)
    qTlo = qlo.to(torch.bfloat16)
    got = tck._coarse_minima_f32(qThi, qTlo, qrow, torch.from_numpy(db), col,
                                 inv_col, passes, mode)
    want = jck._coarse_minima_f32(_j(qThi), _j(qTlo), _j(qrow),
                                  jnp.asarray(db), _j(col), _j(inv_col),
                                  passes=passes, mode=mode, interpret=True)
    assert got.shape == (8, 1024 // 16)
    _live_close(got.numpy(), np.asarray(want),
                _bound(mode, 32, db, queries, passes))


@pytest.mark.parametrize("metric", METRICS)
def test_plain_k6_matches_coarse_minima_1p(metric):
    mode = MODES[metric]
    db, valid, queries = _data(3, 1024, 32, 8)
    qThi, _, _, _, qrow, col, inv_col = _terms(db, valid, queries, mode)
    hi = torch.from_numpy(db).to(torch.bfloat16)
    got = tck._coarse_minima_1p(qThi, qrow, hi, col, inv_col, mode)
    want = jck._coarse_minima_1p(_j(qThi), _j(qrow), _j(hi), _j(col),
                                 _j(inv_col), mode=mode, interpret=True)
    assert got.shape == (8, 1024 // 16)
    _live_close(got.numpy(), np.asarray(want), _bound(mode, 32, db, queries))


def test_plain_k2_bf16_matches_refine_dots():
    # interpret-mode _refine_dots is slow: keep m <= 4, q = 8 (d % 128 == 0
    # is the JAX kernel's own gate)
    n, d, q, m = 1024, 128, 8, 4
    db, _, queries = _data(4, n, d, q)
    db16 = torch.from_numpy(db).to(torch.bfloat16)
    tile_idx = np.random.default_rng(40).integers(0, n // 16, (q, m))
    got = tck._refine_dots(torch.from_numpy(tile_idx),
                           torch.from_numpy(queries), db16, m)
    want = jck._refine_dots(jnp.asarray(tile_idx, jnp.int32),
                            jnp.asarray(queries), _j(db16), m, True)
    bound = d * 2.0 ** -22 * float(np.linalg.norm(db, axis=1).max()) \
        * float(np.linalg.norm(queries, axis=1).max())
    assert got.shape == (q, m * 16)
    assert np.abs(got.numpy() - np.asarray(want)).max() <= bound


@pytest.mark.parametrize("metric", METRICS)
def test_refine_topk_int8_matches_jax(metric):
    """K2 over int8 codes: the dot over the codes, then the pow2 scale —
    _refine_topk(scales=) gives the JAX scores, positions and w."""
    mode = MODES[metric]
    n, d, q, m, k = 1024, 32, 8, 6, 5
    db, valid, queries = _data(5, n, d, q)
    codes, scales = _int8(db)
    stored = codes.astype(np.float32) * scales[:, None]
    sq = np.einsum("ij,ij->i", stored, stored).astype(np.float32)
    nrm = np.sqrt(sq)
    qsq = np.einsum("ij,ij->i", queries, queries).astype(np.float32)
    tile_idx = np.random.default_rng(50).permutation(n // 16)[:m]
    tile_idx = np.tile(tile_idx, (q, 1))
    got = tck._refine_topk(
        torch.from_numpy(tile_idx), torch.from_numpy(queries),
        torch.from_numpy(qsq), torch.from_numpy(np.sqrt(qsq)),
        torch.from_numpy(codes), torch.from_numpy(sq), torch.from_numpy(nrm),
        torch.from_numpy(valid), mode, m, k, torch.from_numpy(scales))
    want = jck._refine_topk(
        jnp.asarray(tile_idx, jnp.int32), jnp.asarray(queries),
        jnp.asarray(qsq), jnp.asarray(np.sqrt(qsq)), jnp.asarray(codes),
        jnp.asarray(sq), jnp.asarray(nrm), jnp.asarray(valid), mode, m, k,
        True, scales=jnp.asarray(scales))
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    for a, b in ((got[0], want[0]), (got[2], want[2])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-5,
                                   atol=2e-5)


# ---------------------------------------------------------------------------
# coarse pipelines over the f32 and int8 sources
# ---------------------------------------------------------------------------

def _pipeline_states(db, valid, int8=False):
    """(jax state, torch state): f32 rows (or int8 codes + scales) with the
    norms of the stored values and the residual bound of the source."""
    scales = None
    if int8:
        db, scales = _int8(db)
        vals = db.astype(np.float32) * scales[:, None]
    else:
        vals = db
    sq = np.einsum("ij,ij->i", vals, vals).astype(np.float32)
    arrs = {"db": db, "sq_norms": sq, "norms": np.sqrt(sq), "valid": valid}
    if int8:
        arrs["scales"] = scales
    js = {k: jnp.asarray(v) for k, v in arrs.items()}
    ts = {k: torch.from_numpy(v) for k, v in arrs.items()}
    if int8:
        js["elo_max"], ts["elo_max"] = jnp.float32(0.0), torch.tensor(0.0)
    else:
        js["elo_max"] = jck.residual_max_norm_f32(js["db"])
        ts["elo_max"] = tck.residual_max_norm_f32(ts["db"])
    return js, ts


def _args(s):
    return (s["db"], s["sq_norms"], s["norms"], s["valid"])


def _assert_same(jout, tout, k, flags=True):
    assert np.array_equal(tout[1].numpy()[:, :k], np.asarray(jout[1])[:, :k])
    np.testing.assert_allclose(tout[0].numpy()[:, :k],
                               np.asarray(jout[0])[:, :k], rtol=2e-5,
                               atol=2e-5)
    if flags:
        assert np.array_equal(tout[2].numpy(), np.asarray(jout[2]))


@pytest.mark.parametrize("src", ["f32", "int8"])
@pytest.mark.parametrize("metric", METRICS)
def test_coarse_search_1p_sources_match_jax(metric, src):
    db, valid, queries = _data(6, 4096, 32, 8)
    js, ts = _pipeline_states(db, valid, int8=src == "int8")
    kw_j = {"scales": js["scales"]} if src == "int8" else {}
    kw_t = {"scales": ts["scales"]} if src == "int8" else {}
    jout = jck.coarse_search_1p(jnp.asarray(queries), *_args(js), None,
                                js["elo_max"], J.DistanceMetric(metric), 10,
                                **kw_j)
    tout = tck.coarse_search_1p(torch.from_numpy(queries), *_args(ts), None,
                                ts["elo_max"], T.DistanceMetric(metric), 10,
                                **kw_t)
    _assert_same(jout, tout, 10)
    assert tout[2].all()


@pytest.mark.parametrize("metric", METRICS)
def test_coarse_search_1p_fast_f32_source_matches_jax(metric):
    db, valid, queries = _data(7, 2048, 32, 8)
    js, ts = _pipeline_states(db, valid)
    jout = jck.coarse_search_1p_fast(jnp.asarray(queries), *_args(js), None,
                                     J.DistanceMetric(metric), 10)
    tout = tck.coarse_search_1p_fast(torch.from_numpy(queries), *_args(ts),
                                     None, T.DistanceMetric(metric), 10)
    _assert_same(jout, tout, 10, flags=False)


def test_fast_refuses_int8_codes_in_either():
    db, valid, queries = _data(7, 1024, 32, 2)
    js, ts = _pipeline_states(db, valid, int8=True)
    with pytest.raises(ValueError, match="int8"):
        jck.coarse_search_1p_fast(jnp.asarray(queries), *_args(js), None,
                                  J.DistanceMetric.EUCLIDEAN, 5)
    with pytest.raises(ValueError, match="int8"):
        tck.coarse_search_1p_fast(torch.from_numpy(queries), *_args(ts),
                                  None, T.DistanceMetric.EUCLIDEAN, 5)


@pytest.mark.parametrize("metric", METRICS)
def test_bf16x3_f32_source_matches_jax(metric):
    db, valid, queries = _data(8, 1024, 32, 8)
    js, ts = _pipeline_states(db, valid)
    jout = jck.coarse_search(jnp.asarray(queries), *_args(js), None, None,
                             J.DistanceMetric(metric), 5, exact=True)
    tout = tck.coarse_search(torch.from_numpy(queries), *_args(ts), None,
                             None, T.DistanceMetric(metric), 5, exact=True)
    _assert_same(jout, tout, 5)
    assert tout[2].all()


def _recall(ids, want, k):
    return np.mean([len(set(a[:k]) & set(b[:k])) / k
                    for a, b in zip(ids, want)])


@pytest.mark.parametrize("src", ["mirrors", "f32"])
@pytest.mark.parametrize("metric", METRICS)
def test_legacy_fast_recall_no_lower_than_jax(metric, src):
    """coarse_search(exact=False): K6 over the mirror or K5 at one pass.
    JAX selects tiles with approx_min_k, the port exactly: the port's
    recall against the exact answer is no lower, and its distances are
    exact over its own pool."""
    k = 10
    db, valid, queries = _data(9, 2048, 32, 16)
    js, ts = _pipeline_states(db, valid)
    if src == "mirrors":
        jhl, thl = jck.split_hi_lo(js["db"]), tck.split_hi_lo(ts["db"])
    else:
        jhl, thl = (None, None), (None, None)
    jout = jck.coarse_search(jnp.asarray(queries), *_args(js), *jhl,
                             J.DistanceMetric(metric), k, exact=False)
    tout = tck.coarse_search(torch.from_numpy(queries), *_args(ts), *thl,
                             T.DistanceMetric(metric), k, exact=False)
    want_d, want_i = ttopk.flat_search(
        torch.from_numpy(queries), *_args(ts), T.DistanceMetric(metric), k)
    want_i = want_i.numpy()
    assert _recall(tout[1].numpy(), want_i, k) >= \
        _recall(np.asarray(jout[1]), want_i, k)
    assert not tout[2].any()
    hit = tout[1].numpy() == want_i
    np.testing.assert_allclose(tout[0].numpy()[hit], want_d.numpy()[hit],
                               rtol=2e-5, atol=2e-5)


def test_bf16x3_refuses_a_missing_lo_mirror():
    db, valid, queries = _data(10, 1024, 32, 2)
    _, ts = _pipeline_states(db, valid)
    hi = ts["db"].to(torch.bfloat16)
    with pytest.raises(ValueError, match="lo mirror"):
        tck.coarse_search(torch.from_numpy(queries), hi, *_args(ts)[1:], hi,
                          None, T.DistanceMetric.EUCLIDEAN, 5, exact=True)


def test_dispatch_src_ladder():
    f32 = torch.zeros((256, 8))
    b16 = f32.to(torch.bfloat16)
    i8 = torch.zeros((256, 8), dtype=torch.int8)
    sc = torch.ones(256)
    assert tck._dispatch_src(i8, None, sc) == ("int8", i8)
    assert tck._dispatch_src(b16, b16, None) == ("mirrors", b16)
    assert tck._dispatch_src(f32, b16, None) == ("mirrors", b16)
    assert tck._dispatch_src(f32, None, None) == ("f32", f32)
    for bad in ((f32, None, sc), (i8, None, None)):
        with pytest.raises(ValueError):
            tck._dispatch_src(*bad)
    assert tck.supports_1p_int8(4096, 768, 10) == tck.supports_1p(4096, 768,
                                                                  10)


# ---------------------------------------------------------------------------
# whole stores carried across from the JAX package
# ---------------------------------------------------------------------------

STORES = ["bf16", "int8", "f32_past_gate"]


@pytest.fixture
def gate(monkeypatch):
    """Lowered mirror gates: every f32 store keeps its rows alone."""
    monkeypatch.setattr(jflat, "_PALLAS_MEM_LIMIT", 1000)
    monkeypatch.setattr(tflat, "_MIRROR_MEM_LIMIT", 1000)


def _pair(metric, storage, seed=0, search_mode="exact"):
    """(jax store, port store, rng): N rows, 10% deleted, carried across
    by the exported packed arrays."""
    storage = storage.replace("_past_gate", "")
    rng = np.random.default_rng(seed)
    rows = rng.standard_normal((N, D)).astype(np.float32)
    js = J.VectorStore.with_flat_index(J.DistanceMetric(metric),
                                       search_mode=search_mode,
                                       storage=storage)
    js.insert_batch([J.BatchInsertItem(str(i), J.Vector(rows[i]))
                     for i in range(N)])
    for i in rng.choice(N, N // 10, replace=False):
        js.delete(str(i))
    vecs, valid, ids = js.index.packed_arrays()
    ts = store_from_reference(vecs, valid, ids, js.internal_to_string_ids(),
                              T.DistanceMetric(metric), device="cpu",
                              search_mode=search_mode, storage=storage)
    return js, ts, rng


def _queries(rng, q=8):
    return rng.standard_normal((q, D)).astype(np.float32)


def _same(jres, tres):
    assert [[r.id for r in row] for row in tres] == \
        [[r.id for r in row] for row in jres]
    jd = np.array([r.distance for row in jres for r in row])
    td = np.array([r.distance for row in tres for r in row])
    np.testing.assert_allclose(td, jd, rtol=2e-5, atol=2e-5)


def _batch(s, qs, k, mod):
    return s.search_batch([(mod.Vector(q), k) for q in qs])


def _state(ts):
    with ts.index._lock:
        return dict(ts.index._sync_device())


@pytest.mark.usefixtures("gate")
@pytest.mark.parametrize("storage", STORES)
@pytest.mark.parametrize("metric", METRICS)
def test_stores_answer_like_the_jax_ones(metric, storage):
    js, ts, rng = _pair(metric, storage)
    qs = _queries(rng)
    _same(_batch(js, qs, 10, J), _batch(ts, qs, 10, T))
    jdev, tdev = js.index._sync_device(), _state(ts)
    assert sorted(k for k in tdev if k != "scales") == \
        sorted(k for k in jdev if k != "scales")
    assert float(tdev["elo_max"]) == pytest.approx(float(jdev["elo_max"]),
                                                   rel=1e-6)


@pytest.mark.usefixtures("gate")
@pytest.mark.parametrize("storage", STORES)
def test_stored_values_and_device_state(storage):
    js, ts, _ = _pair("euclidean", storage, seed=1)
    jv, jvalid, _ = js.index.packed_arrays()
    tv, tvalid, _ = ts.index.packed_arrays()
    assert tv.dtype == np.float32 and np.array_equal(tvalid, jvalid)
    assert np.array_equal(tv[tvalid], np.asarray(jv, np.float32)[jvalid])
    sid = next(iter(ts.list_ids()))
    np.testing.assert_array_equal(ts.get(sid).as_array(),
                                  js.get(sid).as_array())
    tdev = _state(ts)
    if storage == "bf16":
        assert tdev["db"].dtype == torch.bfloat16 and tdev["hi"] is tdev["db"]
        assert ts.index._vectors.dtype == np.uint16     # 2-byte host rows
    elif storage == "int8":
        assert tdev["db"].dtype == torch.int8
        # live rows (the port zeroes dead slots it adopts)
        codes, scales = jflat._int8_codes_scales(np.asarray(jv, np.float32))
        assert np.array_equal(tdev["db"].numpy()[jvalid], codes[jvalid])
        assert np.array_equal(tdev["scales"].numpy()[jvalid], scales[jvalid])
    else:
        assert tdev["coarse_f32"] and "hi" not in tdev


@pytest.mark.usefixtures("gate")
@pytest.mark.parametrize("storage", STORES)
def test_insert_quantizes_and_norms_see_stored_values(storage):
    rng = np.random.default_rng(2)
    v = rng.standard_normal(16).astype(np.float32)
    kind = storage.replace("_past_gate", "")
    ji = jflat.FlatIndex(J.DistanceMetric.EUCLIDEAN, storage=kind)
    ti = tflat.FlatIndex(T.DistanceMetric.EUCLIDEAN, storage=kind,
                         device="cpu")
    for idx, mod in ((ji, J), (ti, T)):
        idx.add(7, mod.Vector(v))
        idx.add_batch([(8, mod.Vector(v * 3)), (9, mod.Vector(-v))])
    for iid in (7, 8, 9):
        got = np.asarray(ti.get_vector(iid).as_array())
        np.testing.assert_array_equal(got, ji.get_vector(iid).as_array())
    if kind != "f32":
        assert not np.array_equal(ti.get_vector(7).as_array(), v)
    assert np.array_equal(ti._sq_norms[:3], ji._sq_norms[:3])
    assert [i for i, _ in ti.iter_items()] == [i for i, _ in ji.iter_items()]


@pytest.mark.usefixtures("gate")
@pytest.mark.parametrize("storage", STORES)
@pytest.mark.parametrize("metric", METRICS)
def test_writes_after_the_device_build_keep_answers_equal(metric, storage):
    """The dirty-scatter paths: bf16 keeps db and hi one buffer, int8
    patches codes and scales, coarse_f32 raises its residual bound."""
    js, ts, rng = _pair(metric, storage, seed=3)
    qs = _queries(rng)
    _batch(ts, qs, 5, T)            # device state built; writes now scatter
    _batch(js, qs, 5, J)
    fresh = rng.standard_normal((30, D)).astype(np.float32) * 4.0
    for s, mod in ((js, J), (ts, T)):
        for j in range(10):         # upserts of live ids: fresh internal ids
            s.insert(str(N - 1 - 3 * j), mod.Vector(fresh[j]))
        for j in range(10):
            if s.get(str(j * 7 + 1)) is not None:
                s.delete(str(j * 7 + 1))
        s.insert_batch([mod.BatchInsertItem(f"n{j}", mod.Vector(fresh[j]))
                        for j in range(10, 30)])
    assert len(ts) == len(js)
    _same(_batch(js, qs, 10, J), _batch(ts, qs, 10, T))
    near = fresh[10:14] + rng.standard_normal((4, D)).astype(np.float32)
    _same(_batch(js, near, 3, J), _batch(ts, near, 3, T))
    tdev, jdev = _state(ts), js.index._sync_device()
    if storage == "bf16":
        assert tdev["hi"] is tdev["db"]
    elif storage == "int8":
        vecs = ts.index._vectors
        codes, scales = jflat._int8_codes_scales(vecs)
        assert np.array_equal(tdev["db"].numpy(), codes)
        assert np.array_equal(tdev["scales"].numpy(), scales)
    assert float(tdev["elo_max"]) == pytest.approx(float(jdev["elo_max"]),
                                                   rel=1e-6)


@pytest.mark.usefixtures("gate")
@pytest.mark.parametrize("storage", STORES)
@pytest.mark.parametrize("metric", METRICS)
def test_fast_mode_matches(metric, storage):
    """bf16 and int8 serve fast as exact (tier 1 is already one pass);
    the f32-source store runs K4 without the certificate."""
    js, ts, rng = _pair(metric, storage, seed=4, search_mode="fast")
    qs = _queries(rng)
    _same(_batch(js, qs, 10, J), _batch(ts, qs, 10, T))


class _Spy:
    """Records the calls of module functions the ladder reaches."""

    def __init__(self, monkeypatch):
        self.calls = []
        self._mp = monkeypatch

    def wrap(self, mod, name):
        real = getattr(mod, name)

        def spy(*args, **kwargs):
            self.calls.append((name, args, kwargs))
            return real(*args, **kwargs)
        self._mp.setattr(mod, name, spy)

    def names(self):
        return [c[0] for c in self.calls]


@pytest.mark.usefixtures("gate")
@pytest.mark.parametrize("storage, tiers", [
    ("bf16", ["coarse_search_1p", "flat_search_bf16"]),
    ("int8", ["coarse_search_1p", "flat_search_int8"]),
    ("f32_past_gate", ["coarse_search_1p", "coarse_search",
                       "flat_search_exact_tiled"])])
def test_forced_fallback_walks_the_tiers_and_stays_exact(storage, tiers,
                                                         monkeypatch):
    """An inflated elo_max certifies nothing in tier 1: bf16 reaches the
    widening scan (never bf16x3), int8 the dequantizing scan, and the
    f32-source store K5 at 3 passes, then the plain scan for whatever
    tier 2 leaves. Each answer equals the JAX store's."""
    js, ts, rng = _pair("euclidean", storage, seed=5)
    qs = _queries(rng)
    want = _batch(js, qs, 5, J)
    state = _state(ts)
    state["elo_max"] = torch.tensor(1e9)
    spy = _Spy(monkeypatch)
    for name in ("coarse_search_1p", "coarse_search"):
        spy.wrap(tck, name)
    for name in ("flat_search_bf16", "flat_search_int8",
                 "flat_search_exact_tiled"):
        spy.wrap(ttopk, name)
    spy.wrap(tck, "_coarse_minima_f32")
    got_d, got_i = ttopk.flat_search_batched(qs, state,
                                             T.DistanceMetric.EUCLIDEAN, 5)
    names = [n for n in spy.names() if n != "_coarse_minima_f32"]
    assert names[:2] == tiers[:2] and set(names) <= set(tiers)
    if storage == "f32_past_gate":
        k5 = [c for c in spy.calls if c[0] == "_coarse_minima_f32"]
        assert k5 and k5[0][1][6] == 3          # K5 at 3 passes
    ids = ts.internal_to_string_ids()
    assert [[ids[int(i)] for i in row] for row in got_i] == \
        [[r.id for r in row] for row in want]
    np.testing.assert_allclose(got_d, [[r.distance for r in row]
                                       for row in want], rtol=2e-5,
                               atol=2e-5)


def test_bf16_never_runs_bf16x3(monkeypatch):
    """Tier 1 is bf16 storage's exact path at any capacity; with it off
    the shape (a 256-row state) the widening scan serves, never
    coarse_search (lo = hi would double-count hi.qhi)."""
    rng = np.random.default_rng(6)
    ts = T.VectorStore.with_flat_index(T.DistanceMetric.EUCLIDEAN,
                                       storage="bf16", device="cpu")
    ts.insert_batch([T.BatchInsertItem(str(i), T.Vector(r)) for i, r in
                     enumerate(rng.standard_normal((300, D), np.float32))])
    monkeypatch.setattr(ttopk, "_EXACT1P_MIN_N", 1 << 30)
    spy = _Spy(monkeypatch)
    spy.wrap(tck, "coarse_search")
    spy.wrap(tck, "coarse_search_1p")
    spy.wrap(ttopk, "flat_search_bf16")
    state = _state(ts)
    qs = _queries(rng, 4)
    ttopk.flat_search_batched(qs, state, T.DistanceMetric.EUCLIDEAN, 5)
    assert spy.names() == ["coarse_search_1p"]
    small = {k: (v[:256] if torch.is_tensor(v) and v.dim() else v)
             for k, v in state.items()}
    small["hi"] = small["db"]
    d_, i_ = ttopk.flat_search_batched(qs, small, T.DistanceMetric.EUCLIDEAN,
                                       5, mode="fast")
    assert spy.names() == ["coarse_search_1p", "flat_search_bf16"]
    want = ttopk.flat_search(torch.from_numpy(qs), small["db"].float(),
                             small["sq_norms"], small["norms"],
                             small["valid"], T.DistanceMetric.EUCLIDEAN, 5)
    assert np.array_equal(i_, want[1].numpy())


@pytest.mark.parametrize("src", ["mirrors", "f32"])
def test_legacy_fast_serves_a_256_row_state(src, monkeypatch):
    """mode="fast" where supports() holds and supports_1p() does not (one
    super-tile): the single-pass coarse_search(exact=False)."""
    rng = np.random.default_rng(7)
    db = torch.from_numpy(rng.standard_normal((256, D), np.float32))
    sq = (db * db).sum(1)
    state = {"db": db, "sq_norms": sq, "norms": torch.sqrt(sq),
             "valid": torch.ones(256, dtype=torch.bool)}
    if src == "mirrors":
        state["hi"], state["lo"] = tck.split_hi_lo(db)
        state["elo_max"] = tck.residual_max_norm(db, state["hi"])
    else:
        state["coarse_f32"] = True
        state["elo_max"] = tck.residual_max_norm_f32(db)
    spy = _Spy(monkeypatch)
    spy.wrap(tck, "coarse_search")
    spy.wrap(tck, "_coarse_minima_1p")
    spy.wrap(tck, "_coarse_minima_f32")
    qs = _queries(rng, 4)
    d_, i_ = ttopk.flat_search_batched(qs, state, T.DistanceMetric.EUCLIDEAN,
                                       5, mode="fast")
    assert spy.calls[0][0] == "coarse_search"
    assert spy.calls[0][2] == {"exact": False}
    kern = "_coarse_minima_1p" if src == "mirrors" else "_coarse_minima_f32"
    assert spy.names()[1] == kern
    want = ttopk.flat_search(torch.from_numpy(qs), db, sq, torch.sqrt(sq),
                             state["valid"], T.DistanceMetric.EUCLIDEAN, 5)
    assert np.array_equal(i_, want[1].numpy())


def test_store_from_reference_reads_bf16_bits():
    """A JAX bf16 store's packed rows are ml_dtypes bfloat16; the port
    reads their bits (and the same rows as np.uint16 or f32 values)."""
    rows = np.random.default_rng(8).standard_normal((1024, 8),
                                                    np.float32)
    b16 = rows.astype(ml_dtypes.bfloat16)
    valid = np.ones(1024, bool)
    ids = np.arange(1024)
    for given in (b16, b16.view(np.uint16), b16.astype(np.float32)):
        idx = tflat.FlatIndex(T.DistanceMetric.EUCLIDEAN, storage="bf16",
                              device="cpu")
        idx.adopt_packed(given, valid, ids)
        assert np.array_equal(idx._vectors, b16.view(np.uint16))
        assert np.array_equal(idx.packed_arrays()[0],
                              b16.astype(np.float32))
