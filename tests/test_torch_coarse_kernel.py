"""ops/coarse_kernel.py of the port against the JAX package's.

The same numpy inputs go through the JAX function (Pallas in interpret
mode, as tests/test_coarse_kernel.py runs it) and through the port (the
plain PyTorch versions of K1, K2, K3 on CPU tensors). Kernel outputs agree
within a summation-order bound: bf16 x bf16 products are exact in f32, so
two f32 sums of the same d products differ by at most 2*d*2^-24*sum|a b|
(the bound below doubles that once more for slack). The data is
continuous random, so top-k has no ties.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vectordb_tpu.distance import DistanceMetric as JMetric
from vectordb_tpu.ops import coarse_kernel as jck
from vectordb_tpu_torch.distance import DistanceMetric
from vectordb_tpu_torch.ops import coarse_kernel as tck

# One intra-op thread: these tests are small, and an OpenMP pool left
# behind in a pytest worker perturbs the thread timing of tests that
# share it (the parallel native HNSW build in tests/test_recall.py).
torch.set_num_threads(1)

MODES = {"euclidean": "euclidean", "dot_product": "dot", "cosine": "cosine"}


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("VDB_TPU_PALLAS_INTERPRET", "1")


def _data(seed, n, d, q, dead=0.1, scale=1.0):
    rng = np.random.default_rng(seed)
    db = (rng.standard_normal((n, d)) * scale).astype(np.float32)
    valid = np.ones(n, bool)
    valid[rng.choice(n, int(n * dead), replace=False)] = False
    queries = rng.standard_normal((q, d)).astype(np.float32)
    return db, valid, queries


def _states(db, valid):
    """(jax state, torch state) of the same rows, mirrors and elo_max."""
    sq = np.einsum("ij,ij->i", db, db).astype(np.float32)
    norms = np.sqrt(sq)
    jdb = jnp.asarray(db)
    jhi, jlo = jck.split_hi_lo(jdb)
    js = {"db": jdb, "sq_norms": jnp.asarray(sq), "norms": jnp.asarray(norms),
          "valid": jnp.asarray(valid), "hi": jhi, "lo": jlo,
          "elo_max": jck.residual_max_norm(jdb, jhi)}
    tdb = torch.from_numpy(db)
    thi, tlo = tck.split_hi_lo(tdb)
    ts = {"db": tdb, "sq_norms": torch.from_numpy(sq),
          "norms": torch.from_numpy(norms), "valid": torch.from_numpy(valid),
          "hi": thi, "lo": tlo, "elo_max": tck.residual_max_norm(tdb, thi)}
    return js, ts


def _bound(mode, d, db, queries, passes=1):
    xmax = float(np.linalg.norm(db, axis=1).max())
    qmax = float(np.linalg.norm(queries, axis=1).max())
    dot_b = passes * d * 2.0 ** -22 * xmax * qmax
    return {"euclidean": 2 * dot_b + 2.0 ** -22 * (xmax ** 2 + qmax ** 2),
            "dot": dot_b, "cosine": passes * d * 2.0 ** -22 * 1.01}[mode]


def _operands(ts, queries, mode):
    return tck._query_terms(torch.from_numpy(queries), ts["sq_norms"],
                            ts["norms"], ts["valid"], mode)


def _live_close(got, want, bound):
    live = want < 1e29          # a fully dead tile holds ~PENALTY
    assert np.array_equal(live, got < 1e29)
    assert np.abs(got[live] - want[live]).max() <= bound


def test_split_hi_lo_bitwise_and_elo_max():
    db, valid, _ = _data(0, 1024, 64, 1)
    db[:4] *= 1e-3                    # small and large magnitudes
    db[4:8] *= 1e4
    js, ts = _states(db, valid)
    for key in ("hi", "lo"):
        want = np.asarray(js[key]).view(np.uint16)
        got = ts[key].view(torch.int16).numpy().view(np.uint16)
        assert np.array_equal(got, want), key
    np.testing.assert_allclose(float(ts["elo_max"]), float(js["elo_max"]),
                               rtol=1e-6)
    np.testing.assert_allclose(
        float(tck.residual_max_norm_f32(ts["db"][:100])),
        float(jck.residual_max_norm_f32(js["db"][:100])), rtol=1e-6)


@pytest.mark.parametrize("metric", list(MODES))
def test_plain_k1_matches_minima_1p_sup(metric):
    mode = MODES[metric]
    db, valid, queries = _data(1, 1024, 32, 8)
    js, ts = _states(db, valid)
    qThi, _, _, _, qrow, col, inv_col = _operands(ts, queries, mode)
    tile_t, sup_t = tck._minima_1p_sup(qThi, qrow, ts["hi"], col, inv_col,
                                       mode)
    tile_j, sup_j = jck._minima_1p_sup(
        jnp.asarray(qThi.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(qrow.numpy()), js["hi"], jnp.asarray(col.numpy()),
        jnp.asarray(inv_col.numpy()), mode, True, "mirrors")
    assert tile_t.shape == (1024 // 16, 8) and sup_t.shape == (4, 8)
    bound = _bound(mode, 32, db, queries)
    _live_close(tile_t.numpy(), np.asarray(tile_j), bound)
    _live_close(sup_t.numpy(), np.asarray(sup_j), bound)


@pytest.mark.parametrize("passes", [3, 1])
@pytest.mark.parametrize("metric", list(MODES))
def test_plain_k3_matches_coarse_minima(metric, passes):
    mode = MODES[metric]
    db, valid, queries = _data(2, 1024, 32, 8)
    js, ts = _states(db, valid)
    qThi, qlo, _, _, qrow, col, inv_col = _operands(ts, queries, mode)
    qTlo = qlo.to(torch.bfloat16)
    got = tck._coarse_minima(qThi, qTlo, qrow, ts["hi"], ts["lo"], col,
                             inv_col, passes, mode)
    jq = lambda t: jnp.asarray(t.float().numpy())  # noqa: E731
    want = jck._coarse_minima(
        jq(qThi).astype(jnp.bfloat16), jq(qTlo).astype(jnp.bfloat16),
        jq(qrow), js["hi"], js["lo"], jq(col), jq(inv_col), passes=passes,
        mode=mode, interpret=True)
    assert got.shape == (8, 1024 // 16)
    _live_close(got.numpy(), np.asarray(want),
                _bound(mode, 32, db, queries, passes))


def test_plain_k2_matches_refine_dots():
    # interpret-mode _refine_dots is slow: keep m <= 4, q = 8 (d % 128 == 0
    # is the JAX kernel's own gate)
    n, d, q, m = 1024, 128, 8, 4
    db, _, queries = _data(3, n, d, q)
    rng = np.random.default_rng(30)
    tile_idx = rng.integers(0, n // 16, (q, m))
    got = tck._refine_dots(torch.from_numpy(tile_idx),
                           torch.from_numpy(queries), torch.from_numpy(db), m)
    want = jck._refine_dots(jnp.asarray(tile_idx, jnp.int32),
                            jnp.asarray(queries), jnp.asarray(db), m, True)
    bound = d * 2.0 ** -22 * float(np.linalg.norm(db, axis=1).max()) \
        * float(np.linalg.norm(queries, axis=1).max())
    assert got.shape == (q, m * 16)
    assert np.abs(got.numpy() - np.asarray(want)).max() <= bound


def test_selection_index_order_matches_jax_advanced_indexing():
    """sup3_tq[ss_idx, :, arange(qp)[:, None]] (numpy rule for separated
    advanced indices) is (Qp, m3, SUPER2); the port's permuted gather must
    give the same array."""
    rng = np.random.default_rng(6)
    t3, qp, m3 = 5, 7, 3
    sup3 = rng.standard_normal((t3, tck.SUPER2, qp)).astype(np.float32)
    ss_idx = rng.integers(0, t3, (qp, m3))
    want = np.asarray(jnp.asarray(sup3)[jnp.asarray(ss_idx), :,
                                        jnp.arange(qp)[:, None]])
    ar = torch.arange(qp)[:, None]
    got = torch.from_numpy(sup3).permute(2, 0, 1)[ar, torch.from_numpy(
        ss_idx)]
    assert want.shape == (qp, m3, tck.SUPER2)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("t_all", [64, 512])
def test_select_tiles_1p_picks_the_true_best_tiles(t_all):
    """With the certified pool (m2 >= min(m, supers), so containment
    holds), both selection shapes (2-level at 64 tiles, 3-level at 512)
    return exactly the m smallest tile minima on tie-free data, with a
    boundary no larger than any unselected tile minimum."""
    rng = np.random.default_rng(7)
    qp = 4
    m2, m = tck._exact1p_pool(10, t_all)
    tile_tq = torch.from_numpy(
        rng.standard_normal((t_all, qp)).astype(np.float32))
    sup_tq = tile_tq.reshape(-1, tck.SUPER, qp).amin(dim=1)
    tile_idx, b = tck._select_tiles_1p(tile_tq, sup_tq, qp, t_all, m2, m)
    for qi in range(qp):
        col = tile_tq[:, qi].numpy()
        want = set(np.argsort(col)[:m].tolist())
        assert set(tile_idx[qi].tolist()) == want
        rest = np.delete(col, list(want))
        if rest.size:
            assert float(b[qi]) <= rest.min()


def _search_both(fn_name, metric, js, ts, queries, k, **kw):
    jout = getattr(jck, fn_name)(
        jnp.asarray(queries), js["db"], js["sq_norms"], js["norms"],
        js["valid"], js["hi"], *kw.get("jextra", ()), JMetric(metric), k,
        **kw.get("jkw", {}))
    tout = getattr(tck, fn_name)(
        torch.from_numpy(queries), ts["db"], ts["sq_norms"], ts["norms"],
        ts["valid"], ts["hi"], *kw.get("textra", ()), DistanceMetric(metric),
        k)
    return [np.asarray(a) for a in jout], [t.numpy() for t in tout]


def _assert_same_results(jout, tout, k):
    assert np.array_equal(tout[1][:, :k], jout[1][:, :k])
    np.testing.assert_allclose(tout[0][:, :k], jout[0][:, :k], rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("metric", list(MODES))
def test_coarse_search_1p_matches_jax(metric):
    db, valid, queries = _data(8, 2048, 32, 8)
    js, ts = _states(db, valid)
    jout, tout = _search_both("coarse_search_1p", metric, js, ts, queries, 5,
                              jextra=(js["elo_max"],),
                              textra=(ts["elo_max"],))
    _assert_same_results(jout, tout, 5)
    assert np.array_equal(tout[2], jout[2])
    assert tout[2].all()


def test_coarse_search_1p_three_level_selection_matches_jax():
    """8192 rows = 32 super-tiles: the third selection level engages."""
    db, valid, queries = _data(9, 8192, 32, 8)
    js, ts = _states(db, valid)
    jout, tout = _search_both("coarse_search_1p", "euclidean", js, ts,
                              queries, 10, jextra=(js["elo_max"],),
                              textra=(ts["elo_max"],))
    _assert_same_results(jout, tout, 10)
    assert np.array_equal(tout[2], jout[2])


@pytest.mark.parametrize("metric", list(MODES))
def test_coarse_search_1p_fast_matches_jax(metric):
    db, valid, queries = _data(10, 2048, 32, 8)
    js, ts = _states(db, valid)
    jout, tout = _search_both("coarse_search_1p_fast", metric, js, ts,
                              queries, 10)
    _assert_same_results(jout, tout, 10)


@pytest.mark.parametrize("metric", list(MODES))
def test_bf16x3_certificate_matches_jax(metric):
    db, valid, queries = _data(11, 1024, 32, 8)
    js, ts = _states(db, valid)
    jout, tout = _search_both("coarse_search", metric, js, ts, queries, 5,
                              jextra=(js["lo"],), textra=(ts["lo"],),
                              jkw={"exact": True})
    _assert_same_results(jout, tout, 5)
    assert np.array_equal(tout[2], jout[2])
    assert tout[2].all()


def test_huge_elo_max_certifies_nothing_in_either():
    db, valid, queries = _data(12, 1024, 32, 8)
    js, ts = _states(db, valid)
    jout, tout = _search_both("coarse_search_1p", "euclidean", js, ts,
                              queries, 5, jextra=(jnp.float32(1e9),),
                              textra=(torch.tensor(1e9),))
    assert not jout[2].any() and not tout[2].any()


@pytest.mark.parametrize("fn, extra", [("coarse_search_1p", "elo_max"),
                                       ("coarse_search", "lo")])
def test_extreme_magnitudes_are_refused_in_either(fn, extra):
    """|score| near PENALTY/4 makes the additive dead-row masking unsound:
    both certificates must refuse (the caller falls back)."""
    db, valid, queries = _data(13, 1024, 32, 8, scale=1e15)
    js, ts = _states(db, valid)
    jkw = {"exact": True} if fn == "coarse_search" else {}
    jout, tout = _search_both(fn, "euclidean", js, ts, queries, 5,
                              jextra=(js[extra],), textra=(ts[extra],),
                              jkw=jkw)
    assert not jout[2].any() and not tout[2].any()


def test_accumulation_coefficient_is_jax_on_cpu():
    """The plain versions round to nearest: the JAX coefficient holds on
    the CPU (results of the CUDA bodies take their own coefficient)."""
    rows = torch.zeros((256, 8), dtype=torch.bfloat16)
    assert tck._coarse_body("mirrors", rows, 1, True) == "plain"
    assert tck._accum_coeff(tck._coarse_body("mirrors", rows, 1, True)) == 1.0


def test_pools_match_jax():
    for k in (1, 5, 10, 64, 100, 256):
        for t_all in (64, 4096, 65536):
            assert tck._exact1p_pool(k, t_all) == jck._exact1p_pool(k, t_all)
            assert tck._fast1p_pool(k, t_all) == jck._fast1p_pool(k, t_all)
