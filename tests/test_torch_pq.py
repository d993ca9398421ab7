"""PQ-Flat in the port against the JAX package, on the CPU.

The same numpy inputs go through ``vectordb_tpu`` (its decode kernel in
Pallas interpret mode, as tests/test_pq_ops.py runs it) and through
``vectordb_tpu_torch`` on ``device="cpu"`` (the plain version of kernel
K8):

  * pack_codebook, the OPQ rotation and the decode, bit for bit; encode,
    equal on continuous data;
  * the scan's candidate pools (slots equal, scores at rtol 1e-5) and both
    re-rank ops, for all three metrics;
  * whole indexes loaded with the same rows, the JAX index's trained state
    and its codes: same ids, distances at rtol 2e-5, through filters,
    writes, fallbacks and both re-rank venues.
Codebooks cannot match (jax.random and torch.Generator are different
streams), so the port's own training is held to the JAX test's distortion
bound instead. The data is continuous random: no ties at the k-th
distance or the pool boundary.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import vectordb_tpu as J
from vectordb_tpu.index.pq import PqFlatIndex as JPq
from vectordb_tpu.ops import pq as jpq

import vectordb_tpu_torch as T
from vectordb_tpu_torch.convert import pq_store_from_reference
from vectordb_tpu_torch.errors import IndexOpError, InvalidVectorError
from vectordb_tpu_torch.index import pq as tpqi
from vectordb_tpu_torch.index.pq import PqFlatIndex
from vectordb_tpu_torch.ops import pq as tpq

torch.set_num_threads(1)

METRICS = ["euclidean", "dot_product", "cosine"]


def _tm(name):
    return T.DistanceMetric(name)


def _jm(name):
    return J.DistanceMetric(name)


def _bf16_values(x):
    return np.asarray(jnp.asarray(x).astype(jnp.bfloat16)
                      .astype(jnp.float32))


def _clustered(rng, n, d, n_centers=16, scale=0.15):
    centers = rng.standard_normal((n_centers, d)).astype(np.float32)
    which = rng.integers(0, n_centers, n)
    return (centers[which]
            + scale * rng.standard_normal((n, d)).astype(np.float32))


def _same_results(want, got, rtol=2e-5, ties=False):
    """Same ids and distances at ``rtol`` (atol 1e-6: cosine distances are
    1 - similarity, rounded relative to 1). With ``ties``, two ids may
    swap where their distances tie within the tolerance, and the last one
    may differ where it ties with the one it replaces (the venues sum in
    different orders)."""
    assert len(want) == len(got)
    for w, g in zip(want, got):
        wi, gi = [i for i, _ in w], [i for i, _ in g]
        wd = np.array([d for _, d in w])
        np.testing.assert_allclose([d for _, d in g], wd, rtol=rtol,
                                   atol=1e-6)
        if not ties:
            assert gi == wi
            continue
        tol = 2 * (rtol * np.abs(wd) + 1e-6)
        for j in np.nonzero(np.array(gi) != np.array(wi))[0]:
            tied = [jj for jj in (j - 1, j + 1) if 0 <= jj < len(wd)
                    and abs(wd[jj] - wd[j]) <= tol[j]]
            assert tied or j == len(wd) - 1, (j, wi, gi)
        assert set(gi[:-1]) <= set(wi)


# ---------------------------------------------------------------------------
# numpy pieces and the decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m, dsub, lane", [(8, 8, 32), (96, 8, 128),
                                           (6, 3, 128)])
def test_pack_codebook_matches_jax(m, dsub, lane):
    cb = np.random.default_rng(0).standard_normal(
        (m, 16, dsub)).astype(np.float32)
    bd_j, spg_j = jpq.pack_codebook(cb, lane=lane)
    bd_t, spg_t = tpq.pack_codebook(cb, lane=lane)
    assert spg_t == spg_j and np.array_equal(bd_t, bd_j)
    # the codewords sit on the diagonal blocks, zeros elsewhere
    g = m // spg_t
    blocks = bd_t.reshape(g, spg_t, 16, spg_t, dsub)
    for s in range(spg_t):
        assert np.array_equal(blocks[:, s, :, s, :],
                              cb.reshape(g, spg_t, 16, dsub)[:, s])
    assert np.count_nonzero(bd_t) == np.count_nonzero(cb)


def test_opq_rotation_matches_jax():
    rng = np.random.default_rng(1)
    basis = rng.standard_normal((8, 64)).astype(np.float32)
    x = (rng.standard_normal((70000, 8)).astype(np.float32) @ basis
         + 0.01 * rng.standard_normal((70000, 64)).astype(np.float32))
    r_j = jpq.fit_opq_rotation(x, m=8)
    r_t = tpq.fit_opq_rotation(x, m=8)
    assert r_t.dtype == np.float32 and np.array_equal(r_t, r_j)
    assert np.allclose(r_t.T @ r_t, np.eye(64), atol=1e-4)


@pytest.mark.parametrize("n, m, d", [(2048, 96, 768), (512, 16, 256)])
def test_plain_decode_bitwise_equals_jax(n, m, d):
    """Mirrors tests/test_pq_ops.py TestPallasDecode: the JAX kernel in
    interpret mode against the port's plain K8, bit for bit."""
    rng = np.random.default_rng(0)
    cb = _bf16_values(rng.standard_normal((m, 256, d // m)).astype(
        np.float32))
    bd, _ = jpq.pack_codebook(cb)
    codes = rng.integers(0, 256, (n, m), dtype=np.uint8)
    want = np.asarray(jpq.pq_decode_rows(
        jnp.asarray(codes), jnp.asarray(bd).astype(jnp.bfloat16),
        interpret=True).astype(jnp.float32))
    got = tpq.pq_decode_rows(torch.from_numpy(codes),
                             torch.tensor(cb).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16 and got.shape == (n, d)
    assert np.array_equal(got.float().numpy().view(np.uint32),
                          want.view(np.uint32))


@pytest.mark.parametrize("rows, m, dsub, ksub", [(1, 3, 5, 2), (77, 12, 1, 7),
                                                 (300, 4, 16, 256)])
def test_plain_decode_any_shape(rows, m, dsub, ksub):
    """Any row count, any dsub, any ksub <= 256: row i, subspace c is
    codeword codes[i, c]."""
    rng = np.random.default_rng(2)
    cb = torch.from_numpy(rng.standard_normal((m, ksub, dsub)).astype(
        np.float32)).to(torch.bfloat16)
    codes = rng.integers(0, ksub, (rows, m), dtype=np.uint8)
    got = tpq.pq_decode_rows(torch.from_numpy(codes), cb)
    want = np.concatenate([cb[c, codes[:, c].astype(np.int64)].float()
                           .numpy() for c in range(m)], axis=1)
    assert np.array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("rotate", [False, True])
def test_encode_matches_jax(rotate):
    rng = np.random.default_rng(3)
    m, dsub, ksub = 6, 4, 16
    cb = _bf16_values(rng.standard_normal((m, ksub, dsub)).astype(
        np.float32))
    rows = rng.standard_normal((512, m * dsub)).astype(np.float32)
    rot = tpq.fit_opq_rotation(rows, m) if rotate else None
    want = np.asarray(jpq.pq_encode(
        jnp.asarray(rows), jnp.asarray(cb), chunk=128,
        rot=None if rot is None else jnp.asarray(rot)))
    got = tpq.pq_encode(torch.from_numpy(rows), torch.tensor(cb), 128,
                        rot=None if rot is None else torch.from_numpy(rot))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# scan and re-rank ops
# ---------------------------------------------------------------------------

def _scan_inputs(seed, m=8, dsub=4, ksub=32, n=1024, q=16):
    rng = np.random.default_rng(seed)
    cb = _bf16_values(rng.standard_normal((m, ksub, dsub)).astype(
        np.float32))
    codes = rng.integers(0, ksub, (n, m), dtype=np.uint8)
    valid = rng.random(n) >= 0.1
    queries = rng.standard_normal((q, m * dsub)).astype(np.float32)
    bd, _ = jpq.pack_codebook(cb)
    cnorm = np.sum(cb * cb, axis=-1).astype(np.float32)
    return cb, codes, valid, queries, bd, cnorm


def _cb_bf(cb):
    return torch.tensor(cb).to(torch.bfloat16)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("rotate", [False, True])
def test_scan_pools_match_jax(metric, rotate):
    cb, codes, valid, queries, bd, cnorm = _scan_inputs(4)
    rot = None
    if rotate:
        rot = np.linalg.qr(np.random.default_rng(5).standard_normal(
            (32, 32)))[0].astype(np.float32)
    js, jl = jpq.pq_scan_topr(
        jnp.asarray(queries), jnp.asarray(codes), jnp.asarray(bd),
        jnp.asarray(cnorm), jnp.asarray(valid), _jm(metric), r=16,
        chunk=256, recall_target=0.95,
        rot=None if rot is None else jnp.asarray(rot))
    ts, tl = tpq.pq_scan_topr(
        torch.from_numpy(queries), torch.from_numpy(codes),
        _cb_bf(cb), torch.from_numpy(cnorm),
        torch.from_numpy(valid), _tm(metric), r=16, chunk=256,
        rot=None if rot is None else torch.from_numpy(rot))
    js, jl = np.asarray(js), np.asarray(jl)
    np.testing.assert_array_equal(tl.numpy(), jl)
    scale = float(np.abs(js).max())
    np.testing.assert_allclose(ts.numpy(), js, rtol=1e-5, atol=1e-6 * scale)
    assert np.all(np.diff(ts.numpy(), axis=1) >= 0)


def test_scan_respects_validity_and_short_sets():
    cb, codes, _, queries, bd, cnorm = _scan_inputs(6, n=128, q=5)
    valid = np.zeros(128, bool)
    valid[[3, 40, 100]] = True
    scores, slots = tpq.pq_scan_topr(
        torch.from_numpy(queries), torch.from_numpy(codes),
        _cb_bf(cb), torch.from_numpy(cnorm),
        torch.from_numpy(valid), _tm("euclidean"), r=8, chunk=32)
    for qi in range(5):
        finite = np.isfinite(scores[qi].numpy())
        assert finite.sum() == 3
        assert set(slots[qi].numpy()[finite]) == {3, 40, 100}


def test_scan_rejects_bad_shapes():
    cb = torch.zeros((2, 4, 2), dtype=torch.bfloat16)
    cnorm = torch.zeros((2, 4))
    qs = torch.zeros((2, 4))
    with pytest.raises(ValueError):
        tpq.pq_scan_topr(qs, torch.zeros((48, 2), dtype=torch.uint8), cb,
                         cnorm, torch.ones(48, dtype=torch.bool),
                         _tm("euclidean"), r=4, chunk=32)
    with pytest.raises(ValueError):
        tpq.pq_scan_topr(qs, torch.zeros((64, 2), dtype=torch.uint8), cb,
                         cnorm, torch.ones(64, dtype=torch.bool),
                         _tm("euclidean"), r=64, chunk=32)


def test_score_dots_come_out_in_f32():
    """The score GEMM of bf16 operands must return f32 (a bf16 result
    rounds the scores to 8 mantissa bits): the dots equal the f64 sums of
    the exact bf16 products to f32 rounding."""
    rng = np.random.default_rng(7)
    q = torch.from_numpy(rng.standard_normal((9, 64)).astype(np.float32))
    dec = torch.from_numpy(rng.standard_normal((40, 64)).astype(
        np.float32)).to(torch.bfloat16)
    q_hi, q_lo = tpq._split_query(q)
    dots = tpq._score_dots(q_hi, q_lo, dec)
    assert dots.dtype == torch.float32 and dots.shape == (9, 40)
    exact = (q_hi.double() + q_lo.double()) @ dec.double().T
    scale = float(exact.abs().max())
    assert float((dots.double() - exact).abs().max()) <= 2e-6 * scale
    # the bf16 rounding that the f32 output avoids is ~3 orders larger
    rounded = (q_hi @ dec.T).double()
    assert float((rounded - exact).abs().max()) > 1e-4 * scale


@pytest.mark.parametrize("metric", METRICS)
def test_rerank_topk_matches_jax(metric):
    rng = np.random.default_rng(8)
    cap, d, q, r, k = 256, 8, 40, 16, 5
    rows = rng.standard_normal((cap, d)).astype(np.float32) + 0.5
    slots = np.stack([rng.choice(cap, r, replace=False)
                      for _ in range(q)]).astype(np.int32)
    scores = np.zeros((q, r), np.float32)
    scores[:, -2:] = np.inf
    valid = np.ones(cap, bool)
    valid[slots[0, 0]] = False
    queries = rng.standard_normal((q, d)).astype(np.float32)
    jd, js = jpq.pq_rerank_topk(jnp.asarray(queries), jnp.asarray(rows),
                                jnp.asarray(slots), jnp.asarray(scores),
                                jnp.asarray(valid), _jm(metric), k)
    td, ts = tpq.pq_rerank_topk(
        torch.from_numpy(queries), torch.from_numpy(rows),
        torch.from_numpy(slots.astype(np.int64)), torch.from_numpy(scores),
        torch.from_numpy(valid), _tm(metric), k)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("metric", METRICS)
def test_rerank_gathered_matches_jax(metric):
    rng = np.random.default_rng(9)
    q, r, d, k = 12, 16, 8, 4
    rows = rng.standard_normal((q, r, d)).astype(np.float32) + 0.5
    ok = rng.random((q, r)) >= 0.2
    queries = rng.standard_normal((q, d)).astype(np.float32)
    jd, jp = jpq.pq_rerank_gathered(jnp.asarray(queries), jnp.asarray(rows),
                                    jnp.asarray(ok), _jm(metric), k)
    td, tp = tpq.pq_rerank_gathered(torch.from_numpy(queries),
                                    torch.from_numpy(rows),
                                    torch.from_numpy(ok), _tm(metric), k)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# the port's own training
# ---------------------------------------------------------------------------

def test_pq_fit_learns_clustered_subspaces():
    """tests/test_pq_ops.py's bound: rows are concatenations of 8
    codewords per subspace plus small noise; a correct fit recovers
    near-zero distortion. The codewords are bf16 values, and one seed
    gives one codebook."""
    rng = np.random.default_rng(7)
    m, dsub, ksub = 4, 4, 8
    words = rng.standard_normal((m, ksub, dsub)).astype(np.float32) * 3.0
    pick = rng.integers(0, ksub, size=(256, m))
    rows = np.concatenate(
        [words[j, pick[:, j]] for j in range(m)], axis=1).astype(np.float32)
    rows += 0.01 * rng.standard_normal(rows.shape).astype(np.float32)

    def fit(seed):
        gen = torch.Generator().manual_seed(seed)
        return tpq.pq_fit(torch.from_numpy(rows), gen, m=m, ksub=ksub,
                          iters=12, chunk=64)

    cb = fit(0)
    assert cb.shape == (m, ksub, dsub) and cb.dtype == torch.float32
    assert torch.equal(cb, cb.to(torch.bfloat16).float())
    assert torch.equal(cb, fit(0))
    codes = tpq.pq_encode(torch.from_numpy(rows), cb, 64).numpy()
    err = tpq.pq_distortion(rows, cb.numpy(), codes)
    base = float(np.mean(np.sum(
        (rows - rows.mean(0, keepdims=True)) ** 2, axis=1)))
    assert err < 0.02 * base
    assert tpq.pq_distortion(rows, cb.numpy(), codes) == jpq.pq_distortion(
        rows, cb.numpy(), codes)


def test_pq_fit_rejects_bad_chunk():
    with pytest.raises(ValueError):
        tpq.pq_fit(torch.zeros((100, 8)), torch.Generator(), m=2, ksub=4,
                   iters=2, chunk=64)


# ---------------------------------------------------------------------------
# whole indexes, JAX trained state and codes carried across
# ---------------------------------------------------------------------------

def _pair(metric, n=3000, d=32, m=8, ksub=32, refine=32, seed=0,
          rng_seed=10, scale=0.15, **kw):
    """(rows, JAX PqFlatIndex trained, port PqFlatIndex with the same
    slots, trained state and codes). Tests of single rows take a larger
    ``scale``: tight clusters share codes, and rows of one code tie in the
    scan, where the two packages break ties differently."""
    rng = np.random.default_rng(rng_seed)
    db = _clustered(rng, n, d, scale=scale)
    if metric == "cosine":
        db = db + 2.0          # norms away from zero
    j = JPq(_jm(metric), m=m, ksub=ksub, refine=refine, seed=seed, **kw)
    j.add_batch([(i, db[i]) for i in range(n)])
    j.train()
    j.search_batch(db[:1], 1)          # sync: the JAX codes exist now
    t = PqFlatIndex(_tm(metric), m=m, ksub=ksub, refine=refine, seed=seed,
                    device="cpu", **kw)
    t.adopt_packed(*j.packed_arrays())
    t.import_trained_state(j.export_trained_state())
    t.adopt_codes(np.asarray(j._codes))
    return db, j, t


@pytest.fixture(scope="module", params=METRICS)
def pair(request):
    return (request.param,) + _pair(request.param)


def test_index_matches_jax(pair):
    metric, db, j, t = pair
    rng = np.random.default_rng(11)
    queries = np.concatenate([db[:20] + 0.01, _clustered(rng, 20, 32)])
    if metric == "cosine":
        queries[20:] += 2.0
    want = j.search_batch(queries, 10)
    assert t._rerank_venue() == "host"
    _same_results(want, t.search_batch(queries, 10))
    _same_results(j.search_batch(queries, 10, refine=128),
                  t.search_batch(queries, 10, refine=128))
    # the device venue ("mirror": here on CPU tensors) ranks the same pool
    t.rerank_mode = "device"
    try:
        assert t._rerank_venue() == "mirror"
        _same_results(want, t.search_batch(queries, 10), ties=True)
    finally:
        t.rerank_mode = "auto"


def test_filtered_search_matches_jax(pair):
    metric, db, j, t = pair
    q = np.ascontiguousarray(db[:8] + 0.01)
    # 1500 eligible rows: the masked scan; 20: the exact host path
    for step in (2, 150):
        mask = np.zeros(t.capacity, bool)
        mask[np.arange(0, 3000, step)] = True
        want = j.search_batch(q, 5, slot_mask=mask)
        got = t.search_batch(q, 5, slot_mask=mask)
        _same_results(want, got)
        assert all(i % step == 0 for row in got for i, _ in row)


def test_k_bigger_than_refine_matches_jax(pair):
    metric, db, j, t = pair
    q = np.ascontiguousarray(db[5:7] + 0.01)
    _same_results(j.search_batch(q, 50), t.search_batch(q, 50))
    # r past the scan's envelope: the exact fallback scan serves
    got = t.search_batch(q, 5, refine=4096)
    _same_results(j.search_batch(q, 5, refine=4096), got)


def test_fill_masked_short_is_exact(pair):
    """The safety net re-answers a query that came back short by an exact
    stream over the eligible slots."""
    metric, db, j, t = pair
    q = np.ascontiguousarray(db[:3] + 0.01)
    mask = np.zeros(t.capacity, bool)
    mask[np.arange(1, 3000, 3)] = True
    res = t._fill_masked_short(tpqi.HitColumns.from_rows([[], [], []]), q,
                               4, mask, t.slot_layout_version)
    _same_results(j.search_batch(q, 4, slot_mask=mask), res.rows())


def test_crud_after_training_matches_jax():
    db, j, t = _pair("euclidean", n=2000, scale=1.0)
    rng = np.random.default_rng(12)
    extra = (5.0 * rng.standard_normal((50, 32))).astype(np.float32)
    for idx in (j, t):
        idx.add(2000, db[3] + 0.001)               # fresh id
        idx.add(7, db[7] + 5.0)                    # upsert moves the row
        idx.remove(11)
        idx.add_batch([(3000 + i, extra[i]) for i in range(50)])
    q = np.concatenate([db[3:4] + 0.001, db[7:8] + 5.0, db[11:12],
                        extra[:4]])
    want, got = j.search_batch(q, 3), t.search_batch(q, 3)
    _same_results(want, got)
    assert got[0][0][0] == 2000 and got[1][0][0] == 7
    assert all(i != 11 for i, _ in got[2])
    assert [row[0][0] for row in got[3:]] == [3000, 3001, 3002, 3003]
    assert np.allclose(t.get_vector(7).as_array(), db[7] + 5.0)
    assert t.get_vector(11) is None and len(t) == len(j) == 2050


def test_untrained_small_index_is_exact_flat():
    rng = np.random.default_rng(13)
    db = rng.standard_normal((64, 8)).astype(np.float32)
    j = JPq(_jm("euclidean"), m=2, ksub=8)
    t = PqFlatIndex(_tm("euclidean"), m=2, ksub=8, device="cpu")
    for idx in (j, t):
        idx.add_batch([(i, db[i]) for i in range(64)])
    assert not t.is_trained
    _same_results(j.search_batch(db[:3], 5), t.search_batch(db[:3], 5))
    # the untrained device state is the plain f32 rows, no bf16 mirrors
    assert set(t._device) == {"db", "sq_norms", "norms", "valid"}


def test_auto_train_on_search():
    rng = np.random.default_rng(14)
    db = _clustered(rng, 600, 16, n_centers=8)
    idx = PqFlatIndex(_tm("euclidean"), m=4, ksub=16, auto_train_min=512,
                      device="cpu")
    idx.add_batch([(i, db[i]) for i in range(600)])
    assert not idx.is_trained
    got = idx.search_batch(db[:2], 3)
    assert idx.is_trained
    assert [row[0][0] for row in got] == [0, 1]


def test_cosine_zero_vector_raises_after_training():
    rng = np.random.default_rng(15)
    db = _clustered(rng, 512, 16, n_centers=4)
    db /= np.maximum(np.linalg.norm(db, axis=1, keepdims=True), 1e-6)
    idx = PqFlatIndex(_tm("cosine"), m=4, ksub=16, device="cpu")
    idx.add_batch([(i, db[i]) for i in range(512)])
    idx.train()
    with pytest.raises(InvalidVectorError):
        idx.search_batch(np.zeros((1, 16), np.float32), 3)


def test_train_errors():
    rng = np.random.default_rng(16)
    idx = PqFlatIndex(_tm("euclidean"), m=5, ksub=16, device="cpu")
    db = rng.standard_normal((64, 16)).astype(np.float32)
    idx.add_batch([(i, db[i]) for i in range(64)])
    with pytest.raises(IndexOpError):
        idx.train()                   # m does not divide d
    idx = PqFlatIndex(_tm("euclidean"), m=2, ksub=64, device="cpu")
    idx.add_batch([(i, db[i, :8]) for i in range(32)])
    with pytest.raises(IndexOpError):
        idx.train()                   # fewer rows than ksub
    assert PqFlatIndex(_tm("euclidean"),
                       device="cpu").export_trained_state() is None


def test_port_train_export_import_bit_identical():
    """The port's own training: a recall floor on clustered data, and a
    trained state that reproduces the search bit for bit elsewhere."""
    rng = np.random.default_rng(17)
    db = _clustered(rng, 2048, 32)
    idx = PqFlatIndex(_tm("euclidean"), m=8, ksub=32, refine=256, seed=5,
                      device="cpu")
    idx.add_batch([(i, db[i]) for i in range(2048)])
    idx.train()
    queries = db[rng.choice(2048, 32, replace=False)] + 0.01
    want = idx.search_batch(queries, 10)
    d2 = ((queries[:, None, :] - db[None, :, :]) ** 2).sum(-1)
    truth = np.argsort(d2, axis=1)[:, :10]
    recall = np.mean([len({i for i, _ in row} & set(t_.tolist())) / 10
                      for row, t_ in zip(want, truth)])
    assert recall >= 0.9, recall
    state = idx.export_trained_state()
    assert set(state) == {"codebook", "ksub", "rotation"}
    idx2 = PqFlatIndex(_tm("euclidean"), m=8, ksub=32, refine=256,
                       rotate=False, device="cpu")
    idx2.add_batch([(i, db[i]) for i in range(2048)])
    idx2.import_trained_state(state)
    idx2.train = None                 # import must not retrain
    assert idx2.search_batch(queries, 10) == want


def test_import_rounds_codebook_like_jax():
    """A hand-built f32 codebook is rounded to bf16 values, the port with
    torch's RNE cast, the JAX package with ml_dtypes: the same values."""
    rng = np.random.default_rng(18)
    cb = rng.standard_normal((4, 16, 4)).astype(np.float32)
    j = JPq(_jm("euclidean"), m=4, ksub=16)
    t = PqFlatIndex(_tm("euclidean"), m=4, ksub=16, device="cpu")
    for idx in (j, t):
        idx.import_trained_state({"codebook": cb})
    assert np.array_equal(t._codebook.view(np.uint32),
                          j._codebook.view(np.uint32))
    assert not np.array_equal(t._codebook, cb)


def test_mutations_resync_device_rows():
    db, _, t = _pair("euclidean", n=2000, scale=1.0, rerank="device")
    q = np.ascontiguousarray(db[5:6])
    assert t.search_batch(q, 1)[0][0][0] == 5
    t.add(5, db[5] + 100.0)
    t.add(4000, db[5])
    got = t.search_batch(q, 2)[0]
    assert got[0][0] == 4000 and got[0][1] < 1e-4
    assert all(i != 5 for i, _ in got)
    t.remove(4000)
    assert t.search_batch(q, 1)[0][0][0] != 4000


def test_mutation_race_repair():
    """A slot mutated between the scan snapshot and the id mapping must
    not leak the old occupant's distance under a new id: the repair
    re-answers through the host re-rank over the kept pool."""
    db, _, t = _pair("euclidean", n=2000, scale=1.0, rerank="device")
    q = np.ascontiguousarray(db[5:6])
    orig = t._collect_device_rerank
    fired = {}

    def hooked(queries, dev_out, k_req, tick0, lv0, mask):
        if not fired:
            fired["x"] = True
            t.add(5, db[5] + 50.0)     # mutates id 5's slot mid-flight
        return orig(queries, dev_out, k_req, tick0, lv0, mask)

    t._collect_device_rerank = hooked
    got = t.search_batch(q, 5)[0]
    assert fired and len(got) == 5
    assert not any(i == 5 and dist < 1.0 for i, dist in got)


def test_rerank_venues(monkeypatch):
    assert PqFlatIndex(_tm("euclidean"),
                       device="cpu")._rerank_venue() == "host"
    with pytest.raises(ValueError):
        PqFlatIndex(_tm("euclidean"), rerank="bogus", device="cpu")
    db, j, t = _pair("dot_product", n=1500, scale=1.0, rerank="device")
    assert t._rerank_venue() == "mirror"
    # rows past the device budget: "gathered" when asked for the device,
    # the host otherwise
    monkeypatch.setattr(tpqi, "_RERANK_DEV_ROW_BYTES", 1000)
    monkeypatch.setattr(tpqi, "_RERANK_QBLOCK", 16)
    assert t._rerank_venue() == "gathered"
    q = np.ascontiguousarray(db[:50] + 0.001)     # 3 blocks + a tail
    _same_results(j.search_batch(q, 4), t.search_batch(q, 4), ties=True)
    t.rerank_mode = "auto"
    assert t._rerank_venue() == "host"


def test_calibrate_refine_meets_target():
    db, _, t = _pair("euclidean", n=4096, d=64, m=8, ksub=32, refine=1)
    out = t.calibrate_refine(0.9, k=10, sample=64,
                             candidates=(4, 16, 64, 256))
    assert set(out) == {"refine", "recall", "curve"}
    assert t.refine == out["refine"]
    assert out["recall"] >= 0.9 or out["refine"] == max(out["curve"])
    got = t.search_batch(db[:32], 1)
    assert sum(int(row[0][0] == i) for i, row in enumerate(got)) >= 31
    with pytest.raises(IndexOpError):
        t.calibrate_refine(0.0)


def test_unported_options_raise():
    """The mesh lane is ported: ``mesh=`` and ``row_axis=`` shard the
    codes, ``scan_recall`` is checked and kept (the selection is exact);
    the options, in the JAX package's order, take what JAX's take and
    refuse what they refuse."""
    from vectordb_tpu_torch.parallel import make_mesh
    mesh = make_mesh(4, devices=["cpu"] * 4)
    t = PqFlatIndex(_tm("euclidean"), None, 16, 64, 15, 8192, 0, None, 0.9,
                    False, mesh, "shard", "auto", "cpu")
    assert t._mesh is mesh and t.scan_recall == 0.9 and not t._rotate
    assert JPq(_jm("euclidean"), scan_recall=0.9).scan_recall == 0.9
    with pytest.raises(ValueError):
        PqFlatIndex(_tm("euclidean"), mesh=object(), device="cpu")
    with pytest.raises(ValueError):
        PqFlatIndex(_tm("euclidean"), mesh=mesh, row_axis="rows")
    for bad in (0.0, 1.5):
        with pytest.raises(ValueError):
            PqFlatIndex(_tm("euclidean"), scan_recall=bad, device="cpu")
    with pytest.raises(IndexOpError, match="single-device"):
        PqFlatIndex(_tm("euclidean"), mesh=mesh,
                    rerank="device")._rerank_venue()
    assert PqFlatIndex(_tm("euclidean"), mesh=mesh)._rerank_venue() == "host"


@pytest.mark.parametrize("loader", ["stream", "attach"])
def test_bulk_loaders_match_jax(loader, tmp_path):
    """bulk_load_stream and bulk_attach_memmap (host_backing) load the
    rows the JAX index loads; with its trained state carried across, the
    port re-encodes them to its codes and answers the same."""
    rng = np.random.default_rng(21)
    db = _clustered(rng, 2048, 32, scale=0.3)
    j = JPq(_jm("euclidean"), m=8, ksub=32, refine=32)
    j.bulk_load_stream(2048, 32, iter([db[:1000], db[1000:]]))
    j.train()
    if loader == "stream":
        t = PqFlatIndex(_tm("euclidean"), m=8, ksub=32, refine=32,
                        device="cpu")
        t.bulk_load_stream(2048, 32, iter([db[:700], db[700:]]))
    else:
        src = JPq(_jm("euclidean"), m=8, ksub=32,
                  host_backing=str(tmp_path / "jax"))
        src.bulk_load_stream(2048, 32, iter([db]))
        src._vectors.flush()
        t = PqFlatIndex(_tm("euclidean"), m=8, ksub=32, refine=32,
                        device="cpu", host_backing=str(tmp_path / "port"))
        t.bulk_attach_memmap(src._vectors_path, 2048, 32)
        assert t._rerank_venue() == "host"
    t.import_trained_state(j.export_trained_state())
    q = np.ascontiguousarray(db[:16] + 0.01)
    want = j.search_batch(q, 5)
    t.search_batch(q, 5)                       # sync: encode every row
    np.testing.assert_array_equal(t._codes[:2048], np.asarray(j._codes)[:2048])
    _same_results(want, t.search_batch(q, 5))


def test_adopt_codes_rejects_codes_past_ksub():
    """A code >= ksub names no codeword: it is refused where codes enter
    the index, so the decode (kernel and plain) never sees one."""
    rng = np.random.default_rng(20)
    db = _clustered(rng, 256, 16, n_centers=4)
    idx = PqFlatIndex(_tm("euclidean"), m=4, ksub=16, device="cpu")
    idx.add_batch([(i, db[i]) for i in range(256)])
    idx.train()
    codes = np.zeros((idx.capacity, 4), np.uint8)
    codes[7, 2] = 16
    with pytest.raises(IndexOpError, match="out of range"):
        idx.adopt_codes(codes)
    codes[7, 2] = 15
    idx.adopt_codes(codes)
    assert idx.search_batch(db[:1], 1)[0]


def test_removed_rows_never_returned():
    rng = np.random.default_rng(19)
    db = rng.standard_normal((600, 8)).astype(np.float32)
    idx = PqFlatIndex(_tm("euclidean"), m=2, ksub=16, refine=32,
                      device="cpu")
    idx.add_batch([(i, db[i]) for i in range(600)])
    idx.train()
    idx.search_batch(db[:1], 1)          # sync the device state
    for i in range(100):
        idx.remove(i)
    for row in idx.search_batch(db[:4], 5):
        assert all(rid >= 100 for rid, _ in row)


# ---------------------------------------------------------------------------
# stores, the carried-across store, HTTP and the CLI
# ---------------------------------------------------------------------------

def test_pq_store_from_reference_matches_jax_store():
    rng = np.random.default_rng(20)
    db = _clustered(rng, 1500, 32, scale=1.0)
    js = J.VectorStore(JPq(_jm("euclidean"), m=8, ksub=32, refine=32))
    for i in range(1500):
        js.insert_with_metadata(f"v{i}", J.Vector(db[i]), J.Metadata(
            {"par": "even" if i % 2 == 0 else "odd"}))
    js.delete("v3")
    js.index.train()
    qs = [(J.Vector(db[i] + 0.01), 5) for i in range(10)]
    want = js.search_batch(qs)          # also syncs the JAX codes
    meta = {iid: js.get_metadata(sid).fields()
            for iid, sid in js.internal_to_string_ids().items()}
    ts = pq_store_from_reference(
        *js.index.packed_arrays(), js.internal_to_string_ids(),
        T.DistanceMetric.EUCLIDEAN, js.index.export_trained_state(),
        codes=np.asarray(js.index._codes), device="cpu", metadata=meta,
        m=8, ksub=32, refine=32)
    assert ts.index.is_trained and len(ts) == 1499
    got = ts.search_batch([(T.Vector(db[i] + 0.01), 5) for i in range(10)])
    for w, g in zip(want, got):
        assert [r.id for r in g] == [r.id for r in w]
        np.testing.assert_allclose([r.distance for r in g],
                                   [r.distance for r in w], rtol=2e-5)
    flt_j = J.MetadataFilter.eq("par", "even")
    flt_t = T.MetadataFilter.eq("par", "even")
    for qi in (0, 4):
        w = js.search_with_filter(J.Vector(db[qi]), 4, flt_j)
        g = ts.search_with_filter(T.Vector(db[qi]), 4, flt_t)
        assert [r.id for r in g] == [r.id for r in w]
    with pytest.raises(ValueError):
        pq_store_from_reference(*js.index.packed_arrays(),
                                js.internal_to_string_ids(),
                                T.DistanceMetric.EUCLIDEAN, None,
                                codes=np.asarray(js.index._codes),
                                device="cpu")


def test_store_refine_knob_and_mismatches():
    rng = np.random.default_rng(21)
    db = _clustered(rng, 1024, 16, n_centers=8)
    store = T.VectorStore.with_index(PqFlatIndex(
        _tm("euclidean"), m=4, ksub=16, refine=16, device="cpu"))
    store.insert_batch([T.BatchInsertItem(f"v{i}", T.Vector(db[i]))
                        for i in range(1024)])
    store.index.train()
    assert store.search(T.Vector(db[3]), 5, refine=256)[0].id == "v3"
    assert store.search_batch([(T.Vector(db[3]), 5)],
                              refine=256)[0][0].id == "v3"
    with pytest.raises(IndexOpError):
        store.search(T.Vector(db[3]), 5, refine=0)
    with pytest.raises(IndexOpError):
        store.search(T.Vector(db[3]), 5, ef=10, refine=16)
    with pytest.raises(IndexOpError):
        store.search(T.Vector(db[3]), 5, nprobe=2)
    radius = store.search_radius(T.Vector(db[3]), 0.5, limit=10)
    assert radius and radius[0].id == "v3"


def test_http_refine_knob():
    from vectordb_tpu_torch.server.app import AppState
    from vectordb_tpu_torch.server.routes import Api
    rng = np.random.default_rng(22)
    db = _clustered(rng, 64, 16, n_centers=8)
    store = T.VectorStore.with_index(PqFlatIndex(
        _tm("euclidean"), m=4, ksub=16, refine=16, device="cpu"))
    for i in range(64):
        store.insert(f"v{i}", T.Vector(db[i]))
    api = Api(AppState(store))
    store.index.train()
    status, body = api.handle("POST", "/search", {
        "vector": db[3].tolist(), "k": 3, "refine": 64})
    assert status == 200 and body[0]["id"] == "v3"
    status, body = api.handle("POST", "/search/batch", {
        "queries": [{"vector": db[4].tolist(), "k": 2}], "refine": 64})
    assert status == 200 and body[0][0]["id"] == "v4"
    status, _ = api.handle("POST", "/search", {
        "vector": db[3].tolist(), "k": 3, "refine": 64, "ef": 10})
    assert status == 400
    status, body = api.handle("POST", "/search", {
        "vector": db[3].tolist(), "k": 3, "refine": 64,
        "filter": {"op": "exists", "field": "x"}})
    assert status == 200 and body == []


def test_cli_index_pq(capsys):
    from vectordb_tpu_torch.cli import main
    assert main(["--device", "cpu", "--index", "pq", "insert", "a",
                 "--vector", "1,2,3"]) == 0
    assert main(["--device", "cpu", "--index", "pq", "search", "1,2,3",
                 "-k", "1"]) == 0
    assert "No results found" in capsys.readouterr().out   # in-memory
    assert main(["--device", "cpu", "--index", "pq", "--storage", "bf16",
                 "list"]) == 1
    assert "owns its device representation" in capsys.readouterr().err
    assert main(["--device", "cpu", "--index", "ivfpq", "--storage", "int8",
                 "list"]) == 1
    assert "owns its device representation" in capsys.readouterr().err
    # --index hnsw, ivf and ivfpq are ported (tests/test_torch_cli.py,
    # tests/test_torch_ivf.py, tests/test_torch_ivfpq.py)
    for kind in ("hnsw", "ivf", "ivfpq"):
        assert main(["--device", "cpu", "--index", kind, "list"]) == 0
