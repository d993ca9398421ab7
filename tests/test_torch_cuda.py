"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Marked ``cuda``: each test skips without a CUDA device. This
file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Limits: bf16 x bf16 products are exact in f32, so a sound kernel and
the plain version differ only in summation order. The limits are set
from readings on the card, not from the worst-case summation bound
(which at d=768 would pass a kernel that lost a bf16x3 pass). With
S = |x|max |q|max: sound kernels read at most ~1.1e-6 S (coarse) and
~5e-8 S (refine dots); the controls in ``test_controls_break_the_limits``
read ~3e-4 S and ~5e-5 S. The limits, 2^-16 S and 2^-20 S, sit an order
of magnitude from both (chip_smoke.py's ``limits``; cosine coarse scores
are normalised, S = 1).
"""

import numpy as np
import pytest
import torch

from vectordb_tpu_torch import BatchInsertItem, DistanceMetric, Vector
from vectordb_tpu_torch import VectorStore
from vectordb_tpu_torch.ops import coarse_kernel as ck
from vectordb_tpu_torch.ops import cuda_kernels

pytestmark = pytest.mark.cuda
MODES = ["euclidean", "dot", "cosine"]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _operands(dev, n, d, q, mode, seed=0):
    rng = np.random.default_rng(seed)
    db = torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32)).to(
        dev)
    valid = torch.from_numpy(rng.random(n) >= 0.1).to(dev)
    queries = torch.from_numpy(
        rng.standard_normal((q, d), dtype=np.float32)).to(dev)
    sq = (db * db).sum(1)
    hi, lo = ck.split_hi_lo(db)
    terms = ck._query_terms(queries, sq, torch.sqrt(sq), valid, mode)
    s = float(torch.sqrt(sq.max())) * float(terms[3].max())
    limit = 2.0 ** -16 * (1.0 if mode == "cosine" else s)
    return db, hi, lo, queries, terms, limit, 2.0 ** -20 * s


def _live_err(got, want):
    live = want < 1e29
    assert torch.equal(live, got < 1e29)
    return float((got - want).abs()[live].max())


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n, d, q", [(4096, 768, 100), (1024, 40, 7)])
def test_k1_matches_plain(dev, mode, n, d, q):
    db, hi, lo, queries, terms, bound, _ = _operands(dev, n, d, q, mode)
    qThi, _, _, _, qrow, col, inv = terms
    before = cuda_kernels.launches["coarse_minima_1p_sup"]
    t_k, s_k = ck._minima_1p_sup(qThi, qrow, hi, col, inv, mode)
    t_p, s_p = ck._minima_1p_sup_plain(qThi, qrow, hi, col, inv, mode)
    torch.cuda.synchronize()
    assert cuda_kernels.launches["coarse_minima_1p_sup"] == before + 1
    assert t_k.shape == (n // 16, q) and s_k.shape == (n // 256, q)
    assert _live_err(t_k, t_p) <= bound
    assert _live_err(s_k, s_p) <= bound


@pytest.mark.parametrize("src", ["mirrors", "f32"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n, d, q, body", [
    (256, 768, 7, "wgmma"),             # one super-tile, Qp < one query tile
    (133 * 256, 200, 100, "wgmma"),     # past one wave of persistent blocks
    (4096, 40, 4133, "wgmma"),          # d < one stage, ragged query tiles
    (512, 768, 130, "wgmma"),
    (512, 37, 100, "mma_sync")])        # ragged d: TMA cannot take it
def test_k1_k4_bodies_match_plain(dev, src, mode, n, d, q, body):
    """K1 and K4 against _minima_1p_sup_plain on the body their shape
    routes to, with 10% dead rows and fully dead tiles; each super minimum
    is the minimum of its 16 tile minima exactly."""
    rng = np.random.default_rng(n + d + q)
    db = torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32)).to(
        dev)
    valid_np = rng.random(n) >= 0.1
    valid_np[16:48] = False                 # tiles 1 and 2 fully dead
    valid = torch.from_numpy(valid_np).to(dev)
    queries = torch.from_numpy(
        rng.standard_normal((q, d), dtype=np.float32)).to(dev)
    sq = (db * db).sum(1)
    qThi, _, _, qn, qrow, col, inv = ck._query_terms(
        queries, sq, torch.sqrt(sq), valid, mode)
    arr = db if src == "f32" else db.to(torch.bfloat16)
    key = {"f32": "coarse_minima_f32_1p_sup",
           "mirrors": "coarse_minima_1p_sup"}[src]
    assert cuda_kernels.coarse_body(src, arr, 1, True) == body
    before = dict(cuda_kernels.routes[key])
    t_k, s_k = ck._minima_1p_sup(qThi, qrow, arr, col, inv, mode, src)
    t_p, s_p = ck._minima_1p_sup_plain(qThi, qrow, arr, col, inv, mode, src)
    torch.cuda.synchronize()
    assert cuda_kernels.routes[key][body] == before[body] + 1
    assert t_k.shape == (n // 16, q) and s_k.shape == (n // 256, q)
    lim = 2.0 ** -16 * (1.0 if mode == "cosine" else
                        float(torch.sqrt(sq.max())) * float(qn.max()))
    assert _live_err(t_k, t_p) <= lim
    assert _live_err(s_k, s_p) <= lim
    assert torch.equal(s_k, t_k.reshape(-1, 16, q).amin(dim=1))


@pytest.mark.parametrize("kernel", ["k7", "k5_3", "k5_1"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n, d, q", [
    (256, 768, 7),                      # one super-tile, Qp < one query tile
    (133 * 256, 48, 65),                # past one wave; d not whole stages
    (256, 768, 4133),                   # ragged query tiles
    (256, 40, 100),                     # int8 codes: d % 16 != 0
    (133 * 256, 37, 100)])              # ragged d: TMA takes neither
def test_k7_k5_bodies_match_plain(dev, kernel, mode, n, d, q):
    """K7 (int8 codes x pow2 scales, super minima) and K5 at 3 and 1 passes
    (f32 rows split on chip, tile minima only) against their plain versions
    on the body their shape routes to -- wgmma where the rows' pitch is a
    multiple of 16 bytes (int8 codes: d % 16 == 0; f32 rows and bf16
    queries: d % 8 == 0), else mma_sync -- with 10% dead rows and fully
    dead tiles; K7's super minima are exactly the minima of its tile
    minima."""
    rng = np.random.default_rng(n + d + q)
    db = torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32)).to(
        dev)
    valid_np = rng.random(n) >= 0.1
    valid_np[16:48] = False                 # tiles 1 and 2 fully dead
    valid = torch.from_numpy(valid_np).to(dev)
    queries = torch.from_numpy(
        rng.standard_normal((q, d), dtype=np.float32)).to(dev)
    if kernel == "k7":
        codes, scales, rows = _int8_rows(db)
        src, arr, passes, key = "int8", codes, 1, "coarse_minima_int8_1p_sup"
        body = "wgmma" if d % 16 == 0 else "mma_sync"
    else:
        src, arr, rows, key = "f32", db, db, "coarse_minima_f32"
        passes = 3 if kernel == "k5_3" else 1
        body = "wgmma" if d % 8 == 0 else "mma_sync"
    sq = (rows * rows).sum(1)
    qThi, qlo, _, qn, qrow, col, inv = ck._query_terms(
        queries, sq, torch.sqrt(sq), valid, mode)
    qTlo = qlo.to(torch.bfloat16)
    assert cuda_kernels.coarse_body(src, arr, passes, kernel == "k7") == body
    before = dict(cuda_kernels.routes[key])
    if kernel == "k7":
        sc = scales.reshape(1, -1)
        t_k, s_k = ck._minima_1p_sup(qThi, qrow, arr, col, inv, mode, src, sc)
        t_p, s_p = ck._minima_1p_sup_plain(qThi, qrow, arr, col, inv, mode,
                                           src, sc)
    else:
        t_k = ck._coarse_minima_f32(qThi, qTlo, qrow, arr, col, inv, passes,
                                    mode).T
        t_p = ck._coarse_minima_f32_plain(qThi, qTlo, qrow, arr, col, inv,
                                          passes, mode).T
    torch.cuda.synchronize()
    assert cuda_kernels.routes[key][body] == before[body] + 1
    assert t_k.shape == (n // 16, q)
    lim = 2.0 ** -16 * (1.0 if mode == "cosine" else
                        float(torch.sqrt(sq.max())) * float(qn.max()))
    assert _live_err(t_k, t_p) <= lim
    if kernel == "k7":
        assert s_k.shape == (n // 256, q)
        assert _live_err(s_k, s_p) <= lim
        assert torch.equal(s_k, t_k.reshape(-1, 16, q).amin(dim=1))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n, d, q, shift, body", [
    (256, 768, 7, False, "wgmma"),      # one super-tile, Qp < one query tile
    (133 * 256, 48, 65, False, "wgmma"),    # past one wave; d not whole
    (256, 40, 100, False, "wgmma"),     # d < one stage
    (133 * 256, 768, 1029, False, "wgmma"),   # ragged query tiles
    (133 * 256, 37, 100, False, "mma_sync"),  # ragged d: TMA cannot take it
    (256, 768, 65, True, "mma_sync")])  # lo mirror 2 bytes off alignment
def test_k3_bodies_match_plain(dev, mode, n, d, q, shift, body):
    """K3 at 3 passes over the hi and lo mirrors against
    _coarse_minima_plain on the body its shape routes to -- wgmma where TMA
    takes both mirrors (d % 8 == 0, both 16-byte aligned), else mma_sync --
    with 10% dead rows and fully dead tiles."""
    rng = np.random.default_rng(n + d + q)
    db = torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32)).to(
        dev)
    valid_np = rng.random(n) >= 0.1
    valid_np[16:48] = False                 # tiles 1 and 2 fully dead
    valid = torch.from_numpy(valid_np).to(dev)
    queries = torch.from_numpy(
        rng.standard_normal((q, d), dtype=np.float32)).to(dev)
    sq = (db * db).sum(1)
    qThi, qlo, _, qn, qrow, col, inv = ck._query_terms(
        queries, sq, torch.sqrt(sq), valid, mode)
    qTlo = qlo.to(torch.bfloat16)
    hi, lo = ck.split_hi_lo(db)
    if shift:                               # a bf16 view one element off
        buf = torch.empty((lo.numel() + 8,), dtype=torch.bfloat16,
                          device=dev)
        lo = buf[1:1 + lo.numel()].view_as(lo).copy_(lo)
    assert cuda_kernels.coarse_body("mirrors", hi, 3, False, lo) == body
    before = dict(cuda_kernels.routes["coarse_minima"])
    t_k = ck._coarse_minima(qThi, qTlo, qrow, hi, lo, col, inv, 3, mode)
    t_p = ck._coarse_minima_plain(qThi, qTlo, qrow, hi, lo, col, inv, 3,
                                  mode)
    torch.cuda.synchronize()
    assert cuda_kernels.routes["coarse_minima"][body] == before[body] + 1
    assert t_k.shape == (q, n // 16)
    lim = 2.0 ** -16 * (1.0 if mode == "cosine" else
                        float(torch.sqrt(sq.max())) * float(qn.max()))
    assert _live_err(t_k, t_p) <= lim


def _probe_rows(rng, data, n, d, q):
    """(rows, queries) f32 for an accumulation reading: N(0,1), or U(1, 2)
    (every product positive: a truncating accumulator drifts one way)."""
    if data == "normal":
        return (rng.standard_normal((n, d), dtype=np.float32),
                rng.standard_normal((q, d), dtype=np.float32))
    return (rng.uniform(1.0, 2.0, (n, d)).astype(np.float32),
            rng.uniform(1.0, 2.0, (q, d)).astype(np.float32))


@pytest.mark.parametrize("kernel", ["k7", "k5_3", "k3_3"])
@pytest.mark.parametrize("data", ["normal", "uniform12"])
def test_new_wgmma_readings_within_coefficient(dev, kernel, data):
    """The accumulation reading of the wgmma body's K7 (integer codes, unit
    scales), K5 at 3 passes and K3 at 3 passes (against the f64 sum of the
    three bf16 products), through ``_probe_inv``: at most the wgmma
    coefficient. K7's codes: uniform in [-127, 127] against N(0,1)
    queries, and all positive, in [64, 127], against U(1, 2) queries."""
    rng = np.random.default_rng(22)
    n, d, q = 4096, 768, 64
    x_np, qs_np = _probe_rows(rng, data, n, d, q)
    x = torch.from_numpy(x_np).to(dev)
    qs = torch.from_numpy(qs_np).to(dev)
    inv, live = ck._probe_inv(n, dev)
    qrow = torch.zeros((1, q), device=dev)
    col = torch.zeros((1, n), device=dev)
    qT = qs.T.contiguous()
    qThi = qT.to(torch.bfloat16)
    if kernel == "k7":
        low = -127 if data == "normal" else 64
        codes = torch.from_numpy(rng.integers(low, 128, (n, d)).astype(
            np.int8)).to(dev)
        ones = torch.ones((1, n), device=dev)
        assert cuda_kernels.coarse_body("int8", codes, 1, True) == "wgmma"
        t, _ = cuda_kernels.coarse_minima_int8_1p_sup(qThi, qrow, codes, ones,
                                                      col, inv, "dot")
        reading = ck._accum_reading(t, codes.float(), qThi, live)
    else:
        qTlo = (qT - qThi.float()).to(torch.bfloat16)
        hi, lo = ck.split_hi_lo(x)
        if kernel == "k3_3":
            assert cuda_kernels.coarse_body("mirrors", hi, 3, False,
                                            lo) == "wgmma"
            t = cuda_kernels.coarse_minima(qThi, qTlo, qrow, hi, lo, col,
                                           inv, 3, "dot")
        else:
            assert cuda_kernels.coarse_body("f32", x, 3, False) == "wgmma"
            t = cuda_kernels.coarse_minima_f32(qThi, qTlo, qrow, x, col, inv,
                                               3, "dot")
        reading = ck._accum_reading(t, hi.float(), qThi, live,
                                    lo.float(), qTlo)
    torch.cuda.synchronize()
    assert 0.0 <= reading <= ck._accum_coeff("wgmma"), reading


@pytest.mark.parametrize("data", ["normal", "uniform12"])
def test_accumulation_reading_within_coefficient(dev, data):
    """Raw dots read through each body (K1 and K6 on wgmma; K6's operands
    on mma_sync, through its C entry point) with 15 of every 16 rows dead,
    against f64 dots of the same bf16 operands, in units of d 2^-24
    sum|x_i q_i|: each reading is at most the coefficient the certificates
    use for that body. "uniform12": rows and queries from U(1, 2), every
    product positive."""
    rng = np.random.default_rng(21)
    n, d, q = 4096, 768, 64
    if data == "normal":
        x = rng.standard_normal((n, d), dtype=np.float32)
        qs = rng.standard_normal((q, d), dtype=np.float32)
    else:
        x = rng.uniform(1.0, 2.0, (n, d)).astype(np.float32)
        qs = rng.uniform(1.0, 2.0, (q, d)).astype(np.float32)
    hi = torch.from_numpy(x).to(dev).to(torch.bfloat16)
    qThi = torch.from_numpy(qs).to(dev).T.contiguous().to(torch.bfloat16)
    inv, live = ck._probe_inv(n, dev)
    qrow = torch.zeros((1, q), device=dev)
    col = torch.zeros((1, n), device=dev)
    before = dict(cuda_kernels.routes["coarse_minima_1p_sup"])
    before6 = dict(cuda_kernels.routes["coarse_minima_1p"])
    t_w, _ = cuda_kernels.coarse_minima_1p_sup(qThi, qrow, hi, col, inv,
                                               "dot")
    t_6 = cuda_kernels.coarse_minima_1p(qThi, qrow, hi, col, inv, "dot")
    t_m, _ = cuda_kernels.coarse_minima_mma_sync(
        "mirrors", qThi, None, qrow, hi, None, None, col, inv, "dot", 1,
        False)
    torch.cuda.synchronize()
    assert (cuda_kernels.routes["coarse_minima_1p_sup"]["wgmma"]
            == before["wgmma"] + 1)
    assert (cuda_kernels.routes["coarse_minima_1p"]["wgmma"]
            == before6["wgmma"] + 1)
    r_w = ck._accum_reading(t_w, hi.float(), qThi, live)
    r_6 = ck._accum_reading(t_6, hi.float(), qThi, live)
    r_m = ck._accum_reading(t_m, hi.float(), qThi, live)
    assert r_w <= ck._accum_coeff("wgmma"), r_w
    assert r_6 <= ck._accum_coeff("wgmma"), r_6
    assert r_m <= ck._accum_coeff("mma_sync"), r_m


@pytest.mark.parametrize("passes", [3, 1])
@pytest.mark.parametrize("mode", MODES)
def test_k3_matches_plain(dev, mode, passes):
    db, hi, lo, queries, terms, bound, _ = _operands(dev, 2048, 768, 65,
                                                     mode, seed=1)
    qThi, qlo, _, _, qrow, col, inv = terms
    qTlo = qlo.to(torch.bfloat16)
    got = ck._coarse_minima(qThi, qTlo, qrow, hi, lo, col, inv, passes, mode)
    want = ck._coarse_minima_plain(qThi, qTlo, qrow, hi, lo, col, inv,
                                   passes, mode)
    torch.cuda.synchronize()
    assert got.shape == (65, 2048 // 16)
    assert _live_err(got, want) <= bound


@pytest.mark.parametrize("d", [768, 37])
def test_k2_matches_plain(dev, d):
    db, _, _, queries, _, _, dot_b = _operands(dev, 4096, d, 9, "dot",
                                               seed=2)
    rng = np.random.default_rng(3)
    tidx = torch.from_numpy(rng.integers(0, 4096 // 16, (9, 33))).to(dev)
    got = ck._refine_dots(tidx, queries, db, 33)
    want = ck._refine_dots_plain(tidx, queries, db, 33)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= dot_b


def _k2_case(dev, src, sharing, qp, m, d, seed=11):
    """(tile_idx, queries, rows, scales) for a K2 launch over max(qp m,
    1024) tiles:
    every query on the same m tiles ("max"), no tile chosen twice
    ("none"), or uniform ids ("random"); rows N(0,1) as f32, their bf16
    mirror, or pow2-scaled int8 codes."""
    rng = np.random.default_rng(seed)
    tiles = max(qp * m, 1024)
    if sharing == "max":
        ids = np.tile(rng.permutation(tiles)[:m], (qp, 1))
    elif sharing == "none":
        ids = rng.permutation(tiles)[:qp * m].reshape(qp, m)
    else:
        ids = rng.integers(0, tiles, (qp, m))
    tidx = torch.from_numpy(ids.astype(np.int64)).to(dev)
    db = torch.from_numpy(rng.standard_normal(
        (tiles * 16, d), dtype=np.float32)).to(dev)
    queries = torch.from_numpy(rng.standard_normal(
        (qp, d), dtype=np.float32)).to(dev)
    scales = None
    if src == "bf16":
        db = db.to(torch.bfloat16)
    elif src == "int8":
        db, scales, _ = _int8_rows(db)
    return tidx, queries, db, scales


def _refine_limit(db, scales, queries):
    """The refine limit 2^-20 S, S = |x|max |q|max over the stored rows."""
    stored = db.float() if scales is None else db.float() * scales[:, None]
    return (2.0 ** -20 * float(stored.norm(dim=1).max())
            * float(queries.norm(dim=1).max()))


@pytest.mark.parametrize("src", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("sharing", ["max", "none", "random"])
@pytest.mark.parametrize("qp, m, d", [(1, 33, 768), (129, 33, 768),
                                      (129, 33, 200), (65, 33, 1792)])
def test_k2_tile_major_matches_plain(dev, src, sharing, qp, m, d):
    """The tile-major K2 body against _refine_dots_plain within the refine
    limit 2^-20 S, for each source and sharing pattern; each launch is
    counted under its body."""
    tidx, queries, db, scales = _k2_case(dev, src, sharing, qp, m, d)
    key = cuda_kernels._REFINE_SRC[db.dtype][1]
    assert cuda_kernels.refine_body(db, queries) == "tile_major"
    before = dict(cuda_kernels.routes[key])
    got = ck._refine_dots(tidx, queries, db, m, scales)
    want = ck._refine_dots_plain(tidx, queries, db, m, scales)
    torch.cuda.synchronize()
    assert cuda_kernels.routes[key]["tile_major"] == before["tile_major"] + 1
    lim = _refine_limit(db, scales, queries)
    assert got.shape == (qp, m * 16)
    assert float((got - want).abs().max()) <= lim


@pytest.mark.parametrize("src", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("shape", ["unaligned", "ragged", "too_wide"])
def test_k2_query_major_shapes_match_plain(dev, src, shape):
    """The shapes the tile-major body cannot take run query_major: rows one
    element off 16-byte alignment, a d whose lane reads would not stay
    aligned (37), and a tile too large for two stages (f32 d=2048, bf16
    4096, int8 8192)."""
    d = {"unaligned": 768, "ragged": 37,
         "too_wide": {"f32": 2048, "bf16": 4096, "int8": 8192}[src]}[shape]
    tidx, queries, db, scales = _k2_case(dev, src, "random", 9, 33, d)
    if shape == "unaligned":
        buf = torch.empty((db.numel() + 16,), dtype=db.dtype, device=dev)
        db = buf[1:1 + db.numel()].view_as(db).copy_(db)
    key = cuda_kernels._REFINE_SRC[db.dtype][1]
    assert cuda_kernels.refine_body(db, queries) == "query_major"
    before = dict(cuda_kernels.routes[key])
    got = ck._refine_dots(tidx, queries, db, 33, scales)
    want = ck._refine_dots_plain(tidx, queries, db, 33, scales)
    torch.cuda.synchronize()
    assert (cuda_kernels.routes[key]["query_major"]
            == before["query_major"] + 1)
    lim = _refine_limit(db, scales, queries)
    assert float((got - want).abs().max()) <= lim


@pytest.mark.parametrize("n", [256, 1 << 16])
@pytest.mark.parametrize("mode", MODES)
def test_k6_wgmma_matches_plain_and_mma_sync(dev, n, mode):
    """K6 on the wgmma body (its route at d=768) against its plain version
    within the coarse limit, and its tile minima equal to the mma.sync
    body's bit for bit on every live tile, at Q=4096."""
    db, hi, _, queries, terms, bound, _ = _operands(dev, n, 768, 4096, mode,
                                                    seed=12)
    qThi, _, _, _, qrow, col, inv = terms
    assert cuda_kernels.coarse_body("mirrors", hi, 1, False) == "wgmma"
    before = dict(cuda_kernels.routes["coarse_minima_1p"])
    got = cuda_kernels.coarse_minima_1p(qThi, qrow, hi, col, inv, mode)
    other, _ = cuda_kernels.coarse_minima_mma_sync(
        "mirrors", qThi, None, qrow, hi, None, None, col, inv, mode, 1,
        False)
    want = ck._coarse_minima_1p_plain(qThi, qrow, hi, col, inv, mode)
    torch.cuda.synchronize()
    assert (cuda_kernels.routes["coarse_minima_1p"]["wgmma"]
            == before["wgmma"] + 1)
    assert _live_err(got.T, want) <= bound
    live = other < 1e29
    assert torch.equal(got[live], other[live])


def _int8_rows(db):
    """(codes int8, scales (N,) f32, stored f32 rows) of pow2-scaled int8
    storage (index/flat._int8_codes_scales of the quantized rows)."""
    from vectordb_tpu_torch.index.flat import (_int8_codes_scales,
                                               _quantize_int8)
    codes, scales = _int8_codes_scales(_quantize_int8(db.cpu().numpy()))
    codes = torch.from_numpy(codes).to(db.device)
    scales = torch.from_numpy(scales).to(db.device)
    return codes, scales, codes.float() * scales[:, None]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n, d, q", [(4096, 768, 100), (1024, 40, 7)])
def test_k4_k7_match_plain(dev, mode, n, d, q):
    """K4 (f32 rows rounded on chip) and K7 (int8 codes x pow2 scales)
    against their plain versions; every launch is counted."""
    db, _, _, queries, _, bound, _ = _operands(dev, n, d, q, mode, seed=7)
    codes, scales, stored = _int8_rows(db)
    for src, arr, rows in (("f32", db, db), ("int8", codes, stored)):
        sq = (rows * rows).sum(1)
        valid = torch.from_numpy(
            np.random.default_rng(1).random(n) >= 0.1).to(dev)
        qThi, _, _, qn, qrow, col, inv = ck._query_terms(
            queries, sq, torch.sqrt(sq), valid, mode)
        sc = scales.reshape(1, -1) if src == "int8" else None
        key = {"f32": "coarse_minima_f32_1p_sup",
               "int8": "coarse_minima_int8_1p_sup"}[src]
        before = cuda_kernels.launches[key]
        t_k, s_k = ck._minima_1p_sup(qThi, qrow, arr, col, inv, mode, src,
                                     sc)
        t_p, s_p = ck._minima_1p_sup_plain(qThi, qrow, arr, col, inv, mode,
                                           src, sc)
        torch.cuda.synchronize()
        assert cuda_kernels.launches[key] == before + 1
        lim = 2.0 ** -16 * (1.0 if mode == "cosine" else
                            float(torch.sqrt(sq.max())) * float(qn.max()))
        assert t_k.shape == (n // 16, q) and s_k.shape == (n // 256, q)
        assert _live_err(t_k, t_p) <= lim, src
        assert _live_err(s_k, s_p) <= lim, src


@pytest.mark.parametrize("passes", [3, 1])
@pytest.mark.parametrize("mode", MODES)
def test_k5_k6_match_plain(dev, mode, passes):
    db, hi, _, queries, terms, bound, _ = _operands(dev, 2048, 768, 65,
                                                    mode, seed=8)
    qThi, qlo, _, _, qrow, col, inv = terms
    qTlo = qlo.to(torch.bfloat16)
    got = ck._coarse_minima_f32(qThi, qTlo, qrow, db, col, inv, passes, mode)
    want = ck._coarse_minima_f32_plain(qThi, qTlo, qrow, db, col, inv,
                                       passes, mode)
    got6 = ck._coarse_minima_1p(qThi, qrow, hi, col, inv, mode)
    want6 = ck._coarse_minima_1p_plain(qThi, qrow, hi, col, inv, mode)
    torch.cuda.synchronize()
    assert got.shape == (65, 2048 // 16)
    assert _live_err(got, want) <= bound
    assert _live_err(got6, want6) <= bound


@pytest.mark.parametrize("d", [768, 37])
def test_k2_bf16_int8_match_plain(dev, d):
    db, hi, _, queries, _, _, dot_b = _operands(dev, 4096, d, 9, "dot",
                                                seed=9)
    codes, scales, stored = _int8_rows(db)
    tidx = torch.from_numpy(np.random.default_rng(10).integers(
        0, 4096 // 16, (9, 33))).to(dev)
    for rows, sc, key in ((hi, None, "refine_dots_bf16"),
                          (codes, scales, "refine_dots_int8")):
        before = cuda_kernels.launches[key]
        got = ck._refine_dots(tidx, queries, rows, 33, sc)
        want = ck._refine_dots_plain(tidx, queries, rows, 33, sc)
        torch.cuda.synchronize()
        assert cuda_kernels.launches[key] == before + 1
        assert float((got - want).abs().max()) <= dot_b, key


@pytest.mark.parametrize("mode", MODES)
def test_controls_break_the_limits(dev, mode):
    """Each limit must reject a kernel that breaks the arithmetic the
    certificates assume: K3 run at 1 pass instead of 3, K1 with its dots
    rounded to bf16, K2 on TF32 operands."""
    db, hi, lo, queries, terms, bound, dot_b = _operands(dev, 4096, 768,
                                                         64, mode, seed=5)
    qThi, qlo, _, _, qrow, col, inv = terms
    qTlo = qlo.to(torch.bfloat16)
    want3 = ck._coarse_minima_plain(qThi, qTlo, qrow, hi, lo, col, inv, 3,
                                    mode)
    one_pass = ck._coarse_minima(qThi, qTlo, qrow, hi, lo, col, inv, 1, mode)
    assert _live_err(one_pass, want3) > bound
    want1 = ck._coarse_minima_plain(qThi, qTlo, qrow, hi, lo, col, inv, 1,
                                    mode)
    dots = (hi.float() @ qThi.float()).to(torch.bfloat16).float()
    rounded = ck._score_plain(dots, qrow, col, inv, mode)
    rounded = rounded.reshape(-1, ck.SUB, 64).amin(dim=1).T
    assert _live_err(rounded, want1) > bound
    tf32 = lambda x: ((x.view(torch.int32) + 0x1000)  # noqa: E731
                      & ~0x1FFF).view(torch.float32)
    tidx = torch.from_numpy(np.random.default_rng(6).integers(
        0, 4096 // 16, (64, 32))).to(dev)
    exact = ck._refine_dots_plain(tidx, queries, db, 32)
    assert float((ck._refine_dots_plain(tidx, tf32(queries), tf32(db), 32)
                  - exact).abs().max()) > dot_b


def test_wrappers_check_their_inputs(dev):
    db, hi, _, queries, terms, _, _ = _operands(dev, 512, 64, 4, "dot")
    qThi, _, _, _, qrow, col, inv = terms
    with pytest.raises(ValueError, match="multiple"):
        cuda_kernels.coarse_minima_1p_sup(qThi, qrow, hi[:500], col[:, :500],
                                          inv[:, :500], "dot")
    with pytest.raises(ValueError, match="contiguous"):
        cuda_kernels.refine_dots(
            torch.zeros((8, 4), dtype=torch.int64, device=dev)[:4],
            queries.T.contiguous().T, db, 4)


@pytest.mark.parametrize("storage", ["f32", "bf16", "int8", "f32_big"])
@pytest.mark.parametrize("metric", list(DistanceMetric))
def test_store_on_card_matches_store_on_cpu(dev, metric, storage,
                                            monkeypatch):
    from vectordb_tpu_torch.index import flat
    from vectordb_tpu_torch.ops import topk
    monkeypatch.setattr(topk, "_EXACT1P_MIN_N", 512)
    if storage == "f32_big":      # past the mirror gate: K4 / K5 serve
        monkeypatch.setattr(flat, "_MIRROR_MEM_LIMIT", 1000)
    rng = np.random.default_rng(4)
    rows = rng.standard_normal((3000, 128), dtype=np.float32)
    qs = rng.standard_normal((16, 128), dtype=np.float32)
    out = []
    for device in ("cuda", "cpu"):
        s = VectorStore.with_flat_index(
            metric, storage=storage.replace("_big", ""), device=device)
        s.insert_batch([BatchInsertItem(str(i), Vector(rows[i]))
                        for i in range(3000)])
        res = s.search_batch([(Vector(q), 10) for q in qs])
        out.append(([[r.id for r in row] for row in res],
                    [[r.distance for r in row] for row in res]))
    assert out[0][0] == out[1][0]
    np.testing.assert_allclose(out[0][1], out[1][1], rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("metric", [DistanceMetric.COSINE,
                                    DistanceMetric.EUCLIDEAN])
def test_forced_tier2_on_card_counts_and_stays_exact(dev, metric,
                                                     monkeypatch):
    """Tier 1's coefficient inflated on the card: its certificate holds
    for no query, the counters put every query into tier 2 (K3, then the
    plain scan for any it leaves), and the answers are still the plain
    reference's exact top-k (float64)."""
    from vdbbench.references import exact_topk
    from vectordb_tpu_torch.ops import topk
    from vectordb_tpu_torch.utils import profiling
    monkeypatch.setattr(topk, "_EXACT1P_MIN_N", 512)
    real = ck._coarse_body
    monkeypatch.setattr(ck, "_coarse_body",
                        lambda src, arr, passes, *a: "forced"
                        if passes == 1 else real(src, arr, passes, *a))
    monkeypatch.setitem(ck._ACCUM_COEFF, "forced", 1e6)
    rng = np.random.default_rng(6)
    rows = rng.standard_normal((4096, 128), dtype=np.float32)
    qs = rng.standard_normal((16, 128), dtype=np.float32)
    s = VectorStore.with_flat_index(metric, device="cuda")
    s.insert_batch([BatchInsertItem(str(i), Vector(rows[i]))
                    for i in range(len(rows))])
    profiling.reset_spans()
    res = s.search_batch([(Vector(q), 10) for q in qs])
    got = profiling.counters()
    assert got["flat.queries"] == 16 and got["flat.tier2_queries"] == 16
    assert "vdb/flat.tier2" in profiling.spans()
    ref_d, ref_i = exact_topk.topk(torch.from_numpy(qs),
                                   torch.from_numpy(rows),
                                   metric.value, 10, "f64")
    assert [[int(r.id) for r in row] for row in res] == ref_i.tolist()
    # f32 distances of the named rows (test_torch_flat_ladder.py's limit)
    np.testing.assert_allclose([[r.distance for r in row] for row in res],
                               ref_d.numpy(), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# K8 (PQ decode) and K9 (per-tile minima); the PQ store and the two-phase
# scan on the card against the same on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows, m, dsub, ksub", [
    (16384, 96, 8, 256), (1000, 16, 16, 256), (333, 768, 1, 7),
    (77, 3, 5, 200), (50, 192, 4, 256)])
def test_k8_matches_plain_bitwise(dev, rows, m, dsub, ksub):
    from vectordb_tpu_torch.ops import pq
    rng = np.random.default_rng(11)
    cb = torch.from_numpy(rng.standard_normal((m, ksub, dsub)).astype(
        np.float32)).to(dev).to(torch.bfloat16)
    codes = torch.from_numpy(rng.integers(0, ksub, (rows, m),
                                          dtype=np.uint8)).to(dev)
    before = cuda_kernels.launches["pq_decode"]
    got = pq.pq_decode_rows(codes, cb)
    want = pq._decode_rows_plain(codes, cb)
    torch.cuda.synchronize()
    assert cuda_kernels.launches["pq_decode"] == before + 1
    assert got.shape == (rows, m * dsub)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


def _k8_operands(dev, rows, m, ksub, dsub, seed=12):
    rng = np.random.default_rng(seed)
    cb = torch.from_numpy(rng.standard_normal((m, ksub, dsub)).astype(
        np.float32)).to(dev).to(torch.bfloat16)
    codes = torch.from_numpy(rng.integers(0, ksub, (rows, m),
                                          dtype=np.uint8)).to(dev)
    return codes, cb


@pytest.mark.parametrize("rows", [1, 15, 16385])
@pytest.mark.parametrize("dsub", [2, 4, 8, 16])
@pytest.mark.parametrize("ksub", [1, 16, 256])
def test_k8_bodies_match_plain_bitwise(dev, rows, dsub, ksub):
    """The routed body (tile_ring for dsub % 8 == 0, grid_stride
    otherwise) and grid_stride through its own entry point, each bit for
    bit the plain decode at ragged row counts."""
    from vectordb_tpu_torch.ops import pq
    m = 7 if rows == 15 else 96
    codes, cb = _k8_operands(dev, rows, m, ksub, dsub)
    body = "tile_ring" if dsub % 8 == 0 else "grid_stride"
    before = dict(cuda_kernels.routes["pq_decode"])
    got = cuda_kernels.pq_decode(codes, cb)
    other = cuda_kernels.pq_decode_grid_stride(codes, cb)
    want = pq._decode_rows_plain(codes, cb).view(torch.int16)
    torch.cuda.synchronize()
    assert cuda_kernels.routes["pq_decode"][body] == before[body] + 1
    assert torch.equal(got.view(torch.int16), want)
    assert torch.equal(other.view(torch.int16), want)


def test_k8_unaligned_views_take_grid_stride(dev):
    """A codes view or a codebook view off 16-byte alignment runs
    grid_stride; aligned operands run tile_ring; each bit for bit the
    plain decode."""
    from vectordb_tpu_torch.ops import pq
    rows, m, ksub, dsub = 1000, 96, 256, 8
    codes, cb = _k8_operands(dev, rows, m, ksub, dsub)
    want = pq._decode_rows_plain(codes, cb).view(torch.int16)
    cbuf = torch.zeros(rows * m + 16, dtype=torch.uint8, device=dev)
    cbuf[1:rows * m + 1] = codes.reshape(-1)
    bbuf = torch.zeros(cb.numel() + 8, dtype=torch.bfloat16, device=dev)
    bbuf[1:cb.numel() + 1] = cb.reshape(-1)
    for src, book, body in ((cbuf[1:rows * m + 1].view(rows, m), cb,
                             "grid_stride"),
                            (codes, bbuf[1:cb.numel() + 1].view(cb.shape),
                             "grid_stride"),
                            (codes, cb, "tile_ring")):
        assert cuda_kernels.decode_body(src, book) == body
        before = cuda_kernels.routes["pq_decode"][body]
        got = cuda_kernels.pq_decode(src, book)
        torch.cuda.synchronize()
        assert cuda_kernels.routes["pq_decode"][body] == before + 1
        assert torch.equal(got.view(torch.int16), want)


def test_k8_stream_lookup_is_torchs_current_stream(dev):
    """K8's launcher reads the current stream by torch's private raw
    lookup: it must exist and name the stream the public API names, on
    the default stream and inside a side stream."""
    assert hasattr(torch._C, "_cuda_getCurrentRawStream")
    for d in (dev, torch.device("cuda")):
        assert (cuda_kernels._raw_stream(d)
                == torch.cuda.current_stream(d).cuda_stream)
    side = torch.cuda.Stream(device=dev)
    with torch.cuda.stream(side):
        assert cuda_kernels._raw_stream(dev) == side.cuda_stream


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n, d, q, tile_rows", [
    (4096, 768, 100, 512), (2048, 40, 7, 128), (1024, 64, 130, 64),
    (2048, 37, 65, 128),                # ragged d: 4-byte copies
    (4096, 96, 1, 16),                  # one query; 8 tiles a 128-row step
    (8192, 48, 1029, 2048),             # ragged query blocks; 16 steps a tile
    (1000, 40, 33, 100)])               # tiles that straddle 128-row steps
def test_k9_matches_plain(dev, mode, n, d, q, tile_rows):
    """K9 against its plain version within 2^-18 S; a control on bf16
    operands breaks it (chip_smoke.py's K9_LIMIT and its readings)."""
    from vectordb_tpu_torch.ops import flat_kernel as fk
    rng = np.random.default_rng(12)
    db = torch.from_numpy(rng.standard_normal((n, d)).astype(
        np.float32)).to(dev)
    qs = torch.from_numpy(rng.standard_normal((q, d)).astype(
        np.float32)).to(dev)
    inv = torch.from_numpy((rng.random(n) < 0.1).astype(np.float32)).to(dev)
    sq, qsq = (db * db).sum(1), (qs * qs).sum(1)
    qa, ra = {"euclidean": (qsq, sq),
              "dot": (torch.zeros_like(qsq), torch.zeros_like(sq)),
              "cosine": (torch.sqrt(qsq), torch.sqrt(sq))}[mode]
    before = cuda_kernels.launches["scan_min"]
    got = fk.tile_minima(qs, qa, db, ra, inv, mode, tile_rows)
    want = fk._tile_minima_plain(qs, qa, db, ra, inv, mode, tile_rows)
    ctrl = fk._tile_minima_plain(qs.bfloat16().float(), qa,
                                 db.bfloat16().float(), ra, inv, mode,
                                 tile_rows)
    torch.cuda.synchronize()
    assert cuda_kernels.launches["scan_min"] == before + 1
    assert got.shape == (q, n // tile_rows)
    s = 1.0 if mode == "cosine" else float(torch.sqrt(sq.max() * qsq.max()))
    limit = 2.0 ** -18 * s
    assert _live_err(got, want) <= limit
    assert _live_err(ctrl, want) > limit


def test_score_gemm_is_f32_on_card(dev):
    from vectordb_tpu_torch.ops import pq
    rng = np.random.default_rng(13)
    q = torch.from_numpy(rng.standard_normal((64, 768)).astype(
        np.float32)).to(dev)
    dec = torch.from_numpy(rng.standard_normal((500, 768)).astype(
        np.float32)).to(dev).to(torch.bfloat16)
    q_hi, q_lo = pq._split_query(q)
    dots = pq._score_dots(q_hi, q_lo, dec)
    assert dots.dtype == torch.float32
    exact = (q_hi.double() + q_lo.double()) @ dec.double().T
    assert float((dots.double() - exact).abs().max()) <= 1e-5 * float(
        exact.abs().max())


@pytest.mark.parametrize("metric", list(DistanceMetric))
def test_pq_store_on_card_matches_store_on_cpu(dev, metric):
    """One trained state and one set of codes (trained and encoded on the
    card) on both devices: same ids, distances at rtol 2e-5 (the card
    re-ranks on its "mirror" venue, the CPU on the host)."""
    from vectordb_tpu_torch import PqFlatIndex
    rng = np.random.default_rng(14)
    rows = rng.standard_normal((3000, 64), dtype=np.float32) + (
        2.0 if metric is DistanceMetric.COSINE else 0.0)
    qs = rng.standard_normal((16, 64), dtype=np.float32)
    card = PqFlatIndex(metric, m=16, ksub=64, refine=64, device="cuda")
    cpu = PqFlatIndex(metric, m=16, ksub=64, refine=64, device="cpu")
    for idx in (card, cpu):
        idx.add_batch([(i, rows[i]) for i in range(3000)])
    card.train()
    before = cuda_kernels.launches["pq_decode"]
    want = card.search_batch(qs, 10)
    assert cuda_kernels.launches["pq_decode"] > before
    assert card._rerank_venue() == "mirror"
    cpu.import_trained_state(card.export_trained_state())
    cpu.adopt_codes(card._codes)
    got = cpu.search_batch(qs, 10)
    for w, g in zip(want, got):
        assert [i for i, _ in g] == [i for i, _ in w]
        np.testing.assert_allclose([x for _, x in g], [x for _, x in w],
                                   rtol=2e-5, atol=1e-6)


@pytest.mark.parametrize("rotate", [False, True])
@pytest.mark.parametrize("metric", list(DistanceMetric))
def test_ivfpq_scan_on_card_matches_cpu(dev, metric, rotate):
    """ivfpq_scan_topr on the card (this shape's route: K8s, one launch,
    no K8) and on the CPU (the plain decode, operands widened to f32):
    scores within 2e-6 of max|score|, each slot scored alike on both, the
    same slots but where neighbouring scores tie within that (the devices
    sum in their own orders); a tail chunk and a spill region."""
    from vectordb_tpu_torch.ops import pq
    rng = np.random.default_rng(16)
    m, dsub, ksub, nlist, cpc, span, s_rows = 96, 8, 256, 10, 3, 64, 96
    d = m * dsub
    cb = torch.from_numpy(rng.standard_normal(
        (m, ksub, dsub), dtype=np.float32) * 0.3).to(torch.bfloat16)
    n = nlist * span + s_rows
    codes = torch.from_numpy(rng.integers(0, ksub, (n, m), dtype=np.uint8))
    valid = torch.from_numpy(rng.random(n) >= 0.1)
    cents = torch.from_numpy(rng.standard_normal(
        (nlist, d), dtype=np.float32)).to(torch.bfloat16).float()
    csq = (cents * cents).sum(1)
    cid_sp = torch.from_numpy(rng.integers(0, nlist, s_rows).astype(np.int32))
    qs = torch.from_numpy(rng.standard_normal((64, d), dtype=np.float32))
    rot = (torch.linalg.qr(torch.from_numpy(rng.standard_normal(
        (d, d), dtype=np.float32)))[0].contiguous() if rotate else None)
    cnorm = (cb.float() ** 2).sum(-1)
    out = []
    for device in ("cuda", "cpu"):
        args = [t.to(device) for t in (qs, codes, cb, cnorm, valid, cents,
                                       csq, cid_sp)]
        before = cuda_kernels.launches["pq_decode"]
        routes = dict(cuda_kernels.routes["ivfpq_scan"])
        sv, sl = pq.ivfpq_scan_topr(*args, metric, r=64, cpc=cpc, span=span,
                                    nlist=nlist, rot=None if rot is None
                                    else rot.to(device))
        if device == "cuda":
            if cuda_kernels.ivfpq_scan_body(args[1], args[2]) == "fused":
                # one launch for the 64 queries, no K8
                assert cuda_kernels.launches["pq_decode"] == before
                assert cuda_kernels.routes["ivfpq_scan"]["fused"] == (
                    routes["fused"] + 1)
            else:
                # three full chunks, the tail, the spill block
                assert cuda_kernels.launches["pq_decode"] == before + 5
        out.append((sv.cpu(), sl.cpu()))
    scale = float(out[1][0][torch.isfinite(out[1][0])].abs().max())
    tol = 2e-6 * scale
    torch.testing.assert_close(out[0][0], out[1][0], rtol=2e-6, atol=tol)
    for (sv_c, sl_c), (sv_p, sl_p) in zip(zip(*out[0]), zip(*out[1])):
        card_of = dict(zip(sl_c.tolist(), sv_c.tolist()))
        cpu_of = dict(zip(sl_p.tolist(), sv_p.tolist()))
        for slot in card_of.keys() & cpu_of.keys():
            assert abs(card_of[slot] - cpu_of[slot]) <= 2 * tol
        for slot in card_of.keys() ^ cpu_of.keys():
            # a slot only one device kept ties the last kept score
            score = card_of.get(slot, cpu_of.get(slot))
            assert abs(score - float(sv_p[-1])) <= 2 * tol


def _ivfpq_scan_operands(q, dsub=8, seed=16, d=768):
    """test_ivfpq_scan_on_card_matches_cpu's geometry (three full chunks
    of three 64-row clusters, a tail cluster, 96 spill slots, 10% dead)
    at ``q`` queries and codewords of ``dsub`` dims (d = 768)."""
    rng = np.random.default_rng(seed)
    m, ksub, nlist, span, s_rows = d // dsub, 256, 10, 64, 96
    d = m * dsub
    cb = torch.from_numpy(rng.standard_normal(
        (m, ksub, dsub), dtype=np.float32) * 0.3).to(torch.bfloat16)
    n = nlist * span + s_rows
    codes = torch.from_numpy(rng.integers(0, ksub, (n, m), dtype=np.uint8))
    valid = torch.from_numpy(rng.random(n) >= 0.1)
    cents = torch.from_numpy(rng.standard_normal(
        (nlist, d), dtype=np.float32)).to(torch.bfloat16).float()
    csq = (cents * cents).sum(1)
    cid_sp = torch.from_numpy(rng.integers(0, nlist, s_rows).astype(np.int32))
    qs = torch.from_numpy(rng.standard_normal((q, d), dtype=np.float32))
    cnorm = (cb.float() ** 2).sum(-1)
    return (qs, codes, cb, cnorm, valid, cents, csq, cid_sp), nlist, span


def _check_scan_pools(got, want):
    """Two scans' pools: scores within 2e-6 of max|score|, each slot
    scored alike, the same slots but where neighbouring scores tie."""
    scale = float(want[0][torch.isfinite(want[0])].abs().max())
    tol = 2e-6 * scale
    torch.testing.assert_close(got[0], want[0], rtol=2e-6, atol=tol)
    for (sv_c, sl_c), (sv_p, sl_p) in zip(zip(*got), zip(*want)):
        card_of = dict(zip(sl_c.tolist(), sv_c.tolist()))
        cpu_of = dict(zip(sl_p.tolist(), sv_p.tolist()))
        for slot in card_of.keys() & cpu_of.keys():
            assert abs(card_of[slot] - cpu_of[slot]) <= 2 * tol
        for slot in card_of.keys() ^ cpu_of.keys():
            score = card_of.get(slot, cpu_of.get(slot))
            assert abs(score - float(sv_p[-1])) <= 2 * tol


@pytest.mark.parametrize("q, budget_q, blocks", [
    (1, None, 1), (63, None, 1), (64, None, 1), (200, None, 1),
    (200, 48, 5)])
@pytest.mark.parametrize("rotate", [False, True])
@pytest.mark.parametrize("metric", list(DistanceMetric))
def test_ivfpq_fused_scan_matches_cpu(dev, metric, rotate, q, budget_q,
                                      blocks, monkeypatch):
    """K8s at query counts that fill one n-tile, part of one, one block's
    eight and several query tiles in one launch; with the score budget
    forced to 48 queries, 200 queries in five launches (48 x 4 + 8): the
    pool is the CPU chunk loop's, one fused launch a query block, no K8
    and no chunked scan."""
    from vectordb_tpu_torch.ops import pq
    args, nlist, span = _ivfpq_scan_operands(q)
    d = args[0].shape[1]
    rng = np.random.default_rng(3)
    rot = (torch.linalg.qr(torch.from_numpy(rng.standard_normal(
        (d, d), dtype=np.float32)))[0].contiguous() if rotate else None)
    if budget_q is not None:
        monkeypatch.setattr(pq, "_SCAN_SCORE_BYTES",
                            4 * args[1].shape[0] * budget_q)
    out = []
    for device in ("cuda", "cpu"):
        cuda_kernels.reset_launches()
        sv, sl = pq.ivfpq_scan_topr(
            *[t.to(device) for t in args], metric, r=64, cpc=3, span=span,
            nlist=nlist, rot=None if rot is None else rot.to(device))
        if device == "cuda":
            torch.cuda.synchronize()
            assert cuda_kernels.routes["ivfpq_scan"] == {"fused": blocks,
                                                         "chunked": 0}
            assert cuda_kernels.launches["ivfpq_scan"] == blocks
            # one selection launch a block: 1056 slots are one segment
            assert cuda_kernels.launches["scan_select"] == blocks
            assert cuda_kernels.launches["pq_decode"] == 0
        out.append((sv.cpu(), sl.cpu()))
    assert out[0][0].shape == (q, 64) and out[0][1].dtype == torch.int64
    _check_scan_pools(out[0], out[1])


@pytest.mark.parametrize("n, k, dead, distinct", [
    (50000, 128, 0.1, None), (50000, 1, 0.1, None), (40000, 1000, 0.1, None),
    (16384, 64, 0.1, None), (100, 128, 0.1, None), (128, 128, 0.1, None),
    (40000, 128, 0.995, None), (40000, 128, 0.0, 1), (40000, 700, 0.0, 1)])
def test_scan_select_matches_plain(dev, n, k, dead, distinct):
    """K8s's selection against its plain version (torch.topk a segment):
    clustered scores with exact ties, +inf dead slots, -0 and +0 and a
    negative run; segments longer, shorter and as long as k, mostly dead
    ones (at most k finite keys), one value in bulk (no sample threshold:
    the radix passes); with and without a payload. Equal values; the same
    (value, slot) pairs but where a value ties a segment's last."""
    from vectordb_tpu_torch.ops import pq
    rng = np.random.default_rng(n + k)
    x = (50.0 + rng.standard_normal((3, n))).astype(np.float32)
    if distinct is not None:
        x = np.ascontiguousarray(x[:, :distinct][:, rng.integers(
            0, distinct, n)])
    x[:, ::7] = x[:, 3:4]
    x[rng.random((3, n)) < dead] = np.inf
    x[:, 1], x[:, 2], x[0, :5] = -0.0, 0.0, -3.0
    keys = torch.from_numpy(x).to(dev)
    pay = torch.from_numpy(rng.permutation(3 * n).reshape(3, n)).to(dev)
    for p in (None, pay):
        before = cuda_kernels.launches["scan_select"]
        got = cuda_kernels.scan_select(keys, k, p)
        torch.cuda.synchronize()
        assert cuda_kernels.launches["scan_select"] == before + 1
        want = pq._select_plain(keys, k, p)
        torch.testing.assert_close(got[0], want[0], rtol=0, atol=0,
                                   equal_nan=True)
        for gv, gi, wv, wi in zip(got[0].tolist(), got[1].tolist(),
                                  want[0].tolist(), want[1].tolist()):
            for a in range(0, len(wv), k):
                last = wv[a + k - 1]
                g = sorted(zip(gv[a:a + k], gi[a:a + k]), key=str)
                w = sorted(zip(wv[a:a + k], wi[a:a + k]), key=str)
                keep = lambda pairs: [(v, i) for v, i in pairs  # noqa
                                      if v == v and v != last]
                assert keep(g) == keep(w)
    v, i = pq._select_topr(keys, min(k, n))
    want = torch.topk(keys, min(k, n), dim=1, largest=False)
    assert torch.equal(v, want.values)
    assert torch.equal(torch.gather(keys, 1, i), v)


@pytest.mark.parametrize("metric", list(DistanceMetric))
def test_ivfpq_fused_scan_wide_rows_take_the_small_tile(dev, metric):
    """d = 1536: 64 queries do not fit one block's shared memory, so 40
    queries go as three tiles of 16 in one launch; the pool is the CPU's."""
    from vectordb_tpu_torch.ops import pq
    args, nlist, span = _ivfpq_scan_operands(40, d=1536)
    assert cuda_kernels._scan_tile(40, 1536, 192) == 2
    out = []
    for device in ("cuda", "cpu"):
        cuda_kernels.reset_launches()
        sv, sl = pq.ivfpq_scan_topr(*[t.to(device) for t in args], metric,
                                    r=64, cpc=3, span=span, nlist=nlist)
        if device == "cuda":
            assert cuda_kernels.routes["ivfpq_scan"] == {"fused": 1,
                                                         "chunked": 0}
        out.append((sv.cpu(), sl.cpu()))
    _check_scan_pools(out[0], out[1])


@pytest.mark.parametrize("metric", list(DistanceMetric))
def test_ivfpq_scan_outside_the_envelope_runs_the_chunk_loop(dev, metric):
    """Codewords of 4 dims (dsub % 8 != 0): the chunked route, counted as
    one chunked scan and five K8 launches (three chunks, the tail, the
    spill block), the same pool as the CPU's."""
    from vectordb_tpu_torch.ops import pq
    args, nlist, span = _ivfpq_scan_operands(64, dsub=4)
    out = []
    for device in ("cuda", "cpu"):
        cuda_kernels.reset_launches()
        t = [a.to(device) for a in args]
        if device == "cuda":
            assert cuda_kernels.ivfpq_scan_body(t[1], t[2]) == "chunked"
        sv, sl = pq.ivfpq_scan_topr(*t, metric, r=64, cpc=3, span=span,
                                    nlist=nlist)
        if device == "cuda":
            assert cuda_kernels.routes["ivfpq_scan"] == {"fused": 0,
                                                         "chunked": 1}
            assert cuda_kernels.launches["pq_decode"] == 5
        out.append((sv.cpu(), sl.cpu()))
    _check_scan_pools(out[0], out[1])


@pytest.mark.parametrize("metric", list(DistanceMetric))
def test_ivfpq_fused_scan_matches_the_chunk_loop_on_card(dev, metric):
    """The two routes over the same CUDA tensors: K8s's pool and the chunk
    loop's (K8 and the library products) agree as the card and the CPU
    do."""
    from vectordb_tpu_torch.ops import pq
    args, nlist, span = _ivfpq_scan_operands(64, seed=21)
    t = [a.to(dev) for a in args]
    fused = pq.ivfpq_scan_topr(*t, metric, r=64, cpc=3, span=span,
                               nlist=nlist)
    chunked = pq._ivfpq_scan_chunked(*t, metric, r=64, cpc=3, span=span,
                                     nlist=nlist)
    _check_scan_pools(tuple(x.cpu() for x in fused),
                      tuple(x.cpu() for x in chunked))


@pytest.mark.parametrize("metric", list(DistanceMetric))
def test_ivfpq_store_on_card_matches_store_on_cpu(dev, metric):
    """One trained IVF-PQ state (trained on the card) on both devices: the
    same ids, distances at rtol 2e-5 (the card re-ranks on its "mirror"
    venue, the CPU on the host)."""
    from vectordb_tpu_torch import IvfPqIndex
    rng = np.random.default_rng(17)
    centers = rng.standard_normal((32, 64), dtype=np.float32)
    rows = centers[rng.integers(0, 32, 4000)] + 0.3 * rng.standard_normal(
        (4000, 64), dtype=np.float32) + (
        2.0 if metric is DistanceMetric.COSINE else 0.0)
    qs = rows[:16] + 0.05
    card = IvfPqIndex(metric, nlist=32, m=16, ksub=64, refine=64,
                      device="cuda")
    card.add_batch([(i, rows[i]) for i in range(4000)])
    card.train()
    before = cuda_kernels.launches["pq_decode"]
    want = card.search_batch(qs, 10)
    assert cuda_kernels.launches["pq_decode"] > before
    assert card._rerank_venue() == "mirror"
    cpu = IvfPqIndex(metric, nlist=32, m=16, ksub=64, refine=64,
                     device="cpu")
    cpu.import_trained_state(card.export_trained_state(),
                             {i: rows[i] for i in range(4000)}, 64)
    got = cpu.search_batch(qs, 10)
    for w, g in zip(want, got):
        assert [i for i, _ in g] == [i for i, _ in w]
        np.testing.assert_allclose([x for _, x in g], [x for _, x in w],
                                   rtol=2e-5, atol=1e-6)


@pytest.mark.parametrize("metric", ["euclidean", "dot_product", "cosine"])
def test_two_phase_on_card_matches_cpu(dev, metric):
    from vectordb_tpu_torch.ops import flat_kernel as fk
    rng = np.random.default_rng(15)
    db = rng.standard_normal((4096, 96), dtype=np.float32) + 0.5
    qs = rng.standard_normal((20, 96), dtype=np.float32) + 0.5
    valid = rng.random(4096) >= 0.1
    sq = (db * db).sum(1)
    out = []
    for device in ("cuda", "cpu"):
        t = [torch.from_numpy(x).to(device)
             for x in (qs, db, sq, np.sqrt(sq), valid)]
        d_, i_ = fk.two_phase_search(*t, metric, 10, tile_rows=512)
        out.append((d_.cpu().numpy(), i_.cpu().numpy()))
    np.testing.assert_array_equal(out[0][1], out[1][1])
    np.testing.assert_allclose(out[0][0], out[1][0], rtol=2e-5, atol=1e-6)


@pytest.mark.parametrize("when", ["during_build", "after_install"])
def test_search_while_prehydrate_runs(dev, when, monkeypatch):
    """The recovery overlap on the card: ``prehydrate`` builds the device
    state on a side thread and its own stream. A search issued while the
    build runs (it builds its own state under the lock) and one issued
    right after the side thread installed its state, on another stream,
    while the build's last kernels are still queued behind a sleep (it
    waits on the build's event), both return the oracle's ids."""
    import threading
    import time

    from vectordb_tpu_torch.index.flat import FlatIndex
    rng = np.random.default_rng(30)
    n, d = 65536, 128
    rows = rng.standard_normal((n, d), dtype=np.float32)
    qs = rng.standard_normal((64, d), dtype=np.float32)
    ix = FlatIndex(DistanceMetric.EUCLIDEAN, device="cuda")
    ix.bulk_append_matrix(np.arange(n, dtype=np.int64), rows)
    real = FlatIndex._build_device_full
    started = threading.Event()

    def slow_build(self):
        started.set()
        if when == "during_build":
            time.sleep(1.0)
            return real(self)
        # the state's last writes queued on the side stream behind ~0.3 s
        # of sleep: installed before the card has written them
        dev = real(self)
        torch.cuda._sleep(int(5e8))
        return {k: v.clone() if isinstance(v, torch.Tensor) else v
                for k, v in dev.items()}

    monkeypatch.setattr(FlatIndex, "_build_device_full", slow_build)
    side = torch.cuda.Stream()

    def hydrate():
        with torch.cuda.stream(side):
            ix.prehydrate()

    t = threading.Thread(target=hydrate)
    t.start()
    started.wait(30)
    if when == "after_install":
        t.join()
        assert ix._device is not None and ix._device_ready is not None
    main = torch.cuda.Stream()
    with torch.cuda.stream(main):
        got = ix.search_batch(qs, 10)
    t.join()
    monkeypatch.setattr(FlatIndex, "_build_device_full", real)
    d2 = ((qs.astype(np.float64)[:, None, :] - rows[None, :, :]) ** 2).sum(-1)
    want = np.argsort(d2, axis=1)[:, :10]
    assert [[i for i, _ in r] for r in got] == want.tolist()
    assert ix._device_ready is None


def test_submit_upsert_collect_across_threads_and_streams(dev):
    """The serving front end's hazard: a search submitted on one thread
    and stream (its kernels queued behind a sleep, so they run late), an
    upsert of every row it should find plus another search on a second
    thread (the copy-scatter path), then the collect on a third thread
    whose current stream is a third one. The collect waits on the
    submit's stream and returns the answers of the rows as they were at
    submit."""
    import threading

    rng = np.random.default_rng(31)
    n, d = 65536, 128
    rows = rng.standard_normal((n, d), dtype=np.float32)
    qs = rows[:32] + np.float32(1e-3)
    store = VectorStore.with_flat_index(DistanceMetric.EUCLIDEAN,
                                        device="cuda")
    store.insert_batch([BatchInsertItem(str(i), Vector(rows[i]))
                        for i in range(n)])
    batch = [(Vector(q), 5) for q in qs]
    want = [[r.id for r in row] for row in store.search_batch(batch)]
    assert [row[0] for row in want] == [str(i) for i in range(32)]
    s_submit, s_collect = torch.cuda.Stream(), torch.cuda.Stream()
    box = {}

    def submit():
        with torch.cuda.stream(s_submit):
            torch.cuda._sleep(int(5e8))
            box["h"] = store.search_batch_submit(batch)

    def upsert():
        for i in range(32):
            store.insert(str(i), Vector(-rows[i] * 50.0))
        box["after"] = [[r.id for r in row]
                        for row in store.search_batch(batch)]

    def collect():
        with torch.cuda.stream(s_collect):
            box["got"] = [[r.id for r in row] for row in box["h"].collect()]

    for fn in (submit, upsert, collect):
        t = threading.Thread(target=fn)
        t.start()
        t.join()
    assert box["got"] == want
    assert all(row[0] != str(i) for i, row in enumerate(box["after"]))


def test_native_server_over_card_store_answers_clients(dev):
    """The native front end over a store on the card: concurrent clients
    (threads here) get the f64 oracle's ids, at depths 1 and 2."""
    import json
    import threading
    import urllib.request

    from vectordb_tpu_torch.server.app import AppState
    from vectordb_tpu_torch.server.native_http import NativeHttpServer
    from vectordb_tpu_torch.server.routes import Api
    rng = np.random.default_rng(32)
    n, d = 65536, 128
    rows = rng.standard_normal((n, d), dtype=np.float32)
    qs = rng.standard_normal((64, d), dtype=np.float32)
    store = VectorStore.with_flat_index(DistanceMetric.EUCLIDEAN,
                                        device="cuda")
    store.insert_batch([BatchInsertItem(str(i), Vector(rows[i]))
                        for i in range(n)])
    d2 = ((qs.astype(np.float64)[:, None, :] - rows[None, :, :]) ** 2).sum(-1)
    want = np.argsort(d2, axis=1)[:, :10]
    for depth in (1, 2):
        srv = NativeHttpServer(Api(AppState(store)), "127.0.0.1", 0,
                               pipeline_depth=depth)
        srv.start_background()
        errors = []

        def client(t):
            try:
                for rep in range(4):
                    qi = (t * 4 + rep) % 64
                    req = urllib.request.Request(
                        f"http://127.0.0.1:{srv.port}/search",
                        data=json.dumps({"vector": qs[qi].tolist(),
                                         "k": 10}).encode(), method="POST",
                        headers={"Content-Type": "application/json"})
                    with urllib.request.urlopen(req, timeout=60) as r:
                        got = [int(h["id"]) for h in json.loads(r.read())]
                    assert got == want[qi].tolist(), (qi, got)
            except Exception as e:  # noqa: BLE001
                errors.append(e)

        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        srv.shutdown()
        assert not errors, errors
        assert sum(srv.drain_sizes) == 64


@pytest.mark.parametrize("nq", [64, 512])
def test_submit_does_not_wait_for_the_card(dev, nq):
    """A submit behind a batch still queued on the card returns before
    that batch has run: the query copy leaves from pinned memory without
    a stream synchronize."""
    import time

    rng = np.random.default_rng(33)
    n, d = 65536, 128
    rows = rng.standard_normal((n, d), dtype=np.float32)
    store = VectorStore.with_flat_index(DistanceMetric.EUCLIDEAN,
                                        device="cuda")
    store.insert_batch([BatchInsertItem(str(i), Vector(rows[i]))
                        for i in range(n)])
    batch = [(Vector(q), 10) for q in
             rng.standard_normal((nq, d), dtype=np.float32)]
    want = store.search_batch(batch)
    torch.cuda.synchronize()
    torch.cuda._sleep(int(1e9))          # ~0.5-1 s of card time queued
    t0 = time.perf_counter()
    handle = store.search_batch_submit(batch)
    submit_s = time.perf_counter() - t0
    assert not torch.cuda.current_stream().query()   # the sleep still runs
    assert handle.collect() == want
    assert submit_s < 0.2, submit_s


# -- H1: the batched HNSW traversal (csrc/hnsw_search.cu) --------------------

def _hnsw_tables(n, d, metric, seed, dup=False):
    """A seeded host graph's padded tables (one build thread), optionally
    with a duplicate edge in the first live rows' layer-0 lists."""
    from vectordb_tpu_torch.index.hnsw_graph import HnswParams
    from vectordb_tpu_torch.index.hnsw_native import NativeHnswGraph
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((n, d)).astype(np.float32)
    graph = NativeHnswGraph(metric, HnswParams(seed=seed,
                                               ef_construction=64))
    graph.insert_batch([(i, data[i]) for i in range(n)])
    for i in range(0, n, 29):
        graph.remove(i)
    t = graph.export_padded_tables()
    if dup:
        nb = t["neighbors"]
        rows = np.nonzero((nb[:, 0, 0] >= 0) & (nb[:, 0, 1] >= 0))[0][:n // 2]
        nb[rows, 0, 1] = nb[rows, 0, 0]
    queries = rng.standard_normal((37, d)).astype(np.float32)
    return t, queries, rng


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n, d, ef, masked, dup", [
    (1000, 768, 16, False, False),      # ef < 32
    (1000, 768, 64, True, True),        # ef > 32, mask, duplicate edges
    (999, 50, 40, True, False),         # N % 32 != 0, d % 4 != 0
    (2001, 32, 100, False, True)])
def test_h1_matches_plain(dev, mode, n, d, ef, masked, dup):
    from vectordb_tpu_torch.ops import hnsw_device as hd
    metric = {"euclidean": DistanceMetric.EUCLIDEAN,
              "dot": DistanceMetric.DOT_PRODUCT,
              "cosine": DistanceMetric.COSINE}[mode]
    t, queries, rng = _hnsw_tables(n, d, metric, 5, dup)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    args = (put(t["vectors"]), put(t["norms"]),
            put(t["neighbors"].astype(np.int32)), put(t["valid"]),
            put(queries))
    start = min(int(t["max_level"]), t["neighbors"].shape[1] - 1)
    cap = t["vectors"].shape[0]
    mask = put(rng.random(cap) < 0.5) if masked else None
    before = cuda_kernels.launches["hnsw_search"]
    kd, ks = cuda_kernels.hnsw_search(*args, int(t["entry"]), start, mode,
                                      10, ef, mask)
    torch.cuda.synchronize()
    assert cuda_kernels.launches["hnsw_search"] == before + 1
    pd, ps = hd._hnsw_search_plain(*args, int(t["entry"]), start, mode, 10,
                                   ef, mask)
    assert torch.equal(ks.cpu(), ps.cpu())
    found = ps.cpu() >= 0
    assert int(found.sum()) > 0
    torch.testing.assert_close(kd.cpu()[found], pd.cpu()[found], rtol=1e-5,
                               atol=0.0)
    assert bool(torch.isinf(kd.cpu()[~found]).all())
    if masked:
        assert bool(mask.cpu()[ks.cpu()[found].long()].all())


def test_h1_splits_large_batches(dev, monkeypatch):
    """More visited bitmasks than the scratch bound go in several
    launches, with the same answers."""
    t, queries, _ = _hnsw_tables(600, 64, DistanceMetric.EUCLIDEAN, 7)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    args = (put(t["vectors"]), put(t["norms"]),
            put(t["neighbors"].astype(np.int32)), put(t["valid"]),
            put(queries))
    start = min(int(t["max_level"]), t["neighbors"].shape[1] - 1)
    whole = cuda_kernels.hnsw_search(*args, int(t["entry"]), start,
                                     "euclidean", 5, 32)
    words = (t["vectors"].shape[0] + 31) // 32
    monkeypatch.setattr(cuda_kernels, "_HNSW_VISITED_BYTES", words * 4 * 10)
    before = cuda_kernels.launches["hnsw_search"]
    parts = cuda_kernels.hnsw_search(*args, int(t["entry"]), start,
                                     "euclidean", 5, 32)
    assert cuda_kernels.launches["hnsw_search"] == before + 4
    assert torch.equal(whole[1], parts[1])
    assert torch.equal(whole[0], parts[0])


# -- IVF-Flat's probed refine and the HNSW device build on the card ----------

@pytest.mark.parametrize("storage", ["f32", "bf16", "int8"])
def test_ivf_probed_refine_runs_k2_tile_major(dev, storage):
    """A trained IVF store on the card answers as the same layout on the
    CPU, and every K2 launch of its probed searches takes tile_major."""
    from vectordb_tpu_torch import IvfFlatIndex
    rng = np.random.default_rng(4)
    centers = rng.standard_normal((24, 64)).astype(np.float32)
    data = (centers[rng.integers(0, 24, 4000)]
            + 0.3 * rng.standard_normal((4000, 64)).astype(np.float32))
    card = IvfFlatIndex(DistanceMetric.EUCLIDEAN, nlist=32, nprobe=4,
                        storage=storage, seed=1, device="cuda")
    card.add_batch(list(enumerate(data)))
    card.train()
    state = card.export_trained_state()
    rows = {i: card.get_vector(i).as_array() for i in range(4000)}
    host = IvfFlatIndex(DistanceMetric.EUCLIDEAN, nlist=32, nprobe=4,
                        storage=storage, device="cpu")
    host.import_trained_state(state, rows, 64)
    queries = rng.standard_normal((300, 64)).astype(np.float32)
    key = {"f32": "refine_dots", "bf16": "refine_dots_bf16",
           "int8": "refine_dots_int8"}[storage]
    cuda_kernels.reset_launches()
    got = card.search_batch(queries, 10, nprobe=6)
    assert cuda_kernels.launches[key] >= 1
    assert cuda_kernels.routes[key] == {
        "tile_major": cuda_kernels.launches[key], "query_major": 0}
    want = host.search_batch(queries, 10, nprobe=6)
    # the same ids but where two candidates tie within the refine's f32
    # rounding (K2 sums in fmaf order, the plain version elementwise):
    # such a pair may come out in either order, or trade the k-th place
    gd = np.array([[d for _, d in r] for r in got])
    wd = np.array([[d for _, d in r] for r in want])
    np.testing.assert_allclose(gd, wd, rtol=2e-5, atol=2e-5)
    tol = 2e-5 * np.abs(wd) + 2e-5
    for qi, (g, w) in enumerate(zip(got, want)):
        for j, ((gi, _), (wi, _)) in enumerate(zip(g, w)):
            if gi != wi:
                tied = [jj for jj, (ii, _) in enumerate(w) if ii == gi]
                assert (tied and abs(wd[qi, tied[0]] - wd[qi, j])
                        <= tol[qi, j]) or j == len(w) - 1, (qi, j, g, w)


def test_hnsw_device_build_runs_k1_wgmma(dev, monkeypatch):
    """The device build's certified searches take K1 on "wgmma" and K2 on
    "tile_major", and the graph answers as well as the CPU build's."""
    from vectordb_tpu_torch.index.hnsw_build_device import \
        build_device_tables
    from vectordb_tpu_torch.index.hnsw_graph import HnswParams
    from vectordb_tpu_torch.index.hnsw_native import NativeHnswGraph
    from vectordb_tpu_torch.ops import topk
    monkeypatch.setattr(topk, "_EXACT1P_MIN_N", 512)
    rng = np.random.default_rng(6)
    n, d = 3000, 128
    data = rng.standard_normal((n, d)).astype(np.float32)
    params = HnswParams(seed=6)
    cuda_kernels.reset_launches()
    card = build_device_tables(np.arange(n), data,
                               DistanceMetric.EUCLIDEAN, params, block=512,
                               device="cuda")
    k1 = cuda_kernels.launches["coarse_minima_1p_sup"]
    assert k1 >= 1
    assert cuda_kernels.routes["coarse_minima_1p_sup"]["mma_sync"] == 0
    assert cuda_kernels.routes["refine_dots"]["query_major"] == 0
    host = build_device_tables(np.arange(n), data, DistanceMetric.EUCLIDEAN,
                               params, block=512, device="cpu")
    np.testing.assert_array_equal(card["levels"], host["levels"])
    same = float(np.mean(card["neighbors"] == host["neighbors"]))
    assert same >= 0.999, same
    queries = rng.standard_normal((50, d)).astype(np.float32)
    truth = np.argsort(((queries[:, None, :] - data[None]) ** 2).sum(-1),
                       axis=1)[:, :10]
    g = NativeHnswGraph(DistanceMetric.EUCLIDEAN, params)
    g.import_padded_tables(card)
    rec = np.mean([len({i for i, _ in g.search_knn(q, 10, ef=100)}
                       & set(t.tolist())) / 10
                   for q, t in zip(queries, truth)])
    assert rec >= 0.9


@pytest.mark.parametrize("storage, coarse_key, refine_key", [
    ("f32", "coarse_minima_f32_1p_sup", "refine_dots"),
    ("bf16", "coarse_minima_1p_sup", "refine_dots_bf16"),
    ("int8", "coarse_minima_int8_1p_sup", "refine_dots_int8")])
def test_mesh_on_one_card_launches_per_shard(dev, storage, coarse_key,
                                             refine_key):
    """A 4-shard mesh on cuda:0: each batch launches the shard's coarse
    kernel (K4 / K1 / K7, "wgmma") and K2 ("tile_major") once a shard,
    and answers as the unsharded store of the same rows and storage."""
    from vectordb_tpu_torch.parallel import make_mesh
    mesh = make_mesh(4, devices=["cuda:0"] * 4)
    rng = np.random.default_rng(14)
    n, d, k = 16384, 768, 10
    rows = rng.standard_normal((n, d), dtype=np.float32)
    qs = rng.standard_normal((64, d), dtype=np.float32)
    sharded = VectorStore.with_sharded_flat_index(
        DistanceMetric.EUCLIDEAN, mesh, storage=storage)
    single = VectorStore.with_flat_index(DistanceMetric.EUCLIDEAN,
                                         storage=storage, device="cuda")
    for store in (sharded, single):
        store.insert_batch([BatchInsertItem(str(i), Vector(rows[i]))
                            for i in range(n)])
    batch = [(Vector(q), k) for q in qs]
    sharded.search_batch(batch)                 # builds the device state
    cuda_kernels.reset_launches()
    got = sharded.search_batch(batch)
    assert cuda_kernels.launches[coarse_key] == 4
    assert cuda_kernels.launches[refine_key] == 4
    assert cuda_kernels.routes[coarse_key]["wgmma"] == 4
    assert cuda_kernels.routes[refine_key]["tile_major"] == 4
    want = single.search_batch(batch)
    assert [[h.id for h in r] for r in got] == \
        [[h.id for h in r] for r in want]
    np.testing.assert_allclose([h.distance for r in got for h in r],
                               [h.distance for r in want for h in r],
                               rtol=2e-5, atol=2e-5)


def test_device_guard_launches_on_the_tensors_card(dev):
    """A kernel launched on a cuda:1 tensor while cuda:0 is current runs
    on cuda:1 with cuda:1's attributes and stream, and equals its plain
    version; a mesh over both cards answers as one card does."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards (the device guard launches a "
                    "kernel on a card that is not current)")
    from vectordb_tpu_torch.parallel import make_mesh
    dev1 = torch.device("cuda:1")
    with torch.cuda.device(0):
        db, hi, _, queries, terms, bound, bound2 = _operands(
            dev1, 4096, 768, 100, "euclidean")
        qThi, _, _, _, qrow, col, inv = terms
        t_k, s_k = cuda_kernels.coarse_minima_1p_sup(qThi, qrow, hi, col,
                                                     inv, "euclidean")
        assert torch.cuda.current_device() == 0
        assert t_k.device == dev1
        t_p, s_p = ck._minima_1p_sup_plain(qThi, qrow, hi, col, inv,
                                           "euclidean")
        assert _live_err(t_k, t_p) <= bound
        tidx = torch.randint(0, 4096 // 16, (100, 32), device=dev1)
        dots = cuda_kernels.refine_dots(tidx, queries, db, 32)
        plain = ck._refine_dots_plain(tidx, queries, db, 32)
        assert float((dots - plain).abs().max()) <= bound2
    mesh = make_mesh(2, devices=["cuda:0", "cuda:1"])
    rng = np.random.default_rng(15)
    rows = rng.standard_normal((8192, 64), dtype=np.float32)
    qs = rng.standard_normal((16, 64), dtype=np.float32)
    two = VectorStore.with_sharded_flat_index(DistanceMetric.EUCLIDEAN, mesh)
    one = VectorStore.with_sharded_flat_index(
        DistanceMetric.EUCLIDEAN, make_mesh(2, devices=["cuda:0"] * 2))
    for store in (two, one):
        store.insert_batch([BatchInsertItem(str(i), Vector(rows[i]))
                            for i in range(len(rows))])
    batch = [(Vector(q), 5) for q in qs]
    assert [[h.id for h in r] for r in two.search_batch(batch)] == \
        [[h.id for h in r] for r in one.search_batch(batch)]
