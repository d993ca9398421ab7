"""The coarse kernels' route by shape, the certificate's accumulation
coefficient keyed by that route, and the dead-row probe that reads raw
dots through a coarse kernel (chip_smoke.py phase 2 reads the card's
accumulation error with it). CPU only: the probe runs through the plain
versions, as the launchers take them for CPU tensors."""

import itertools

import numpy as np
import pytest
import torch

from vectordb_tpu_torch.distance import DistanceMetric
from vectordb_tpu_torch.ops import coarse_kernel as ck
from vectordb_tpu_torch.ops import cuda_kernels

ROUTE_CASES = list(itertools.product(
    ("mirrors", "f32", "int8"), (1, 3), (True, False), (768, 200, 40, 37, 4),
    (True, False)))


@pytest.mark.parametrize("src, passes, emit_super, d, aligned", ROUTE_CASES)
def test_route(src, passes, emit_super, d, aligned):
    """K1 and K6 (mirrors: one pass, with and without super minima), K3
    (mirrors: three passes or one, tile minima only), K4 and K5 (the same
    over f32 rows) and K7 (int8: one pass, super minima) take the wgmma
    body when TMA can take their rows: 16-byte aligned rows, and a row
    pitch that is a multiple of 16 bytes for the bf16 queries and the rows
    (d a multiple of 8; of 16 for int8 codes, one byte each). Everything
    else -- ragged d, unaligned rows, three passes with super minima --
    stays on mma_sync."""
    routed = {"mirrors": passes == 1 or not emit_super,
              "f32": passes == 1 or not emit_super,
              "int8": passes == 1 and emit_super}[src]
    pitch = 16 if src == "int8" else 8
    want = "wgmma" if routed and aligned and d % pitch == 0 else "mma_sync"
    assert cuda_kernels._coarse_route(src, passes, emit_super, d,
                                      aligned) == want


@pytest.mark.parametrize("d", [200, 40])
def test_int8_codes_need_a_16_byte_pitch(d):
    """At d = 8 (mod 16) the f32 rows' pitch (4d bytes) and the queries'
    (2d) are multiples of 16 bytes, the codes' (d) is not: K4 and K5 move
    to wgmma, K7 stays on mma_sync, and moves at d + 8."""
    route = cuda_kernels._coarse_route
    assert route("int8", 1, True, d, True) == "mma_sync"
    assert route("f32", 1, True, d, True) == "wgmma"
    assert route("f32", 3, False, d, True) == "wgmma"
    assert route("f32", 1, False, d, True) == "wgmma"
    assert route("int8", 1, True, d + 8, True) == "wgmma"


def test_int8_k_order_matches_the_fragment_reads():
    """K7's query copy puts query dimension _INT8_K_ORDER[p] of each
    16-block at fragment column p: a thread's four codes k = 4t..4t+3 then
    meet the queries of fragment columns 2t, 2t+1, 2t+8, 2t+9, and every
    dot is unchanged (integers: exact)."""
    order = cuda_kernels._INT8_K_ORDER
    assert sorted(order) == list(range(16))
    idx = cuda_kernels._int8_k_index(48, "cpu")
    assert torch.equal(idx.reshape(3, 16) % 16,
                       torch.tensor(order).expand(3, 16))
    assert torch.equal(idx // 16, torch.arange(48) // 16)
    rng = np.random.default_rng(3)
    codes = rng.integers(-128, 128, (5, 48))
    q = rng.integers(-9, 10, 48)
    qk = q[idx.numpy()]                          # the permuted query copy
    got = np.zeros(5, np.int64)
    for blk in range(3):
        c, b = codes[:, 16 * blk:16 * blk + 16], qk[16 * blk:16 * blk + 16]
        for t in range(4):
            got += (c[:, 4 * t] * b[2 * t] + c[:, 4 * t + 1] * b[2 * t + 1]
                    + c[:, 4 * t + 2] * b[2 * t + 8]
                    + c[:, 4 * t + 3] * b[2 * t + 9])
    assert np.array_equal(got, codes @ q)


@pytest.mark.parametrize("src, dtype", [("mirrors", torch.bfloat16),
                                        ("f32", torch.float32),
                                        ("int8", torch.int8)])
def test_route_reads_alignment_from_the_rows(src, dtype):
    rows = torch.zeros((256 * 768 + 16,), dtype=dtype)
    aligned = rows[:256 * 768].view(256, 768)
    shifted = rows[1:256 * 768 + 1].view(256, 768)    # 1, 2 or 4 bytes off
    assert cuda_kernels.coarse_body(src, aligned, 1, True) == "wgmma"
    assert cuda_kernels.coarse_body(src, shifted, 1, True) == "mma_sync"
    # a CPU tensor is never launched: its body is the plain version
    assert ck._coarse_body(src, aligned, 1, True) == "plain"


@pytest.mark.parametrize("shift", ["none", "lo", "hi", "both"])
@pytest.mark.parametrize("d", [768, 40])
def test_k3_route_reads_both_mirrors(shift, d):
    """K3 at three passes reads the hi and the lo mirror through TMA: it
    takes wgmma only when both are 16-byte aligned. A bf16 view offset by
    one element (2 bytes) sends it to mma_sync, whichever mirror it is."""
    def mirror(shifted):
        buf = torch.zeros((256 * d + 8,), dtype=torch.bfloat16)
        return buf[int(shifted):int(shifted) + 256 * d].view(256, d)

    hi = mirror(shift in ("hi", "both"))
    lo = mirror(shift in ("lo", "both"))
    want = "wgmma" if shift == "none" else "mma_sync"
    assert cuda_kernels.coarse_body("mirrors", hi, 3, False, lo) == want
    # one pass (K6, and K3's control) reads no lo mirror: its route
    # follows the hi mirror's alignment alone
    want1 = "wgmma" if shift in ("none", "lo") else "mma_sync"
    assert cuda_kernels.coarse_body("mirrors", hi, 1, False) == want1


@pytest.mark.parametrize("shift", ["none", "lo"])
def test_tier2_certificate_asks_the_body_of_its_launch(shift, monkeypatch):
    """``coarse_search(exact=True)`` over the mirrors asks ``_coarse_body``
    with the very arrays K3 was launched over, the lo mirror included, so
    the coefficient and the launch cannot disagree: an unaligned lo mirror
    routes K3 to mma_sync, and the certificate's question gets the same
    answer from the route."""
    rng = np.random.default_rng(5)
    db = torch.from_numpy(rng.standard_normal((1024, 40), dtype=np.float32))
    q = torch.from_numpy(rng.standard_normal((8, 40), dtype=np.float32))
    sq = (db * db).sum(1)
    hi, lo = ck.split_hi_lo(db)
    if shift == "lo":
        buf = torch.zeros((lo.numel() + 8,), dtype=torch.bfloat16)
        lo = buf[1:1 + lo.numel()].view_as(lo).copy_(lo)
    launched, asked = [], []
    real_minima = ck._coarse_minima

    def spy_minima(*a):
        launched.append(a)
        return real_minima(*a)

    def spy_body(*a):
        asked.append(a)
        return "plain"

    monkeypatch.setattr(ck, "_coarse_minima", spy_minima)
    monkeypatch.setattr(ck, "_coarse_body", spy_body)
    ck.coarse_search(q, db, sq, torch.sqrt(sq), torch.ones(1024, dtype=bool),
                     hi, lo, DistanceMetric.EUCLIDEAN, 5)
    (src, arr, passes, sup, arr_lo), = asked
    (_, _, _, l_hi, l_lo, *_), = launched
    assert (src, passes, sup) == ("mirrors", 3, False)
    assert arr is l_hi and arr_lo is l_lo
    want = "wgmma" if shift == "none" else "mma_sync"
    assert cuda_kernels.coarse_body(src, arr, passes, sup, arr_lo) == want


@pytest.mark.parametrize("body, coeff", [("plain", 1.0), ("mma_sync", 2.0),
                                         ("wgmma", 2.0)])
def test_accum_coeff_by_route(body, coeff):
    assert ck._accum_coeff(body) == coeff


@pytest.mark.parametrize("body", ["mma_sync", "wgmma"])
def test_certificate_takes_the_coefficient_of_its_route(body, monkeypatch):
    """The 1-pass certificate reads the coefficient of the body that ran
    the coarse pass: inflating one body's coefficient certifies nothing
    when that body ran, and leaves the other body's results as they were."""
    rng = np.random.default_rng(0)
    db = torch.from_numpy(rng.standard_normal((1024, 32), dtype=np.float32))
    q = torch.from_numpy(rng.standard_normal((16, 32), dtype=np.float32))
    sq = (db * db).sum(1)
    valid = torch.ones(1024, dtype=torch.bool)
    hi, _ = ck.split_hi_lo(db)
    elo = ck.residual_max_norm(db, hi)

    def certified():
        return ck.coarse_search_1p(q, db, sq, torch.sqrt(sq), valid, hi, elo,
                                   DistanceMetric.EUCLIDEAN, 5)[2]

    base = certified()                    # the plain body, coefficient 1
    assert base.any()
    other = "wgmma" if body == "mma_sync" else "mma_sync"
    monkeypatch.setattr(ck, "_coarse_body", lambda *a: body)
    monkeypatch.setitem(ck._ACCUM_COEFF, body, 1.0)
    monkeypatch.setitem(ck._ACCUM_COEFF, other, 1e6)
    assert torch.equal(certified(), base)
    monkeypatch.setitem(ck._ACCUM_COEFF, body, 1e6)
    assert not certified().any()


@pytest.mark.parametrize("body", ["mma_sync", "wgmma"])
def test_tier2_certificate_takes_the_coefficient_of_its_route(body,
                                                             monkeypatch):
    """The bf16x3 certificate of ``coarse_search(exact=True)`` over the
    mirrors (tier 2, K3) reads the coefficient of the body that ran K3, as
    the 1-pass one does: inflating that body's coefficient certifies
    nothing, inflating the other body's leaves the flags as they were."""
    rng = np.random.default_rng(1)
    db = torch.from_numpy(rng.standard_normal((1024, 32), dtype=np.float32))
    q = torch.from_numpy(rng.standard_normal((16, 32), dtype=np.float32))
    sq = (db * db).sum(1)
    valid = torch.ones(1024, dtype=torch.bool)
    hi, lo = ck.split_hi_lo(db)

    def certified():
        return ck.coarse_search(q, db, sq, torch.sqrt(sq), valid, hi, lo,
                                DistanceMetric.EUCLIDEAN, 5)[2]

    base = certified()                    # the plain body, coefficient 1
    assert base.any()
    other = "wgmma" if body == "mma_sync" else "mma_sync"
    monkeypatch.setattr(ck, "_coarse_body", lambda *a: body)
    monkeypatch.setitem(ck._ACCUM_COEFF, body, 1.0)
    monkeypatch.setitem(ck._ACCUM_COEFF, other, 1e6)
    assert torch.equal(certified(), base)
    monkeypatch.setitem(ck._ACCUM_COEFF, body, 1e6)
    assert not certified().any()


def _int_rows(rng, n, d, q):
    """Small integers: every bf16 product and every partial f32 sum is
    exact, so any summation order gives the f64 dot."""
    x = torch.from_numpy(rng.integers(-8, 9, (n, d)).astype(np.float32))
    qs = torch.from_numpy(rng.integers(-8, 9, (q, d)).astype(np.float32))
    return x, qs


@pytest.mark.parametrize("src", ["mirrors", "f32", "int8"])
@pytest.mark.parametrize("n, d, q", [(256, 768, 7), (512, 40, 100),
                                     (1024, 37, 33)])
def test_probe_reads_each_live_dot_exactly(src, n, d, q):
    """Through ``_probe_inv`` in mode "dot", every tile minimum is exactly
    -dot of its tile's live row, and every super minimum the minimum of its
    16 tile minima. int8 codes: the dot times the row's pow2 scale, 2^0
    and 2^-3 (exact), held against the stored values code x scale."""
    x, qs = _int_rows(np.random.default_rng(n + d), n, d, q)
    qThi = qs.T.contiguous().to(torch.bfloat16)
    inv, live = ck._probe_inv(n, "cpu")
    assert int((inv == 0).sum()) == n // 16
    assert torch.equal(live // 16, torch.arange(n // 16))
    qrow = torch.zeros((1, q))
    col = torch.zeros((1, n))
    for scale in ((1.0, 0.125) if src == "int8" else (None,)):
        arr = {"f32": x, "mirrors": x.to(torch.bfloat16),
               "int8": x.to(torch.int8)}[src]
        sc = None if scale is None else torch.full((1, n), scale)
        stored = x if scale is None else x * scale
        tile, sup = ck._minima_1p_sup(qThi, qrow, arr, col, inv, "dot", src,
                                      sc)
        want = -(stored[live].double() @ qs.T.double())
        assert torch.equal(tile.double(), want)
        assert torch.equal(sup, tile.reshape(-1, 16, q).amin(dim=1))
        assert ck._accum_reading(tile, stored, qThi, live) == 0.0


@pytest.mark.parametrize("n, d, q, wide", [(256, 768, 7, "rows"),
                                           (512, 40, 100, "both"),
                                           (1024, 37, 33, "both")])
def test_probe_reads_each_3pass_dot_exactly(n, d, q, wide):
    """K5 at 3 passes through ``_probe_inv``: integers of 257..511 (signs
    at random) have a nonzero bf16 lo part (bf16 keeps 8 significant
    bits). With small integer queries, or with both sides wide at d <= 64,
    every product and partial sum is exact, so each tile minimum is
    exactly -(hi.qhi + lo.qhi + hi.qlo) in f64, the 1-pass minima are not,
    and the accumulation reading over the three products is 0."""
    rng = np.random.default_rng(n + d)

    def wide_ints(shape):
        return rng.integers(257, 512, shape) * rng.choice([-1, 1], shape)

    x = torch.from_numpy(wide_ints((n, d)).astype(np.float32))
    qs = torch.from_numpy((wide_ints((q, d)) if wide == "both" else
                           rng.integers(-8, 9, (q, d))).astype(np.float32))
    hi, lo = ck.split_hi_lo(x)
    qT = qs.T.contiguous()
    qThi = qT.to(torch.bfloat16)
    qTlo = (qT - qThi.float()).to(torch.bfloat16)
    assert bool((lo != 0).any())
    assert bool((qTlo != 0).any()) == (wide == "both")
    inv, live = ck._probe_inv(n, "cpu")
    qrow = torch.zeros((1, q))
    col = torch.zeros((1, n))
    h, l_ = hi[live].double(), lo[live].double()
    want = -(h @ qThi.double() + l_ @ qThi.double() + h @ qTlo.double())
    tile = ck._coarse_minima_f32(qThi, qTlo, qrow, x, col, inv, 3, "dot").T
    assert torch.equal(tile.double(), want)
    one = ck._coarse_minima_f32(qThi, qTlo, qrow, x, col, inv, 1, "dot").T
    assert not torch.equal(one.double(), want)
    assert ck._accum_reading(tile, hi.float(), qThi, live, lo.float(),
                             qTlo) == 0.0


@pytest.mark.parametrize("n, d, q, wide", [(256, 768, 7, "rows"),
                                           (512, 40, 100, "both"),
                                           (1024, 37, 33, "both")])
def test_probe_reads_each_3pass_mirror_dot_exactly(n, d, q, wide):
    """K3 at 3 passes over the hi and lo mirrors through ``_probe_inv``, on
    the integer data of the K5 case above: each tile minimum is exactly
    -(hi.qhi + lo.qhi + hi.qlo) in f64, the same as K5 over the f32 rows
    the mirrors split, the 1-pass minima are not, and the accumulation
    reading over the three products is 0."""
    rng = np.random.default_rng(n + d)

    def wide_ints(shape):
        return rng.integers(257, 512, shape) * rng.choice([-1, 1], shape)

    x = torch.from_numpy(wide_ints((n, d)).astype(np.float32))
    qs = torch.from_numpy((wide_ints((q, d)) if wide == "both" else
                           rng.integers(-8, 9, (q, d))).astype(np.float32))
    hi, lo = ck.split_hi_lo(x)
    qT = qs.T.contiguous()
    qThi = qT.to(torch.bfloat16)
    qTlo = (qT - qThi.float()).to(torch.bfloat16)
    assert bool((lo != 0).any())
    inv, live = ck._probe_inv(n, "cpu")
    qrow = torch.zeros((1, q))
    col = torch.zeros((1, n))
    h, l_ = hi[live].double(), lo[live].double()
    want = -(h @ qThi.double() + l_ @ qThi.double() + h @ qTlo.double())
    tile = ck._coarse_minima(qThi, qTlo, qrow, hi, lo, col, inv, 3, "dot").T
    assert torch.equal(tile.double(), want)
    assert torch.equal(tile, ck._coarse_minima_f32(qThi, qTlo, qrow, x, col,
                                                   inv, 3, "dot").T)
    one = ck._coarse_minima(qThi, qTlo, qrow, hi, lo, col, inv, 1, "dot").T
    assert not torch.equal(one.double(), want)
    assert ck._accum_reading(tile, hi.float(), qThi, live, lo.float(),
                             qTlo) == 0.0


@pytest.mark.parametrize("data", ["normal", "uniform12"])
def test_plain_reading_is_within_its_coefficient(data):
    """The reading chip_smoke.py takes on the card, taken on the plain
    version (IEEE f32, round to nearest): at most its coefficient, 1. The
    "uniform12" set (rows and queries from U(1, 2), every product positive)
    is the one on which a truncating accumulator drifts one way."""
    rng = np.random.default_rng(7)
    n, d, q = 1024, 768, 16
    if data == "normal":
        x = rng.standard_normal((n, d), dtype=np.float32)
        qs = rng.standard_normal((q, d), dtype=np.float32)
    else:
        x = rng.uniform(1.0, 2.0, (n, d)).astype(np.float32)
        qs = rng.uniform(1.0, 2.0, (q, d)).astype(np.float32)
    hi = torch.from_numpy(x).to(torch.bfloat16)
    qThi = torch.from_numpy(qs).T.contiguous().to(torch.bfloat16)
    inv, live = ck._probe_inv(n, "cpu")
    tile, _ = ck._minima_1p_sup(qThi, torch.zeros((1, q)), hi,
                                torch.zeros((1, n)), inv, "dot")
    reading = ck._accum_reading(tile, hi.float(), qThi, live)
    assert 0.0 <= reading <= ck._accum_coeff("plain")
