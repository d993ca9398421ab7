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
    """K1 (mirrors) and K4 (f32) at one pass with super minima take the
    wgmma body when TMA can take their rows: a 16-byte row pitch for the
    bf16 queries (d a multiple of 8) and 16-byte aligned rows. Everything
    else -- ragged d, unaligned rows, K3, K5, K6, K7 -- stays on mma_sync."""
    is_k1_k4 = src in ("mirrors", "f32") and passes == 1 and emit_super
    tma_ok = d % 8 == 0 and aligned
    want = "wgmma" if is_k1_k4 and tma_ok else "mma_sync"
    assert cuda_kernels._coarse_route(src, passes, emit_super, d,
                                      aligned) == want


@pytest.mark.parametrize("src, dtype", [("mirrors", torch.bfloat16),
                                        ("f32", torch.float32)])
def test_route_reads_alignment_from_the_rows(src, dtype):
    rows = torch.zeros((256 * 768 + 8,), dtype=dtype)
    aligned = rows[:256 * 768].view(256, 768)
    shifted = rows[1:256 * 768 + 1].view(256, 768)    # 2 or 4 bytes off
    assert cuda_kernels.coarse_body(src, aligned, 1, True) == "wgmma"
    assert cuda_kernels.coarse_body(src, shifted, 1, True) == "mma_sync"
    # a CPU tensor is never launched: its body is the plain version
    assert ck._coarse_body(src, aligned, 1, True) == "plain"


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


def _int_rows(rng, n, d, q):
    """Small integers: every bf16 product and every partial f32 sum is
    exact, so any summation order gives the f64 dot."""
    x = torch.from_numpy(rng.integers(-8, 9, (n, d)).astype(np.float32))
    qs = torch.from_numpy(rng.integers(-8, 9, (q, d)).astype(np.float32))
    return x, qs


@pytest.mark.parametrize("src", ["mirrors", "f32"])
@pytest.mark.parametrize("n, d, q", [(256, 768, 7), (512, 40, 100),
                                     (1024, 37, 33)])
def test_probe_reads_each_live_dot_exactly(src, n, d, q):
    """Through ``_probe_inv`` in mode "dot", every tile minimum is exactly
    -dot of its tile's live row, and every super minimum the minimum of its
    16 tile minima."""
    x, qs = _int_rows(np.random.default_rng(n + d), n, d, q)
    arr = x if src == "f32" else x.to(torch.bfloat16)
    qThi = qs.T.contiguous().to(torch.bfloat16)
    inv, live = ck._probe_inv(n, "cpu")
    assert int((inv == 0).sum()) == n // 16
    assert torch.equal(live // 16, torch.arange(n // 16))
    qrow = torch.zeros((1, q))
    col = torch.zeros((1, n))
    tile, sup = ck._minima_1p_sup(qThi, qrow, arr, col, inv, "dot", src)
    want = -(x[live].double() @ qs.T.double())
    assert torch.equal(tile.double(), want)
    assert torch.equal(sup, tile.reshape(-1, 16, q).amin(dim=1))
    assert ck._accum_reading(tile, x, qThi, live) == 0.0


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
