"""K8s, the fused IVF-PQ scan: its route by shape, the query tile it
takes, and a model of its walk. CPU only: the route reads dtypes, widths
and alignment, the tile is arithmetic, and the model walks the kernel's
warp tiles, k-steps and register stages one lane at a time in numpy, with
mma.sync's fragment layout written out, so that its index maps (the
codeword word a lane loads, the shared-memory image of the queries, the
accumulator a score comes from) are held to a dense recomputation and the
model stands in for the launch to run ``_ivfpq_scan_fused`` here."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from vectordb_tpu_torch import DistanceMetric
from vectordb_tpu_torch.ops import cuda_kernels
from vectordb_tpu_torch.ops import pq as pq_ops


def _cu_constants() -> dict:
    src = (Path(cuda_kernels.__file__).resolve().parent.parent / "csrc"
           / "ivfpq_scan.cu").read_text()
    return {k: int(v) for k, v in
            re.findall(r"constexpr int (\w+) = (\w+);", src)
            if v.isdigit()}


_CU = _cu_constants()
_SRC = (Path(cuda_kernels.__file__).resolve().parent.parent / "csrc"
        / "ivfpq_scan.cu").read_text()
WARPS, WROWS, SMEM_LIMIT = _CU["WARPS"], _CU["WROWS"], _CU["SMEM_LIMIT"]
MODES = {"euclidean": 0, "dot": 1, "cosine": 2}


@pytest.fixture(autouse=True)
def _counters_left_at_zero():
    """The model's stand-in launches count as the wrapper does; the
    module-wide counters go back to zero for the tests that follow in the
    same process."""
    yield
    cuda_kernels.reset_launches()


@pytest.mark.parametrize("dtype", [torch.uint8, torch.int16])
@pytest.mark.parametrize("d, dsub", [(768, 8), (768, 16), (768, 4), (48, 8),
                                     (40, 8), (1536, 8), (8192, 8)])
@pytest.mark.parametrize("aligned", [True, False])
def test_scan_route(dtype, d, dsub, aligned):
    """"fused" takes uint8 codes, d % 16 == 0, dsub % 8 == 0, aligned
    codes and codebook, and a shared memory that holds two n-tiles of
    queries beside the warps' codes; every other shape is "chunked"."""
    m = d // dsub
    fits = 4 * 16 * d + WARPS * WROWS * m <= SMEM_LIMIT
    want = ("fused" if dtype == torch.uint8 and d % 16 == 0
            and dsub % 8 == 0 and aligned and fits else "chunked")
    assert cuda_kernels._ivfpq_scan_route(dtype, d, dsub, m, aligned) == want


@pytest.mark.parametrize("q", [1, 8, 9, 16, 17, 33, 64, 65, 200])
@pytest.mark.parametrize("d, m", [(768, 96), (1536, 192), (4096, 512),
                                  (64, 8)])
def test_scan_tile_is_one_of_the_kernels_two_and_fits(q, d, m):
    """8 n-tiles for more than 16 queries where shared memory holds them,
    else 2, else 0 (d = 4096 beside 512 code bytes a row); the benchmark's
    Q = 64 at d = 768 takes 8, d = 1536 takes 2 at any Q."""
    nt = cuda_kernels._scan_tile(q, d, m)
    fits = {t: cuda_kernels._scan_smem(d, m, t) <= SMEM_LIMIT for t in (2, 8)}
    want = 8 if q > 16 and fits[8] else (2 if fits[2] else 0)
    assert nt == want
    if (d, m) == (768, 96):
        assert nt == (8 if q > 16 else 2)
    if (d, m) == (1536, 192):
        assert nt == 2
    assert "case 8:" in _SRC and "case 2:" in _SRC and "case 4:" not in _SRC


def test_scan_smem_is_the_kernels():
    """The host's shared-memory formula is the C entry point's."""
    src = (Path(cuda_kernels.__file__).resolve().parent.parent / "csrc"
           / "ivfpq_scan.cu").read_text()
    body = src[src.index("vdb_ivfpq_scan_smem"):]
    body = body[:body.index("}")]
    assert "4L * nt * 8 * d" in body and "WARPS) * WROWS * m" in body
    assert cuda_kernels._MAX_SMEM == SMEM_LIMIT
    assert (cuda_kernels._SCAN_WARPS, cuda_kernels._SCAN_WARP_ROWS) == (
        WARPS, WROWS)


def test_scan_body_reads_alignment_from_codes_and_codebook():
    n, m, ksub, dsub = 64, 96, 256, 8
    cbuf = torch.zeros(n * m + 16, dtype=torch.uint8)
    codes, codes_off = (cbuf[:n * m].view(n, m),
                        cbuf[1:n * m + 1].view(n, m))
    bbuf = torch.zeros(m * ksub * dsub + 8, dtype=torch.bfloat16)
    cb, cb_off = (bbuf[:m * ksub * dsub].view(m, ksub, dsub),
                  bbuf[1:m * ksub * dsub + 1].view(m, ksub, dsub))
    body = cuda_kernels.ivfpq_scan_body
    assert body(codes, cb) == "fused"
    assert body(codes_off, cb) == "chunked"
    assert body(codes, cb_off) == "chunked"
    assert body(codes[:, :48].contiguous(),
                cb[:48, :, :].contiguous().view(96, ksub, 4)) == "chunked"


def test_scan_routes_are_counted_beside_launches():
    assert set(cuda_kernels.routes["ivfpq_scan"]) == {"fused", "chunked"}
    cuda_kernels.routes["ivfpq_scan"]["fused"] += 2
    cuda_kernels.launches["ivfpq_scan"] += 2
    cuda_kernels.reset_launches()
    assert cuda_kernels.routes["ivfpq_scan"]["fused"] == 0
    assert cuda_kernels.launches["ivfpq_scan"] == 0


# ------------------------------------------------------------------ model


def _bf16(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        torch.bfloat16).float().numpy()


def _mma(acc, a_regs, b_regs, g, t):
    """mma.sync.m16n8k16.row.col: the lanes' A registers (four pairs) and
    B registers (two pairs) placed by the PTX fragment layout, C += A B,
    and C read back into the lanes' four accumulators."""
    a16 = np.zeros((16, 16))
    b16 = np.zeros((16, 8))
    (a0, a1, a2, a3), (b0, b1) = a_regs, b_regs
    for e in range(2):
        a16[g, 2 * t + e] = a0[:, e]
        a16[g + 8, 2 * t + e] = a1[:, e]
        a16[g, 2 * t + 8 + e] = a2[:, e]
        a16[g + 8, 2 * t + 8 + e] = a3[:, e]
        b16[2 * t + e, g] = b0[:, e]
        b16[2 * t + 8 + e, g] = b1[:, e]
    c16 = a16 @ b16
    acc[0] += c16[g, 2 * t]
    acc[1] += c16[g, 2 * t + 1]
    acc[2] += c16[g + 8, 2 * t]
    acc[3] += c16[g + 8, 2 * t + 1]


def _model_scan(codes, cb, q_hi, q_lo, qc, cents, csq, cid_sp, valid,
                span, nlist, mode):
    """ivfpq_scan_kernel's walk in numpy, f64 arithmetic: returns (Q, N)
    scores. Every block's warps, tiles and lanes, as the kernel indexes
    them."""
    codes = codes.numpy()
    cbv = cb.double().numpy()
    qh, ql = q_hi.double().numpy(), q_lo.double().numpy()
    qc, cents = qc.double().numpy(), cents.double().numpy()
    csq, cid_sp, valid = csq.numpy(), cid_sp.numpy(), valid.numpy()
    n, m = codes.shape
    q, d = qh.shape
    ksub, dsub = cbv.shape[1], cbv.shape[2]
    big_m = nlist * span
    nt = cuda_kernels._scan_tile(q, d, m)
    nq_t = nt * 8
    steps, words = d // 16, d // 8
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    lrow = [(i >> 1) * 16 + (i & 1) * 8 + g for i in range(4)]
    out = np.full((q, n), np.nan)
    mode_id = MODES[mode]
    for y in range(-(-q // nq_t)):
        q0 = y * nq_t
        qs = {"hi": np.zeros(nq_t * d), "lo": np.zeros(nq_t * d)}
        for w in range(nq_t * words):          # the fill loop, by element
            nq, k8 = divmod(w, words)
            o = ((k8 >> 1) * nq_t + nq) * 16 + (k8 & 1) * 8
            if q0 + nq < q:
                qs["hi"][o:o + 8] = qh[q0 + nq, 8 * k8:8 * k8 + 8]
                qs["lo"][o:o + 8] = ql[q0 + nq, 8 * k8:8 * k8 + 8]
        for tile in range(-(-n // WROWS)):
            r0 = tile * WROWS
            nrows = min(WROWS, n - r0)
            wcodes = np.zeros(WROWS * m, np.int64)
            wcodes[:nrows * m] = codes[r0:r0 + nrows].reshape(-1)
            cid = []
            for i in range(4):
                row = r0 + lrow[i]
                c = np.zeros(32, np.int64)
                main = row < big_m
                c[main] = row[main] // span
                sp = (row >= big_m) & (row < n)
                c[sp] = np.clip(cid_sp[row[sp] - big_m], 0, nlist - 1)
                cid.append(c)
            acc = np.zeros((2, nt, 4, 32))
            cr, rr = np.zeros((4, 32)), np.zeros((4, 32))
            bufs = {}

            def issue(name, s):
                if s >= steps:
                    return
                pos = 16 * s + 4 * t
                c = pos // dsub
                off = pos - c * dsub
                a, cen = [], []
                for i in range(4):
                    code = wcodes[lrow[i] * m + c]
                    assert (code < ksub).all()
                    a.append(np.stack([cbv[c, code, off + e]
                                       for e in range(4)], 1))
                    cen.append(np.stack([cents[cid[i], pos + e]
                                         for e in range(4)], 1))
                bufs[name] = (s, a, cen)

            def step(name, s):
                if s >= steps:
                    return
                s_issued, a, cen = bufs[name]
                assert s_issued == s               # the stage holds step s
                bfrag = {}
                for j in range(nt):
                    o = (s * nq_t + 8 * j + g) * 16 + 4 * t
                    for p, half in enumerate(("hi", "lo")):
                        bfrag[p, j] = np.stack([qs[half][o + e]
                                                for e in range(4)], 1)
                for p in range(2):
                    for j in range(nt):
                        for mt in range(2):
                            r_0, r_8 = a[2 * mt], a[2 * mt + 1]
                            regs = (r_0[:, 0:2], r_8[:, 0:2], r_0[:, 2:4],
                                    r_8[:, 2:4])
                            b = bfrag[p, j]
                            _mma(acc[mt, j], regs, (b[:, 0:2], b[:, 2:4]),
                                 g, t)
                if mode_id != MODES["dot"]:
                    for i in range(4):
                        cr[i] += (cen[i] * a[i]).sum(1)
                        rr[i] += (a[i] * a[i]).sum(1)

            issue("a0", 0)
            issue("a1", 1)
            issue("a2", 2)
            for s in range(0, steps, 4):
                issue("a3", s + 3)
                step("a0", s)
                issue("a0", s + 4)
                step("a1", s + 1)
                issue("a1", s + 5)
                step("a2", s + 2)
                issue("a2", s + 6)
                step("a3", s + 3)
            quad = lambda v: v.reshape(-1, 8, 4).sum(-1).repeat(4, 1)  # noqa
            cr, rr = quad(cr), quad(rr)
            for i in range(4):
                row = r0 + lrow[i]
                for ln in range(32):
                    if row[ln] >= n:
                        continue
                    xsq = csq[cid[i][ln]] + 2.0 * cr[i, ln] + rr[i, ln]
                    xnorm = np.sqrt(max(xsq, 1e-30))
                    for j in range(nt):
                        for e in range(2):
                            gq = q0 + 8 * j + 2 * t[ln] + e
                            if gq >= q:
                                continue
                            dot = (acc[i >> 1, j, (i & 1) * 2 + e, ln]
                                   + qc[gq, cid[i][ln]])
                            sc = {0: xsq - 2.0 * dot, 1: -dot,
                                  2: -dot / xnorm}[mode_id]
                            out[gq, row[ln]] = (sc if valid[row[ln]]
                                                else np.inf)
    assert not np.isnan(out).any()                 # every score written
    return out


def _dense_scores(codes, cb, q_hi, q_lo, qc, cents, csq, cid_sp, valid,
                  span, nlist, mode):
    """The same scores computed densely in f64 from the plain decode."""
    n, m = codes.shape
    big_m = nlist * span
    r_hat = pq_ops._decode_rows_plain(codes, cb).double()
    rows = torch.arange(n)
    cid = torch.where(rows < big_m, rows // span, torch.clamp(
        cid_sp.long()[torch.clamp(rows - big_m, min=0)], 0, nlist - 1))
    cen = cents.double()[cid]
    dot = ((q_hi.double() + q_lo.double()) @ r_hat.T
           + qc.double()[:, cid])
    xsq = csq.double()[cid] + 2.0 * (cen * r_hat).sum(1) + (
        r_hat * r_hat).sum(1)
    sc = {"euclidean": xsq - 2.0 * dot, "dot": -dot,
          "cosine": -dot / torch.sqrt(torch.clamp(xsq, min=1e-30))}[mode]
    return torch.where(valid[None, :], sc, float("inf")).numpy()


def _geometry(seed, q, m, dsub, ksub=16, nlist=5, span=32, s_rows=40):
    rng = np.random.default_rng(seed)
    d = m * dsub
    n = nlist * span + s_rows
    cb = torch.from_numpy(rng.standard_normal(
        (m, ksub, dsub), dtype=np.float32) * 0.3).to(torch.bfloat16)
    codes = torch.from_numpy(rng.integers(0, ksub, (n, m), dtype=np.uint8))
    valid = torch.from_numpy(rng.random(n) >= 0.1)
    cents = torch.from_numpy(_bf16(rng.standard_normal((nlist, d))))
    csq = (cents * cents).sum(1)
    cid_sp = torch.from_numpy(rng.integers(-1, nlist + 1, s_rows).astype(
        np.int32))                           # clamped, as dead slots are
    qs = torch.from_numpy(rng.standard_normal((q, d), dtype=np.float32))
    cnorm = (cb.float() ** 2).sum(-1)
    return qs, codes, cb, cnorm, valid, cents, csq, cid_sp


@pytest.mark.parametrize("mode", ["euclidean", "dot", "cosine"])
@pytest.mark.parametrize("q, m, dsub", [(5, 6, 8), (20, 2, 24), (13, 3, 16),
                                        (70, 4, 8)])
def test_model_walk_is_the_dense_scan(mode, q, m, dsub):
    """The model's scores (lane loads, fragment placement, the k-step
    ring, the quad sums, the epilogue's accumulator map) equal the dense
    f64 scores: one n-tile and several, query tiles that end short, d of
    one and three k-steps (not a multiple of 32), codewords of one to
    three words, a ragged last warp tile, spill clusters clamped."""
    qs, codes, cb, _, valid, cents, csq, cid_sp = _geometry(1, q, m, dsub)
    q_hi, q_lo = pq_ops._split_query(qs)
    cents_bf = cents.to(torch.bfloat16)
    qc = pq_ops._score_dots(q_hi, q_lo, cents_bf)
    args = (codes, cb, q_hi, q_lo, qc, cents_bf, csq, cid_sp, valid, 32, 5,
            mode)
    got = _model_scan(*args)
    want = _dense_scores(*args)
    fin = np.isfinite(want)
    assert np.array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-9, atol=1e-9)


def _fake_launch(calls):
    """cuda_kernels.ivfpq_scan's checks and counts around the model."""
    def launch(codes, cb, q_hi, q_lo, qc, cents, csq, cid_sp, valid, span,
               nlist, mode):
        calls.append(q_hi.shape[0])
        n = codes.shape[0]
        assert qc.shape == (q_hi.shape[0], nlist)
        assert cid_sp.dtype == torch.int32 and cents.dtype == torch.bfloat16
        assert cid_sp.shape == (n - nlist * span,)
        cuda_kernels.launches["ivfpq_scan"] += 1
        cuda_kernels.routes["ivfpq_scan"]["fused"] += 1
        return torch.from_numpy(_model_scan(
            codes, cb, q_hi, q_lo, qc, cents, csq, cid_sp, valid, span,
            nlist, mode).astype(np.float32))
    return launch


@pytest.mark.parametrize("metric", list(DistanceMetric))
@pytest.mark.parametrize("budget_q, blocks", [(None, 1), (7, 3)])
def test_fused_route_on_the_model_matches_the_chunk_loop(
        metric, budget_q, blocks, monkeypatch):
    """``_ivfpq_scan_fused`` with the model in place of the launch: one
    launch a query block (the score budget forced small splits 20 queries
    into 7 + 7 + 6), and the same top r as the chunk loop (scores within
    2e-6 of the largest, the same slots but for ties within that)."""
    qs, codes, cb, cnorm, valid, cents, csq, cid_sp = _geometry(
        2, 20, 4, 8)
    n = codes.shape[0]
    calls = []
    monkeypatch.setattr(cuda_kernels, "ivfpq_scan", _fake_launch(calls))
    if budget_q is not None:
        monkeypatch.setattr(pq_ops, "_SCAN_SCORE_BYTES", 4 * n * budget_q)
    cuda_kernels.reset_launches()
    args = (qs, codes, cb, valid, cents, csq, cid_sp, metric, 24, 32, 5)
    sv, sl = pq_ops._ivfpq_scan_fused(*args)
    assert len(calls) == blocks and sum(calls) == 20
    assert cuda_kernels.routes["ivfpq_scan"] == {"fused": blocks,
                                                 "chunked": 0}
    want_v, want_s = pq_ops._ivfpq_scan_chunked(
        qs, codes, cb, cnorm, valid, cents, csq, cid_sp, metric, r=24,
        cpc=2, span=32, nlist=5)
    assert sv.shape == want_v.shape == (20, 24) and sl.dtype == torch.int64
    tol = 2e-6 * float(want_v[torch.isfinite(want_v)].abs().max())
    torch.testing.assert_close(sv, want_v, rtol=0, atol=tol)
    for (sv_f, sl_f), (sv_c, sl_c) in zip(zip(sv, sl), zip(want_v, want_s)):
        fused_of = dict(zip(sl_f.tolist(), sv_f.tolist()))
        chunk_of = dict(zip(sl_c.tolist(), sv_c.tolist()))
        for slot in fused_of.keys() & chunk_of.keys():
            assert abs(fused_of[slot] - chunk_of[slot]) <= 2 * tol
        for slot in fused_of.keys() ^ chunk_of.keys():
            # a slot only one route kept ties the last kept score
            score = fused_of.get(slot, chunk_of.get(slot))
            assert abs(score - float(sv_c[-1])) <= 2 * tol


@pytest.mark.parametrize("n", [1, 10, 1056, 1 << 20, 1657664, 1 << 27])
def test_scan_query_block_fits_its_budget_and_the_selection(n):
    """A query block's scores stay within the budget (one query at
    least), its rows within the selection's grid, in whole 64-query
    tiles once it holds one: 64 at the benchmark's 1.66M slots."""
    qblk = pq_ops._scan_query_block(n)
    assert 1 <= qblk <= cuda_kernels._SELECT_MAX_ROWS
    assert qblk == 1 or 4 * n * qblk <= pq_ops._SCAN_SCORE_BYTES
    assert qblk < 64 or qblk % 64 == 0
    if n == 1657664:
        assert qblk == 64
    src = (Path(cuda_kernels.__file__).resolve().parent.parent / "csrc"
           / "ivfpq_scan.cu").read_text()
    assert f"rows > {cuda_kernels._SELECT_MAX_ROWS}" in src


def test_cpu_tensors_take_the_chunk_loop_uncounted(monkeypatch):
    """A CPU scan is the plain version: no launch, no route counted, and
    the fused path is never asked."""
    qs, codes, cb, cnorm, valid, cents, csq, cid_sp = _geometry(3, 4, 4, 8)
    monkeypatch.setattr(pq_ops, "_ivfpq_scan_fused", None)
    cuda_kernels.reset_launches()
    sv, sl = pq_ops.ivfpq_scan_topr(qs, codes, cb, cnorm, valid, cents, csq,
                                    cid_sp, DistanceMetric.EUCLIDEAN, r=16,
                                    cpc=2, span=32, nlist=5)
    assert sv.shape == (4, 16)
    assert cuda_kernels.launches["ivfpq_scan"] == 0
    assert cuda_kernels.routes["ivfpq_scan"] == {"fused": 0, "chunked": 0}


def test_scan_wrapper_refuses_cpu_tensors():
    qs, codes, cb, _, valid, cents, csq, cid_sp = _geometry(4, 4, 4, 8)
    q_hi, q_lo = pq_ops._split_query(qs)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_kernels.ivfpq_scan(codes, cb, q_hi, q_lo, torch.zeros(4, 5),
                                cents.to(torch.bfloat16), csq, cid_sp,
                                valid, 32, 5, "euclidean")


# -------------------------------------------------------------- selection


def _order_key(x: np.ndarray) -> np.ndarray:
    """select_kernel's order_key: f32 -> uint32 in the same order."""
    u = x.astype(np.float32).view(np.uint32)
    return np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)


def _key_float(k: np.ndarray) -> np.ndarray:
    u = np.where(k & 0x80000000, k & 0x7fffffff, ~k).astype(np.uint32)
    return u.view(np.float32)


def _model_select(keys, k, seg, payload=None, paths=None):
    """select_kernel in numpy, one block a (row, segment), as the kernel
    branches: at most k finite keys kept with +inf ones after them; else a
    threshold from the sorted 256-key sample (the kernel's j and its
    tries) and the keys below it; else the four 8-bit radix passes with
    the kernel's prefix, mask and kk. Then the pads and the sort. Keys
    equal to the k-th are taken in reverse order (the kernel's are in any
    order). ``paths`` collects the branch of each block."""
    keys = keys.numpy()
    rows, n = keys.shape
    segs = -(-n // seg)
    cap, tries, inf_key = _CU["SEL_CAP"], _CU["SEL_TRIES"], 0xff800000
    out_v = np.zeros((rows, segs, k), np.float32)
    out_i = np.zeros((rows, segs, k), np.int64)
    for row in range(rows):
        for s in range(segs):
            s0 = s * seg
            skey = _order_key(keys[row, s0:s0 + seg]).astype(np.int64)
            nn = skey.size
            nf = int((skey < inf_key).sum())
            if nf <= k:
                path, t, n_less, need = "finite", inf_key, nf, k - nf
            else:
                sample = np.sort(skey[np.arange(256) * nn // 256])
                j = 2 * k * 256 // nn + 1
                found = False
                for _ in range(tries):
                    j = min(j, 255)
                    t = int(sample[j])
                    c = int((skey < t).sum())
                    if c < k:
                        if j == 255:
                            break
                        j = 2 * j + 1
                    elif c > cap:
                        if j == 0:
                            break
                        j //= 2
                    else:
                        found = True
                        break
                if found:
                    path, n_less, need = "threshold", c, 0
                else:
                    path = "radix"
                    prefix, mask, kk = 0, 0, k
                    for shift in (24, 16, 8, 0):
                        act = (skey & mask) == prefix
                        hist = np.bincount((skey[act] >> shift) & 255,
                                           minlength=256)
                        incl = np.cumsum(hist)
                        d = int(np.nonzero((incl - hist < kk)
                                           & (kk <= incl))[0].item())
                        kk -= int(incl[d] - hist[d])
                        prefix |= d << shift
                        mask |= 255 << shift
                    t, n_less, need = prefix, k - kk, kk
            if paths is not None:
                paths.add(path)
            less = np.nonzero(skey < t)[0]
            eq = np.nonzero(skey == t)[0][::-1][:need]
            assert less.size == n_less and less.size <= cap
            opos = np.concatenate([less, eq])
            okey = skey[opos]
            width = max(opos.size, k)
            okey = np.concatenate([okey, np.full(width - opos.size,
                                                 0xffffffff)])
            opos = np.concatenate([opos, np.full(width - opos.size, -1)])
            order = np.argsort(okey, kind="stable")[:k]
            okey, opos = okey[order].astype(np.uint32), opos[order]
            out_v[row, s] = _key_float(okey)
            col = np.where(opos < 0, -1, s0 + opos)
            if payload is not None:
                col = np.where(col < 0, -1, payload.numpy()[row,
                                                           np.maximum(col, 0)])
            out_i[row, s] = col
    return (torch.from_numpy(out_v.reshape(rows, -1)),
            torch.from_numpy(out_i.reshape(rows, -1)))


def _select_keys(seed, rows, n, dead=0.1, distinct=None):
    """Scores with the scan's features: clustered values (few top
    digits), exact ties, +inf dead slots (share ``dead``), -0 and +0; with
    ``distinct``, only that many values (ties in bulk)."""
    rng = np.random.default_rng(seed)
    x = (50.0 + rng.standard_normal((rows, n))).astype(np.float32)
    if distinct is not None:
        x = x[:, :distinct][:, rng.integers(0, distinct, n)]
    x[:, ::7] = x[:, 3:4]                         # ties
    x[rng.random((rows, n)) < dead] = np.inf
    x[:, 1] = -0.0
    x[:, 2] = 0.0
    x[0, :5] = -3.0                               # a negative run
    return torch.from_numpy(np.ascontiguousarray(x))


def _same_selection(got, want, k):
    """Equal values; within each k-long segment of a row, the same
    (value, slot) pairs but where a value ties the segment's last."""
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0,
                               equal_nan=True)
    for gv, gi, wv, wi in zip(got[0].tolist(), got[1].tolist(),
                              want[0].tolist(), want[1].tolist()):
        for a in range(0, len(wv), k):
            seg_w = list(zip(wv[a:a + k], wi[a:a + k]))
            seg_g = list(zip(gv[a:a + k], gi[a:a + k]))
            last = seg_w[-1][0]
            for v in {x for x, _ in seg_w}:
                g = {i for x, i in seg_g if x == v or (x != x and v != v)}
                w = {i for x, i in seg_w if x == v or (x != x and v != v)}
                assert len(g) == len(w)
                if v == last or v != v:
                    continue                      # the boundary may tie
                assert g == w


def test_select_constants_are_the_kernels():
    """The host's segment and k limit are the kernel's; a bin a thread;
    a threshold's candidates fit twice the widest k."""
    src = (Path(cuda_kernels.__file__).resolve().parent.parent / "csrc"
           / "ivfpq_scan.cu").read_text()
    assert cuda_kernels._SELECT_SEG == _CU["SEL_SEG"] == 16384
    assert _CU["SEL_THREADS"] == 256
    assert "k > 1024" in src and cuda_kernels._SELECT_MAX_K == 1024
    assert _CU["SEL_CAP"] >= 2 * cuda_kernels._SELECT_MAX_K


@pytest.mark.parametrize("rows, n, k, seg, dead, distinct, path", [
    (3, 3000, 8, 1024, 0.1, None, "threshold"),
    (2, 16384, 128, 16384, 0.1, None, "threshold"),
    (1, 5000, 1000, 4096, 0.1, None, "threshold"),
    (2, 2000, 1, 512, 0.1, None, "threshold"),
    (2, 64, 16, 64, 0.1, None, "threshold"),
    (2, 70, 16, 64, 0.1, None, "finite"),          # a 6-key tail segment
    (2, 10, 16, 64, 0.1, None, "finite"),
    (2, 3000, 64, 1024, 0.97, None, "finite"),     # mostly dead slots
    (2, 3000, 64, 1024, 0.0, 1, "radix"),          # ties in bulk
    (1, 4096, 700, 4096, 0.0, 1, "radix")])
def test_model_select_is_the_plain_selection(rows, n, k, seg, dead, distinct,
                                             path, monkeypatch):
    """The kernel's selection, modelled, against ``_select_plain`` on each
    of its three branches: segments longer and shorter than k, k of 1
    and 1000, mostly dead segments, scores tied in bulk."""
    monkeypatch.setattr(cuda_kernels, "_SELECT_SEG", seg)
    keys = _select_keys(rows + n, rows, n, dead, distinct)
    paths = set()
    _same_selection(_model_select(keys, k, seg, paths=paths),
                    pq_ops._select_plain(keys, k), k)
    assert path in paths
    pay = torch.from_numpy(np.random.default_rng(1).permutation(
        rows * n).reshape(rows, n).astype(np.int64))
    _same_selection(_model_select(keys, k, seg, pay),
                    pq_ops._select_plain(keys, k, pay), k)


@pytest.mark.parametrize("n, r, seg", [(5000, 24, 64), (700, 128, 256),
                                       (130, 128, 256), (128, 128, 256),
                                       (100000, 3, 1024)])
def test_select_topr_is_topk(n, r, seg, monkeypatch):
    """``_select_topr`` over one, two and three rounds of segments gives
    torch.topk's values and, but for ties, its columns; pads never reach
    the answer (r <= N)."""
    monkeypatch.setattr(cuda_kernels, "_SELECT_SEG", seg)
    keys = _select_keys(n, 3, n)
    v, i = pq_ops._select_topr(keys, r)
    want = torch.topk(keys, r, dim=1, largest=False)
    assert v.shape == i.shape == (3, r) and (i >= 0).all()
    _same_selection((v, i), (want.values, want.indices), r)
    assert torch.equal(torch.gather(keys, 1, i), v)
