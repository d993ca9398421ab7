#!/usr/bin/env python3
"""Drive the PyTorch port's flat-search paths once on one CUDA card.

    python3 chip_smoke.py [--rows N] [--queries Q] [--seed S]

Phases (each prints one line or a few; any failure exits non-zero,
nothing is caught and passed over):
  1. card (nvidia-smi name and power limit), versions, kernel build time;
  2. each hand-written kernel (K1-K7, K2 over f32, bf16 and int8 rows)
     against its plain PyTorch version on the same CUDA tensors (d=768,
     N=2^16, Q=256, all three metrics, 10% dead rows), max error beside
     its limit (see ``limits``), and a control per kernel that must break
     the limit; then the accumulation reading of both coarse bodies: raw
     dots read through K1, K7 (integer codes, unit scales), K5 at 3
     passes and K3 at 3 passes (the "wgmma" body) and K6 ("mma_sync")
     with 15 of every 16 rows dead (``ck._probe_inv``), against f64 dots
     of the same bf16 operands (for K5 and K3 the sum of their three
     products), max |err| / (d 2^-24 sum|x_i q_i|) on N(0,1) data and on
     U(1, 2) data (every product positive), each held to the
     certificates' coefficient for its body;
  3. the f32 slice at full size through the public entry points:
     VectorStore.with_flat_index(EUCLIDEAN, device="cuda"), 2^20 x 768
     seeded rows through insert_batch, a Q=4096, k=10 search_batch exact
     and fast, checked against an on-card f32 chunked-matmul oracle;
  4. a 20k-row store (tier 2, kernel K3) and a forced fallback (inflated
     elo_max: tier 1 certifies nothing), both exact against the oracle;
  5. the port's HTTP server on 127.0.0.1:0: batch insert, search, batch
     search, health, metrics;
  6. K1, K2, K3 against their plain versions at the main path's shapes
     (agreement within the same limits, time by CUDA events beside the
     plain version's, a bf16 torch.matmul of the same GEMM shape and the
     bound): K3 at 3 passes over the 2^20-row store's mirrors at Q=65 and
     Q=256 (its tier 2 and its forced fallback) and over the 20k-row
     store's at Q=1024;
  7. the storage modes at full size: one seeded 2^20 x 768 row set into
     VectorStore.with_flat_index(EUCLIDEAN, storage=...) for "bf16" (K1 +
     K2 over bf16 rows), "int8" (K7 + K2 over int8 codes) and "f32" past
     a lowered mirror gate (K4 + K2, fast mode K4 without the
     certificate), 1024 rows deleted, Q=4096, k=10 exact and fast, each
     held against an on-card f32 oracle over the STORED values; a forced
     fallback per store (K5 at 3 passes, flat_search_bf16,
     flat_search_int8), the legacy fast path on 256-row states (K6, K5 at
     1 pass), and each new kernel against its plain version at its
     path's shapes, timed as in phase 6 (K5 at 3 passes at Q=256 and at
     Q=65, the tier-2 re-run's sizes);
  8. PQ-Flat at full width: the intrinsic-dim-32 row set of
     benchmarks/pq_bench.py (2^20 x 768, 1024 rows deleted, Q=4096, k=10)
     into VectorStore.with_index(PqFlatIndex(EUCLIDEAN, device="cuda"))
     (m=96, ksub=256, OPQ), trained, searched at refine 64 and 32 and over
     HTTP; every returned distance equal to the on-card f32 distance of
     its id, recall@10 >= 0.95 against an on-card f32 oracle at refine 64,
     the scan's pool with K8 identical to the pool with the plain decode,
     the pool's scores within PQ_SCORE_LIMIT of their f64 recomputation
     (controls: a bf16-output score GEMM, a dropped q_lo term), the
     "mirror" and "host" re-rank venues in agreement; K8 timed at the
     scan chunk beside its plain version, F.embedding and its bound;
  9. the two-phase exact scan (ops.flat_kernel.two_phase_search, K9) at
     2^20 x 768 f32, Q=1024, k=10, all three metrics, 10% dead rows,
     exact against an on-card f32 oracle; K9 against its plain version
     (control: bf16 operands), timed beside an f32 torch.matmul.
Launch counters are zeroed just before each path's run and read right
after it: the store searches of phases 3 and 4 (K1, K2, K3); each
storage store's searches (K4/K7 and K2 by source); each forced fallback
(K5); the legacy fast runs (K6, K5); the PQ store's searches (K8); the
two-phase searches (K9). Every kernel of a path must have launched in its
window; the direct comparison calls are outside them. Every K1, K4 and K7
launch in the windows of phase 3 and of phase 7's bf16, int8 and f32
stores, every K3 launch of phases 3-4 (the 2^20-row store's tier 2, the
20k-row store, the forced fallback), and every K5 launch in the f32
store's window (tier 2 of the queries tier 1 leaves uncertified), its
forced fallback (3 passes) and the legacy fast f32 run (1 pass) must
have taken the "wgmma" body (``cuda_kernels.routes``). Phase 7 prints each store's tier-1
certification rate (and, for the f32 fallback, tier 2's) beside the
coefficient its certificate used and the phase-2 readings of that body.
The line before the last is the card, the one before it the JSON kernel
table; the last line is the JSON contract line {"ok": true, ...}.
It exits non-zero without a card, and when the package is not beside it.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time
import urllib.request

ROOT = os.path.dirname(os.path.abspath(__file__))
D = 768
K = 10
PQ_REFINES = (64, 32)      # PqFlatIndex's default refine, and half of it
K9_QUERIES = 1024
OUT_DIR = os.path.join(ROOT, "chiprun_out")
# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): bf16 tensor cores,
# f32 outside the tensor cores (K2's IEEE fmaf), HBM bandwidth
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
HBM = 3.35e12
SRC = "vectordb_tpu/ops/coarse_kernel.py"
CSRC = "vectordb_tpu_torch/csrc/"
# K9's limit on |kernel - plain| per tile minimum, times S (S as in
# ``limits``; 1 for cosine). Readings on an H100 (phases 2 and 9): sound
# 0 (cuBLAS's f32 GEMM in the plain version sums in the kernel's order at
# those shapes), the control on bf16 operands >= 3.6e-4 S; the limit
# leaves room for other summation orders, a few f32 ulps of S
K9_LIMIT = 2.0 ** -18
# The PQ scan's score |x_hat|^2 - 2 q.x_hat against its f64 value, per
# (query, candidate), times S = |x_hat|^2 + 2 |q| |x_hat|: the bf16 GEMMs
# sum in f32 and q_hi + q_lo holds q to ~2^-17, so a sound scan sits far
# below; a bf16 output (8 mantissa bits) or a dropped q_lo (2^-9 of q)
# lands far above (phase 8 prints all three)
PQ_SCORE_LIMIT = 2.0 ** -16


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def make_rows(rng, n, d, np):
    out = np.empty((n, d), np.float32)
    step = 1 << 16
    for r0 in range(0, n, step):
        out[r0:r0 + step] = rng.standard_normal((min(step, n - r0), d),
                                                dtype=np.float32)
    return out


def oracle_sq(queries, db, sq, valid, k, torch):
    """On-card f32 oracle, independent of the code under test: squared
    euclidean distances by chunked torch.matmul at "highest" precision,
    dead rows masked, exact top-(k+1). Returns (d2 (Q, k+1), ids)."""
    outs_d, outs_i = [], []
    for q0 in range(0, queries.shape[0], 256):
        q = queries[q0:q0 + 256]
        d2 = (q * q).sum(1, keepdim=True) + sq[None, :] - 2.0 * (q @ db.T)
        d2 = torch.where(valid[None, :], d2, float("inf"))
        v, i = torch.topk(d2, k + 1, dim=1, largest=False)
        outs_d.append(v)
        outs_i.append(i)
    return torch.cat(outs_d).cpu().numpy(), torch.cat(outs_i).cpu().numpy()


def check_exact(name, got_ids, got_d, ora_d2, ora_ids, k, np):
    """Ids must equal the oracle's, except where the oracle's k-th and
    (k+1)-th distances tie within the tolerance (or two returned
    distances tie and swap); distances at rtol 2e-5 / atol 2e-5."""
    return check_exact_d(name, got_ids, got_d, np.sqrt(np.maximum(ora_d2,
                                                                  0.0)),
                         ora_ids, k, np)


def check_exact_d(name, got_ids, got_d, ora_d, ora_ids, k, np):
    """check_exact over oracle distances ``ora_d`` of any metric."""
    tol = 2e-5 * np.abs(ora_d) + 2e-5
    ties = 0
    for qi in range(got_ids.shape[0]):
        if np.array_equal(got_ids[qi], ora_ids[qi, :k]):
            continue
        boundary_tie = ora_d[qi, k] - ora_d[qi, k - 1] <= tol[qi, k]
        inside = set(got_ids[qi]) <= set(ora_ids[qi, :k + 1])
        swap = set(got_ids[qi]) == set(ora_ids[qi, :k])
        if not ((boundary_tie and inside) or swap):
            fail(f"{name}: query {qi} ids {got_ids[qi].tolist()} != oracle "
                 f"{ora_ids[qi, :k].tolist()}")
        ties += 1
    err = np.abs(got_d - ora_d[:, :k])
    if not np.all(err <= tol[:, :k]):
        fail(f"{name}: distances off the oracle by up to {err.max():.3e}")
    return ties, float(err.max())


def store_ids(results, np):
    return (np.array([[int(r.id) for r in row] for row in results]),
            np.array([[r.distance for r in row] for row in results],
                     np.float32))


def limits(mode, xmax, qmax):
    """(coarse limit, refine limit) on max |kernel - plain| per entry.

    Set from readings, not from the worst-case summation bound (which at
    d=768 is ~0.35 and would pass a kernel that lost a bf16x3 pass). With
    S = |x|max |q|max (~900 at d=768 for N(0,1) rows): sound kernels read
    at most ~1.1e-6 S (K1, K3: a few f32 ulps of the score) and ~5e-8 S
    (K2); the controls, which break the arithmetic the certificates
    assume, read ~3e-4 S or more (K3 run at 1 pass instead of 3; K1 with
    its dots rounded to bf16) and ~5e-5 S (K2 on TF32 operands). Each
    limit sits an order of magnitude from both. Cosine scores are
    normalised (S = 1 for them); refine dots are raw (always S)."""
    s = xmax * qmax
    return 2.0 ** -16 * (1.0 if mode == "cosine" else s), 2.0 ** -20 * s


def rounded_control(h, qThi, qrow, col, inv_col, mode, ck, torch,
                    scales=None):
    """Plain 1-pass tile minima over f32 rows ``h`` (exact bf16 values)
    with every dot rounded to bf16: what a coarse kernel whose accumulator
    or output passed through bf16 would return."""
    dots = (h @ qThi.float()).to(torch.bfloat16).float()
    if scales is not None:
        dots = dots * scales.reshape(-1, 1)
    score = ck._score_plain(dots, qrow, col, inv_col, mode)
    return score.reshape(-1, ck.SUB, qThi.shape[1]).amin(dim=1)


def to_tf32(x, torch):
    """Round f32 to TF32's 10 mantissa bits (nearest, ties away)."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def live_err(got, want):
    """Max |got - want| over entries with a live row (a fully dead tile
    holds ~PENALTY = 1e30 in both, where rounding differs by ~1e23)."""
    live = want < 1e29
    return float((got - want).abs()[live].max())


def cuda_time(fn, torch, iters=3):
    """(mean ms per call by CUDA events after one warm-up call, the
    warm-up call's result)."""
    out = fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, out


def bound(flops, nbytes, peak):
    """(least ms the card could take, what bounds it): operations over the
    peak rate of their type, bytes (each input read once, each output
    written once) over the HBM rate, whichever is larger."""
    t_op, t_b = flops / peak * 1e3, nbytes / HBM * 1e3
    return (t_op, "operations") if t_op >= t_b else (t_b, "bytes")


def coarse_bound(n, d, q, passes, src_bytes, sup, scales=False):
    """Bound of a coarse kernel: 2 n q d flops per pass; the source rows
    (``src_bytes``), the bf16 query operands, the per-row and per-query
    terms, the tile (and super) minima written."""
    nbytes = (src_bytes + d * q * 2 * (2 if passes == 3 else 1) + q * 4
              + n * 4 * (3 if scales else 2) + (n // 16) * q * 4
              + ((n // 256) * q * 4 if sup else 0))
    return bound(2.0 * n * q * d * passes, nbytes, PEAK_BF16)


def refine_bound(tidx, d, itemsize, torch, scales=False):
    """Bound of K2 on this run's tile ids: the distinct candidate rows it
    needs (read once), the queries and tile ids, the dots written."""
    q, m = tidx.shape
    rows = int(torch.unique(tidx).numel()) * 16
    nbytes = (rows * d * itemsize + (rows * 4 if scales else 0) + q * d * 4
              + q * m * 8 + q * m * 16 * 4)
    return bound(2.0 * q * m * 16 * d, nbytes, PEAK_F32)


def library_ms(a, b, torch):
    """One bf16 torch.matmul of the coarse kernel's GEMM shape (dots only;
    timed as a yardstick, the port never calls it)."""
    ms, out = cuda_time(lambda: torch.matmul(a, b), torch)
    del out
    return ms


def kernel_row(name, source, replaces, launches, err, ms, plain_ms, bnd,
               lib_ms, src=SRC, body=None, **extra):
    row = {"name": name, "route": "cuda", "source": CSRC + source,
           "replaces": f"{src}:{replaces}", "launches": launches,
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": lib_ms}
    if body is not None:
        row["body"] = body
    row.update(extra)
    return row


def k3_at(st, queries, nq, mode, torch, ck, cuda_kernels):
    """K3 at 3 passes over the mirrors of device state ``st`` for the first
    ``nq`` queries, against its plain version, timed beside a bf16
    torch.matmul of (N, 3d) x (3d, Q): a dict of the shape, the body, the
    times, the bound, the max error, its limit and the control's error (K3
    at one pass held to the 3-pass plain version)."""
    qThi, qlo, _, qn, qrow, col, inv = ck._query_terms(
        queries[:nq], st["sq_norms"], st["norms"], st["valid"], mode)
    qTlo = qlo.to(torch.bfloat16)
    hi, lo = st["hi"], st["lo"]
    n = hi.shape[0]
    lim, _ = limits(mode, float(torch.sqrt(st["sq_norms"].max())),
                    float(qn.max()))
    # 10 launches a reading: at N=32768 a launch is ~0.3 ms, and 3 of them
    # read up to 10% apart between runs
    ms, got = cuda_time(lambda: cuda_kernels.coarse_minima(
        qThi, qTlo, qrow, hi, lo, col, inv, 3, mode), torch, iters=10)
    ms_p, want = cuda_time(lambda: ck._coarse_minima_plain(
        qThi, qTlo, qrow, hi, lo, col, inv, 3, mode), torch, iters=10)
    err = live_err(got.T, want)
    control = live_err(cuda_kernels.coarse_minima(
        qThi, qTlo, qrow, hi, lo, col, inv, 1, mode).T, want)
    del got, want
    lib = library_ms(torch.cat([hi, lo, hi], dim=1),
                     torch.cat([qThi, qThi, qTlo], dim=0), torch)
    return {"n": n, "q": nq,
            "body": cuda_kernels.coarse_body("mirrors", hi, 3, False, lo),
            "ms": ms, "plain_ms": ms_p, "library_ms": lib,
            "bound": coarse_bound(n, D, nq, 3, 2 * n * D * 2, False),
            "err": err, "limit": lim, "control": control}


def check_wgmma(window, key, cuda_kernels):
    """Every launch of coarse kernel ``key`` in the window just read took
    the "wgmma" body; returns its route counts."""
    got = dict(cuda_kernels.routes[key])
    if got["mma_sync"] or got["wgmma"] != cuda_kernels.launches[key]:
        fail(f"{window}: {key} launches {cuda_kernels.launches[key]}, by "
             f"body {got}: every one must take the wgmma body")
    return got


def free(torch):
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def load_store(store, rows, dead, BatchInsertItem, Vector):
    step = 1 << 16
    for r0 in range(0, rows.shape[0], step):
        store.insert_batch([BatchInsertItem(str(i), Vector(rows[i]))
                            for i in range(r0, min(r0 + step,
                                                   rows.shape[0]))])
    for i in dead:
        store.delete(str(int(i)))


def phase2(rng, mode_of, card, np, torch, ck, cuda_kernels, flat, worst):
    """Each kernel against its plain version, with a control per kernel
    that must break the limit."""
    from vectordb_tpu_torch.ops import flat_kernel as fk
    from vectordb_tpu_torch.ops import pq as pq_ops
    dev = torch.device("cuda")
    n2, q2, m2 = 1 << 16, 256, 32
    for metric, mode in mode_of.items():
        db_np = make_rows(rng, n2, D, np)
        valid_np = rng.random(n2) >= 0.1
        q_np = rng.standard_normal((q2, D), dtype=np.float32)
        db = torch.from_numpy(db_np).to(dev)
        sq = (db * db).sum(1)
        valid = torch.from_numpy(valid_np).to(dev)
        queries = torch.from_numpy(q_np).to(dev)
        hi, lo = ck.split_hi_lo(db)
        codes_np, scales_np = flat._int8_codes_scales(
            flat._quantize_int8(db_np))
        codes = torch.from_numpy(codes_np).to(dev)
        scales = torch.from_numpy(scales_np).to(dev)
        qThi, qlo, qsq, qn, qrow, col, inv_col = ck._query_terms(
            queries, sq, torch.sqrt(sq), valid, mode)
        qTlo = qlo.to(torch.bfloat16)
        lim, lim2 = limits(mode, float(torch.sqrt(sq.max())),
                           float(qn.max()))
        e, c = {}, {}

        def sup_pair(got, want):
            return max(live_err(got[0], want[0]), live_err(got[1], want[1]))

        # K1, K4, K7: one pass with super minima; control: bf16 dots
        for key, src, arr, sc, h in (
                ("coarse_minima_1p_sup", "mirrors", hi, None, hi.float()),
                ("coarse_minima_f32_1p_sup", "f32", db, None,
                 db.to(torch.bfloat16).float()),
                ("coarse_minima_int8_1p_sup", "int8", codes,
                 scales.reshape(1, -1), codes.float())):
            plain = ck._minima_1p_sup_plain(qThi, qrow, arr, col, inv_col,
                                            mode, src, sc)
            got = ck._minima_1p_sup(qThi, qrow, arr, col, inv_col, mode,
                                    src, sc)
            e[key] = sup_pair(got, plain)
            c[key] = live_err(rounded_control(h, qThi, qrow, col, inv_col,
                                              mode, ck, torch, sc), plain[0])
        # K3, K5 at 3 and 1 passes; control: the 1-pass kernel against
        # the 3-pass plain version
        for key, launch, plain_fn, args in (
                ("coarse_minima", cuda_kernels.coarse_minima,
                 ck._coarse_minima_plain, (hi, lo)),
                ("coarse_minima_f32", cuda_kernels.coarse_minima_f32,
                 ck._coarse_minima_f32_plain, (db,))):
            out, plain = {}, {}
            for passes in (3, 1):
                out[passes] = launch(qThi, qTlo, qrow, *args, col, inv_col,
                                     passes, mode).T
                plain[passes] = plain_fn(qThi, qTlo, qrow, *args, col,
                                         inv_col, passes, mode)
            e[key] = max(live_err(out[p], plain[p]) for p in (3, 1))
            c[key] = live_err(out[1], plain[3])
            if key == "coarse_minima":
                k3_plain3 = plain[3]
        # K6; control: K6 held to the K3 3-pass plain version
        k6 = cuda_kernels.coarse_minima_1p(qThi, qrow, hi, col, inv_col,
                                           mode).T
        e["coarse_minima_1p"] = live_err(k6, ck._coarse_minima_1p_plain(
            qThi, qrow, hi, col, inv_col, mode))
        c["coarse_minima_1p"] = live_err(k6, k3_plain3)
        # K2 over f32, bf16 and int8 rows; control: TF32 operands
        tidx = torch.from_numpy(rng.integers(0, n2 // 16, (q2, m2))).to(dev)
        for key, rows, sc in (("refine_dots", db, None),
                              ("refine_dots_bf16", hi, None),
                              ("refine_dots_int8", codes, scales)):
            plain = ck._refine_dots_plain(tidx, queries, rows, m2, sc)
            got = cuda_kernels.refine_dots(tidx, queries, rows, m2, sc)
            e[key] = float((got - plain).abs().max())
            t_rows = to_tf32(rows, torch) if key == "refine_dots" else rows
            c[key] = float((ck._refine_dots_plain(
                tidx, to_tf32(queries, torch), t_rows, m2, sc)
                - plain).abs().max())
        # K9: tile minima of IEEE-f32 scores; control: bf16 operands
        qa, ra = {"euclidean": (qsq, sq), "dot": (qsq * 0.0, sq * 0.0),
                  "cosine": (qn, torch.sqrt(sq))}[mode]
        inv = inv_col.reshape(-1).contiguous()
        k9p = fk._tile_minima_plain(queries, qa, db, ra, inv, mode, 512)
        e["scan_min"] = live_err(cuda_kernels.scan_min(
            queries, qa, db, ra, inv, mode, 512), k9p)
        c["scan_min"] = live_err(fk._tile_minima_plain(
            queries.bfloat16().float(), qa, db.bfloat16().float(), ra, inv,
            mode, 512), k9p)
        # K8: bit for bit (limit 0); control: every code off by one
        cb8 = torch.from_numpy(rng.standard_normal(
            (96, 256, 8), dtype=np.float32)).to(dev).to(torch.bfloat16)
        codes8 = torch.from_numpy(rng.integers(0, 256, (4096, 96),
                                               dtype=np.uint8)).to(dev)
        k8p = pq_ops._decode_rows_plain(codes8, cb8).float()
        e["pq_decode"] = float((cuda_kernels.pq_decode(codes8, cb8).float()
                                - k8p).abs().max())
        c["pq_decode"] = float((pq_ops._decode_rows_plain(
            codes8 ^ 1, cb8).float() - k8p).abs().max())
        torch.cuda.synchronize()
        s9 = 1.0 if mode == "cosine" else float(
            torch.sqrt(sq.max()) * qn.max())
        limit = {k: (lim2 if k.startswith("refine") else lim) for k in e}
        limit["scan_min"] = K9_LIMIT * s9
        limit["pq_decode"] = 0.0
        say(f"phase 2 {metric.value}: " + "; ".join(
            f"{k} {e[k]:.3e} (control {c[k]:.3e}, limit {limit[k]:.3e})"
            for k in e) + f"  [{card}]")
        bad = [k for k in e if not e[k] <= limit[k]]
        if bad:
            fail(f"kernel disagrees with its plain version ({metric.value}):"
                 f" {bad}")
        bad = [k for k in c if not c[k] > limit[k]]
        if bad:
            fail(f"a control passed its limit ({metric.value}): {bad}: the "
                 f"limits cannot tell a sound kernel from a broken one")
        for k in e:
            worst[k] = max(worst.get(k, 0.0), e[k])
        del db, hi, lo, codes, got, plain, out, k6, k3_plain3, k9p, k8p


def accum_phase(rng, code_rng, card, np, torch, ck, cuda_kernels):
    """Phase 2's accumulation reading (module docstring): {(kernel, body,
    data): reading}. K7's codes come from ``code_rng``, so the rows and
    queries drawn from ``rng`` stay those of earlier runs. Fails if a
    reading passes its body's coefficient."""
    dev = torch.device("cuda")
    n, q = 1 << 16, 256
    inv, live = ck._probe_inv(n, dev)
    qrow = torch.zeros((1, q), dtype=torch.float32, device=dev)
    col = torch.zeros((1, n), dtype=torch.float32, device=dev)
    ones = torch.ones((1, n), dtype=torch.float32, device=dev)
    read = {}
    for data in ("N(0,1)", "U(1,2)"):
        if data == "N(0,1)":
            x = make_rows(rng, n, D, np)
            qs = rng.standard_normal((q, D), dtype=np.float32)
        else:
            x = rng.uniform(1.0, 2.0, (n, D)).astype(np.float32)
            qs = rng.uniform(1.0, 2.0, (q, D)).astype(np.float32)
        xt = torch.from_numpy(x).to(dev)
        hi, lo = ck.split_hi_lo(xt)
        qT = torch.from_numpy(qs).to(dev).T.contiguous()
        qThi = qT.to(torch.bfloat16)
        qTlo = (qT - qThi.float()).to(torch.bfloat16)
        # K7's codes: uniform in [-127, 127] against the N(0,1) queries;
        # all positive, in [64, 127], against the U(1, 2) ones
        low = -127 if data == "N(0,1)" else 64
        codes = torch.from_numpy(code_rng.integers(low, 128, (n, D)).astype(
            np.int8)).to(dev)
        for name, src, arr, passes, sup, arr_lo in (
                ("K1", "mirrors", hi, 1, True, None),
                ("K7", "int8", codes, 1, True, None),
                ("K5 3-pass", "f32", xt, 3, False, None),
                ("K3 3-pass", "mirrors", hi, 3, False, lo)):
            if cuda_kernels.coarse_body(src, arr, passes, sup,
                                        arr_lo) != "wgmma":
                fail(f"the accumulation probe's {name} shape does not route "
                     f"to wgmma")
        t1, _ = cuda_kernels.coarse_minima_1p_sup(qThi, qrow, hi, col, inv,
                                                  "dot")
        t7, _ = cuda_kernels.coarse_minima_int8_1p_sup(qThi, qrow, codes,
                                                       ones, col, inv, "dot")
        t5 = cuda_kernels.coarse_minima_f32(qThi, qTlo, qrow, xt, col, inv,
                                            3, "dot")
        t3 = cuda_kernels.coarse_minima(qThi, qTlo, qrow, hi, lo, col, inv,
                                        3, "dot")
        t6 = cuda_kernels.coarse_minima_1p(qThi, qrow, hi, col, inv, "dot")
        torch.cuda.synchronize()
        read[("K1", "wgmma", data)] = ck._accum_reading(t1, hi.float(), qThi,
                                                        live)
        read[("K7", "wgmma", data)] = ck._accum_reading(t7, codes.float(),
                                                        qThi, live)
        read[("K5 3-pass", "wgmma", data)] = ck._accum_reading(
            t5, hi.float(), qThi, live, lo.float(), qTlo)
        read[("K3 3-pass", "wgmma", data)] = ck._accum_reading(
            t3, hi.float(), qThi, live, lo.float(), qTlo)
        read[("K6", "mma_sync", data)] = ck._accum_reading(t6, hi.float(),
                                                           qThi, live)
        del xt, hi, lo, qThi, qTlo, codes, t1, t7, t5, t3, t6
    say(f"phase 2 accumulation reading, max |dot - f64 dot| / (d 2^-24 "
        f"sum|x_i q_i|), N={n} d={D} Q={q}: " + "; ".join(
            f"{name} ({body}) on {data} {v:.6f} (coefficient "
            f"{ck._accum_coeff(body)})"
            for (name, body, data), v in read.items()) + f"  [{card}]")
    bad = [k for k, v in read.items() if not v <= ck._accum_coeff(k[1])]
    if bad:
        fail(f"an accumulation reading passes its body's coefficient: {bad}")
    return read


def storage_phase(kind, rows, dead, qs, queries, card, mods, worst):
    """One storage mode at full size through the store (see the module
    docstring, phase 7). Returns the kernel table's rows it measured."""
    np, torch, ck, cuda_kernels, topk, flat = (
        mods["np"], mods["torch"], mods["ck"], mods["cuda_kernels"],
        mods["topk"], mods["flat"])
    VectorStore, DistanceMetric = mods["VectorStore"], mods["DistanceMetric"]
    Vector = mods["Vector"]
    E = DistanceMetric.EUCLIDEAN
    n, nq = rows.shape[0], qs.shape[0]
    store = VectorStore.with_flat_index(E, storage=kind, device="cuda")
    t0 = time.perf_counter()
    load_store(store, rows, dead, mods["BatchInsertItem"], Vector)
    load_s = time.perf_counter() - t0
    batch = [(Vector(q), K) for q in qs]
    index = store.index
    gate = flat._MIRROR_MEM_LIMIT
    if kind == "f32":
        # past the mirror gate without a 2^24-row store: the f32 rows
        # alone, as a store past 64 GB of rows + mirrors would hold them
        flat._MIRROR_MEM_LIMIT = 0
    # the path's run: only this store's searches between reset and read
    cuda_kernels.reset_launches()
    t0 = time.perf_counter()
    res = store.search_batch(batch)       # first search builds the state
    first_s = time.perf_counter() - t0
    flat._MIRROR_MEM_LIMIT = gate
    exact_s = []
    for _ in range(2):
        t0 = time.perf_counter()
        res = store.search_batch(batch)
        exact_s.append(time.perf_counter() - t0)
    index.search_mode = "fast"
    fast_s = []
    for _ in range(2):
        t0 = time.perf_counter()
        res_fast = store.search_batch(batch)
        fast_s.append(time.perf_counter() - t0)
    index.search_mode = "exact"
    counts = dict(cuda_kernels.launches)
    coarse_key, refine_key = {
        "bf16": ("coarse_minima_1p_sup", "refine_dots_bf16"),
        "int8": ("coarse_minima_int8_1p_sup", "refine_dots_int8"),
        "f32": ("coarse_minima_f32_1p_sup", "refine_dots")}[kind]
    if counts[coarse_key] < 1 or counts[refine_key] < 1:
        fail(f"the {kind} store's searches did not launch {coarse_key} and "
             f"{refine_key}: {counts}")
    bodies = {coarse_key: check_wgmma(f"phase 7 {kind}", coarse_key,
                                      cuda_kernels)}
    if kind == "f32":          # tier 2 of the uncertified queries: K5
        bodies["coarse_minima_f32"] = check_wgmma(
            "phase 7 f32", "coarse_minima_f32", cuda_kernels)
    say(f"phase 7 {kind} launch counts (this store's searches): "
        f"{ {k: v for k, v in counts.items() if v} }; by body {bodies}")

    with index._lock:
        state = dict(index._sync_device())
    flag = {"bf16": "bf16_storage", "int8": "int8_storage",
            "f32": "coarse_f32"}[kind]
    if not state.get(flag) or (kind == "f32" and "hi" in state):
        fail(f"the {kind} store's device state lacks {flag}: "
             f"{sorted(state)}")
    scales = state.get("scales")
    db = state["db"]
    # the stored values, widened exactly: the oracle's rows
    stored = (db.float() * scales[:, None] if kind == "int8"
              else db.float())
    ora_d2, ora_i = oracle_sq(queries, stored, state["sq_norms"],
                              state["valid"], K, torch)
    del stored
    ids, dists = store_ids(res, np)
    ties, derr = check_exact(f"{kind} exact", ids, dists, ora_d2, ora_i, K,
                             np)
    fids, fdists = store_ids(res_fast, np)
    if kind == "f32":          # K4 without the certificate: approximate ids
        fast_note = "top-%d agreement %.4f" % (K, float(np.mean(
            [len(set(a) & set(b)) / K for a, b in zip(fids, ora_i[:, :K])])))
    else:                      # bf16 and int8 serve fast as exact
        fties, _ = check_exact(f"{kind} fast", fids, fdists, ora_d2, ora_i,
                               K, np)
        fast_note = f"served as exact ({fties} boundary ties)"
    hi = state.get("hi")
    _, _, cert = ck.coarse_search_1p(queries, db, state["sq_norms"],
                                     state["norms"], state["valid"], hi,
                                     state["elo_max"], E, K, scales=scales)
    rate = float(cert.float().mean())
    # the tier-1 certificate's coefficient, beside the phase-2 readings of
    # the products its body sums (K4 rounds the f32 rows to K1's bf16)
    body1 = ck._coarse_body(*ck._dispatch_src(db, hi, scales), 1, True)
    probe = "K7" if kind == "int8" else "K1"
    coeff_note = (f"coefficient {ck._accum_coeff(body1)} of the {body1} body"
                  f" (phase-2 {probe} readings " + ", ".join(
                      f"{v:.6f}" for (name, _, _), v in mods["accum"].items()
                      if name == probe) + ")")
    say(f"phase 7 {kind} store N={n} ({len(dead)} deleted) Q={nq} k={K}: "
        f"load "
        f"{load_s:.3f} s (host); first batch (incl. device build) "
        f"{first_s * 1e3:.3f} ms; exact per batch "
        f"{[round(s * 1e3, 3) for s in exact_s]} ms, ids match the oracle "
        f"over the stored values ({ties} boundary ties, max dist err "
        f"{derr:.3e}); fast per batch {[round(s * 1e3, 3) for s in fast_s]}"
        f" ms, {fast_note}; tier-1 certification rate {rate:.6f} "
        f"({int(cert.sum())}/{nq}) with the {coeff_note}; elo_max "
        f"{float(state['elo_max']):.6e}"
        f"  [{card}]")

    # forced fallback: tier 1 certifies nothing; the next tier serves
    forced = dict(state)
    forced["elo_max"] = torch.tensor(1e9, device=db.device)
    reached = []
    spied = {"bf16": "flat_search_bf16", "int8": "flat_search_int8"}.get(kind)
    if spied:
        real = getattr(topk, spied)
        setattr(topk, spied,
                lambda *a, **kw: reached.append(1) or real(*a, **kw))
    cuda_kernels.reset_launches()
    fd, fi = topk.flat_search_batched(qs[:256], forced, E, K)
    fb_counts = dict(cuda_kernels.launches)
    if spied:
        setattr(topk, spied, real)
        if not reached:
            fail(f"the {kind} forced fallback did not reach {spied}")
        via = spied
    else:
        if fb_counts["coarse_minima_f32"] < 1:
            fail(f"the f32 forced fallback launched no K5: {fb_counts}")
        fb_bodies = check_wgmma("phase 7 f32 forced fallback",
                                "coarse_minima_f32", cuda_kernels)
        # the bf16x3 certificate of tier 2 on these queries (outside the
        # window), beside the phase-2 readings of K5 at 3 passes
        cert2 = ck.coarse_search(queries[:256], db, state["sq_norms"],
                                 state["norms"], state["valid"], None, None,
                                 E, K)[2]
        body2 = ck._coarse_body("f32", db, 3, False)
        via = (f"K5 at 3 passes ({fb_counts['coarse_minima_f32']} "
               f"launches, by body {fb_bodies}); tier-2 certification rate "
               f"{float(cert2.float().mean()):.6f} ({int(cert2.sum())}/256) "
               f"with the coefficient {ck._accum_coeff(body2)} of the "
               f"{body2} body (phase-2 K5 3-pass readings " + ", ".join(
                   f"{v:.6f}" for (name, _, _), v in mods["accum"].items()
                   if name == "K5 3-pass") + ")")
    fties, _ = check_exact(f"{kind} forced fallback", fi[:, :K], fd[:, :K],
                           ora_d2[:256], ora_i[:256], K, np)
    say(f"phase 7 {kind} forced fallback Q=256: exact via {via} ({fties} "
        f"ties)  [{card}]")

    # kernels at the path's shapes (not counted), timed; worst errors
    out = {"fb_counts": fb_counts, "counts": counts}
    mode = "euclidean"
    qThi, qlo, qsq, qn, qrow, col, inv_col = ck._query_terms(
        queries, state["sq_norms"], state["norms"], state["valid"], mode)
    xmax = float(torch.sqrt(state["sq_norms"].max()))
    lim, lim2 = limits(mode, xmax, float(qn.max()))
    src, arr = ck._dispatch_src(db, hi, scales)
    sc2 = None if scales is None else scales.reshape(1, -1)
    itemsize = db.element_size()
    launch = {"mirrors": cuda_kernels.coarse_minima_1p_sup,
              "f32": cuda_kernels.coarse_minima_f32_1p_sup}.get(src)
    if src == "int8":
        def launch(a, b, c_, d_, e_, f_):
            return cuda_kernels.coarse_minima_int8_1p_sup(a, b, c_, sc2, d_,
                                                          e_, f_)
    out["body"] = cuda_kernels.coarse_body(src, arr, 1, True)
    ms_c, (tile_tq, sup_tq) = cuda_time(
        lambda: launch(qThi, qrow, arr, col, inv_col, mode), torch)
    ms_cp, (tile_p, sup_p) = cuda_time(lambda: ck._minima_1p_sup_plain(
        qThi, qrow, arr, col, inv_col, mode, src, sc2), torch)
    e_c = max(live_err(tile_tq, tile_p), live_err(sup_tq, sup_p))
    del tile_p, sup_p
    a16 = arr if arr.dtype == torch.bfloat16 else arr.to(torch.bfloat16)
    lib_c = library_ms(a16, qThi, torch)
    del a16
    mp2, mp = ck._exact1p_pool(K, n // 16)
    tidx, _ = ck._select_tiles_1p(tile_tq, sup_tq, nq, n // 16, mp2, mp)
    del tile_tq, sup_tq
    ms_r, dots_k = cuda_time(lambda: cuda_kernels.refine_dots(
        tidx, queries, db, mp, scales), torch)
    ms_rp, dots_p = cuda_time(lambda: ck._refine_dots_plain(
        tidx, queries, db, mp, scales), torch)
    e_r = float((dots_k - dots_p).abs().max())
    if not (e_c <= lim and e_r <= lim2):
        fail(f"{kind}: kernel disagrees with its plain version at the "
             f"path's shapes ({e_c:.3e} vs {lim:.3e}, {e_r:.3e} vs "
             f"{lim2:.3e})")
    worst[coarse_key] = max(worst.get(coarse_key, 0.0), e_c)
    worst[refine_key] = max(worst.get(refine_key, 0.0), e_r)
    out["coarse"] = (ms_c, ms_cp, lib_c, coarse_bound(
        n, D, nq, 1, n * D * itemsize, True, scales is not None))
    out["refine"] = (ms_r, ms_rp, refine_bound(tidx, D, itemsize, torch,
                                               scales is not None))
    say(f"phase 7 {kind} times [{card}]: {coarse_key} N={n} Q={nq} "
        f"{ms_c:.3f} ms ({2.0 * n * nq * D / ms_c / 1e9:.1f} TFLOP/s, body "
        f"{out['body']}; plain {ms_cp:.3f}, "
        f"bf16 matmul {lib_c:.3f}, bound "
        f"{out['coarse'][3][0]:.3f}), max err {e_c:.3e} (limit {lim:.3e}); "
        f"{refine_key} Q={nq} m={mp} {ms_r:.3f} ms (plain {ms_rp:.3f}, "
        f"bound {out['refine'][2][0]:.3f}), max err {e_r:.3e} (limit "
        f"{lim2:.3e})")
    del dots_k, dots_p, tidx

    if kind == "f32":
        out.update(f32_extra(state, qs, queries, card, mods, worst, lim))
    del store, index, state, forced, res, res_fast, db, arr, hi, scales
    free(torch)
    return out


def f32_extra(state, qs, queries, card, mods, worst, lim):
    """K5 at 3 passes at the fallback's shapes (N; Q=256 and Q=65); the
    legacy fast path on 256-row states: K6 over a mirror, K5 at 1 pass
    over f32."""
    np, torch, ck, cuda_kernels, topk = (
        mods["np"], mods["torch"], mods["ck"], mods["cuda_kernels"],
        mods["topk"])
    E = mods["DistanceMetric"].EUCLIDEAN
    mode = "euclidean"
    db = state["db"]
    n = db.shape[0]
    hi, lo = ck.split_hi_lo(db)
    a3 = torch.cat([hi, lo, hi], dim=1)
    del hi, lo

    def k5_at(nq):
        """K5 at 3 passes over the store's rows for the first ``nq``
        queries: (ms, plain ms, library ms, bound, max err)."""
        qThi, qlo, _, _, qrow, col, inv_col = ck._query_terms(
            queries[:nq], state["sq_norms"], state["norms"], state["valid"],
            mode)
        qTlo = qlo.to(torch.bfloat16)
        ms, k5 = cuda_time(lambda: cuda_kernels.coarse_minima_f32(
            qThi, qTlo, qrow, db, col, inv_col, 3, mode), torch)
        msp, k5p = cuda_time(lambda: ck._coarse_minima_f32_plain(
            qThi, qTlo, qrow, db, col, inv_col, 3, mode), torch)
        err = live_err(k5.T, k5p)
        del k5, k5p
        lib = library_ms(a3, torch.cat([qThi, qThi, qTlo], dim=0), torch)
        return ms, msp, lib, coarse_bound(n, D, nq, 3, n * D * 4, False), err

    k5 = {nq: k5_at(nq) for nq in (256, 65)}
    del a3
    e5 = max(k5[256][4], k5[65][4])
    k5_body = cuda_kernels.coarse_body("f32", db, 3, False)

    # legacy fast on 256-row states (one super-tile: supports() holds,
    # supports_1p() does not); every tile is refined, so the ids are exact
    small = {k: state[k][:256] for k in ("db", "sq_norms", "norms",
                                         "valid")}
    mir = dict(small)
    mir["hi"], mir["lo"] = ck.split_hi_lo(small["db"])
    mir["elo_max"] = ck.residual_max_norm(small["db"], mir["hi"])
    f32s = dict(small, coarse_f32=True,
                elo_max=ck.residual_max_norm_f32(small["db"]))
    o_d2, o_i = oracle_sq(queries, small["db"], small["sq_norms"],
                          small["valid"], K, torch)
    legacy = {}
    for name, st, key in (("mirrors", mir, "coarse_minima_1p"),
                          ("f32", f32s, "coarse_minima_f32")):
        cuda_kernels.reset_launches()
        ld, li = topk.flat_search_batched(qs, st, E, K, mode="fast")
        legacy[key] = cuda_kernels.launches[key]
        if legacy[key] < 1:
            fail(f"the legacy fast path on a 256-row {name} state launched "
                 f"no {key}: {dict(cuda_kernels.launches)}")
        if key == "coarse_minima_f32":
            check_wgmma("phase 7 legacy fast f32", key, cuda_kernels)
        check_exact(f"legacy fast {name}", li[:, :K], ld[:, :K], o_d2, o_i,
                    K, np)
    sThi, _, _, _, sqrow, scol, sinv = ck._query_terms(
        queries, small["sq_norms"], small["norms"], small["valid"], mode)
    ms6, k6 = cuda_time(lambda: cuda_kernels.coarse_minima_1p(
        sThi, sqrow, mir["hi"], scol, sinv, mode), torch)
    ms6p, k6p = cuda_time(lambda: ck._coarse_minima_1p_plain(
        sThi, sqrow, mir["hi"], scol, sinv, mode), torch)
    e6 = live_err(k6.T, k6p)
    lib6 = library_ms(mir["hi"], sThi, torch)
    b6 = coarse_bound(256, D, queries.shape[0], 1, 256 * D * 2, False)
    slim = limits(mode, float(torch.sqrt(small["sq_norms"].max())),
                  float(torch.sqrt((queries * queries).sum(1)).max()))[0]
    if not (e5 <= lim and e6 <= slim):
        fail(f"K5/K6 disagree with their plain versions at the path's "
             f"shapes ({e5:.3e}, {e6:.3e})")
    worst["coarse_minima_f32"] = max(worst.get("coarse_minima_f32", 0.0), e5)
    worst["coarse_minima_1p"] = max(worst.get("coarse_minima_1p", 0.0), e6)
    k5_line = "; ".join(
        f"Q={nq} {ms:.3f} ms (plain {msp:.3f}, bf16 matmul (N, 3d) x (3d, Q) "
        f"{lib:.3f}, bound {b[0]:.3f}), max err {err:.3e}"
        for nq, (ms, msp, lib, b, err) in k5.items())
    say(f"phase 7 legacy fast Q={queries.shape[0]} on 256-row states: "
        f"exact ids (every tile refined) via K6 ({legacy['coarse_minima_1p']}"
        f" launches) and K5 at 1 pass ({legacy['coarse_minima_f32']}, body "
        f"wgmma); times [{card}]: K5 3-pass N={n}, body {k5_body}: "
        f"{k5_line}; K6 N=256 Q={queries.shape[0]} {ms6:.3f} ms (plain "
        f"{ms6p:.3f}, bf16 matmul {lib6:.3f}, bound {b6[0]:.3f}), max err "
        f"{e6:.3e}")
    return {"k5": k5[256][:4], "k5_body": k5_body,
            "k6": (ms6, ms6p, lib6, b6), "legacy": legacy}


def http_call(port, method, path, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data, method=method,
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, json.loads(r.read())


def venue_ties(res_a, res_b, rtol, np):
    """Two re-rank venues' results: distances within ``rtol``, the same
    ids but where neighbouring distances tie within it (the venues sum
    in different orders). Returns the number of tied positions."""
    ties = 0
    for qi, (a, b) in enumerate(zip(res_a, res_b)):
        ia, ib = [i for i, _ in a], [i for i, _ in b]
        da = np.array([d for _, d in a])
        db_ = np.array([d for _, d in b])
        tol = rtol * np.abs(da) + 1e-7
        if len(ia) != len(ib) or not np.all(np.abs(da - db_) <= tol):
            fail(f"venues disagree on query {qi}: {a} vs {b}")
        for j in np.nonzero(np.array(ia) != np.array(ib))[0]:
            near = [jj for jj in (j - 1, j + 1) if 0 <= jj < len(da)
                    and abs(da[jj] - da[j]) <= 2 * tol[j]]
            if not (near or j == len(da) - 1):
                fail(f"venues return other ids on query {qi}: {ia} vs {ib}")
            ties += 1
    return ties


def pq_phase(args, rng, card, mods):
    """Phase 8 (module docstring). Returns the K8 row's numbers."""
    import torch.nn.functional as F

    from vectordb_tpu_torch.index.pq import PqFlatIndex
    from vectordb_tpu_torch.ops import pq as pq_ops
    from vectordb_tpu_torch.server.app import (AppState,
                                               start_server_background)
    np, torch, cuda_kernels = mods["np"], mods["torch"], mods["cuda_kernels"]
    VectorStore, Vector = mods["VectorStore"], mods["Vector"]
    E = mods["DistanceMetric"].EUCLIDEAN
    dev = torch.device("cuda")
    n, nq = args.rows, args.queries
    # the intrinsic-dim-32 protocol of benchmarks/pq_bench.py:103-108
    basis = (rng.standard_normal((32, D), dtype=np.float32)
             / np.float32(np.sqrt(32)))
    rows = np.empty((n, D), np.float32)
    step = 1 << 16
    for r0 in range(0, n, step):
        rows[r0:r0 + step] = rng.standard_normal(
            (min(step, n - r0), 32), dtype=np.float32) @ basis
    qs = rng.standard_normal((nq, 32), dtype=np.float32) @ basis
    dead = rng.choice(n, 1024, replace=False)
    store = VectorStore.with_index(PqFlatIndex(E, device="cuda"))
    index = store.index
    t0 = time.perf_counter()
    load_store(store, rows, dead, mods["BatchInsertItem"], Vector)
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    index.train()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    batch = [(Vector(q), K) for q in qs]

    # the path's run: only this store's searches between reset and read
    cuda_kernels.reset_launches()
    t0 = time.perf_counter()
    store.search_batch(batch)             # first batch: the full encode
    first_s = time.perf_counter() - t0
    results, batch_s = {}, {}
    for refine in PQ_REFINES:
        batch_s[refine] = []
        for _ in range(2):
            t0 = time.perf_counter()
            results[refine] = store.search_batch(batch, refine=refine)
            batch_s[refine].append(time.perf_counter() - t0)
    counts = dict(cuda_kernels.launches)
    say(f"phase 8 launch counts (the PQ store's searches): "
        f"{ {k: v for k, v in counts.items() if v} }")
    if counts["pq_decode"] < 1:
        fail(f"the PQ store's searches launched no K8: {counts}")

    # (a) distances exact for their ids, (b) recall against an on-card
    # f32 oracle over the rows as inserted (dead rows masked)
    queries = torch.from_numpy(qs).to(dev)
    db_t = torch.from_numpy(rows).to(dev)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    valid[torch.from_numpy(dead).to(dev)] = False
    ora_d2, ora_i = oracle_sq(queries, db_t, (db_t * db_t).sum(1), valid, K,
                              torch)
    recall, derr = {}, {}
    for refine, res in results.items():
        ids, dists = store_ids(res, np)
        if ids.shape != (nq, K) or np.isin(ids, dead).any():
            fail(f"PQ refine {refine}: {ids.shape} results, or a deleted "
                 f"row returned")
        sel = torch.from_numpy(ids).to(dev)
        true = torch.sqrt(((db_t[sel] - queries[:, None, :]) ** 2).sum(-1))
        true = true.cpu().numpy()
        err = np.abs(dists - true)
        if not np.all(err <= 2e-5 * true + 1e-6):
            fail(f"PQ refine {refine}: a returned distance is off its id's "
                 f"f32 distance by {err.max():.3e}")
        derr[refine] = float(err.max())
        recall[refine] = float(np.mean([len(set(a) & set(b)) / K for a, b
                                        in zip(ids, ora_i[:, :K])]))
    if recall[64] < 0.95:
        fail(f"PQ recall@{K} at refine 64 is {recall[64]:.4f} < 0.95")

    # (c) at Q=256 the scan's pool with K8 is the pool with the plain decode
    with index._lock:
        state = dict(index._scan_state())
        rr_rows = index._sync_device()["db"]
    chunk, rot, m = index._scan_chunk(), index._rot_dev_arr(), index._m
    q256 = queries[:256]

    def scan(qb, r=64):
        return pq_ops.pq_scan_topr(qb, state["codes"], state["codebook"],
                                   state["cnorm"], state["valid"], E, r=r,
                                   chunk=chunk, rot=rot)

    sv_k, sl_k = scan(q256)
    real = pq_ops.pq_decode_rows
    pq_ops.pq_decode_rows = pq_ops._decode_rows_plain
    try:
        sv_p, sl_p = scan(q256)
    finally:
        pq_ops.pq_decode_rows = real
    if not (torch.equal(sl_k, sl_p) and torch.equal(sv_k, sv_p)):
        fail("the scan's pool with K8 differs from the plain decode's")

    # (e) the pool's scores are the f32 surrogate |x_hat|^2 - 2 q.x_hat:
    # held against an f64 recomputation from the decoded rows. The limit
    # (PQ_SCORE_LIMIT) must break for a bf16-output score GEMM and for a
    # dropped q_lo term, the two losses of precision recall cannot see here
    qr = pq_ops._maybe_rotate(q256, rot)
    xh = pq_ops._decode_rows_plain(state["codes"][sl_k.reshape(-1)],
                                   state["codebook"]).reshape(256, 64, D)
    x64, q64 = xh.double(), qr.double()
    xsq64 = (x64 * x64).sum(-1)
    ref = xsq64 - 2.0 * torch.bmm(x64, q64[:, :, None])[..., 0]
    lim = PQ_SCORE_LIMIT * (xsq64 + 2.0 * torch.sqrt(xsq64)
                            * torch.sqrt((q64 * q64).sum(1))[:, None])
    live = torch.isfinite(sv_k)

    def off(scores):
        return float(((scores.double() - ref).abs() / lim)[live].max())

    q_hi, q_lo = pq_ops._split_query(qr)
    d_bf = (torch.bmm(xh, q_hi[:, :, None])
            + torch.bmm(xh, q_lo[:, :, None]))[..., 0]        # bf16 out
    d_nolo = torch.bmm(xh.float(), q_hi.float()[:, :, None])[..., 0]
    score_off = {"scan": off(sv_k), "bf16 GEMM": off(xsq64 - 2.0 * d_bf),
                 "no q_lo": off(xsq64 - 2.0 * d_nolo)}
    if score_off["scan"] > 1.0:
        fail(f"the scan's scores are off their f64 recomputation: "
             f"{score_off} (in units of the limit)")
    if min(score_off["bf16 GEMM"], score_off["no q_lo"]) <= 1.0:
        fail(f"a score control passed the limit: {score_off}")
    del xh, x64, ref, lim, d_bf, d_nolo

    # (d) the "mirror" and "host" re-rank venues agree at Q=256
    if index._rerank_venue() != "mirror":
        fail(f"PQ on the card re-ranks on {index._rerank_venue()!r}")
    res_m = index.search_batch(qs[:256], K)
    index.rerank_mode = "host"
    res_h = index.search_batch(qs[:256], K)
    index.rerank_mode = "auto"
    vties = venue_ties(res_m, res_h, 1e-6, np)

    # HTTP: one /search with "refine": 32
    server, thread = start_server_background("127.0.0.1:0", AppState(store))
    try:
        st, hits = http_call(server.server_address[1], "POST", "/search",
                             {"vector": qs[0].tolist(), "k": K,
                              "refine": 32})
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    if st != 200 or [h["id"] for h in hits] != [r.id for r in
                                                results[32][0]]:
        fail(f"PQ HTTP /search refine 32: {st} {hits[:2]}")

    # one batch at refine 64, split: scan, device re-rank, host mapping
    # (twice, after a collection: a collector pause over ~1M stored ids
    # would land in whichever step it hits)
    splits = []
    for _ in range(2):
        gc.collect()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sv, sl = index._scan_call(state, queries, 64)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        dv, ds = pq_ops.pq_rerank_topk(queries, rr_rows, sl, sv,
                                       state["valid"], E, K)
        dv_h, ds_h = dv.cpu().numpy(), ds.cpu().numpy()
        t2 = time.perf_counter()
        raw = index._collect_device_rerank(qs, [(dv_h, ds_h, sv, sl, nq)],
                                           K, index._tick,
                                           index.slot_layout_version, None)
        mapped = [store._map_results(r) for r in raw]
        t3 = time.perf_counter()
        if [r.id for r in mapped[0]] != [r.id for r in results[64][0]]:
            fail("the split batch disagrees with the store's batch")
        splits.append(((t1 - t0) * 1e3, (t2 - t1) * 1e3, (t3 - t2) * 1e3))

    # K8 at the scan chunk, and the scan's other per-chunk steps
    cb_bf = state["codebook"]
    ksub, dsub = cb_bf.shape[1], cb_bf.shape[2]
    cc = state["codes"][:chunk]
    ms8, dec_k = cuda_time(lambda: cuda_kernels.pq_decode(cc, cb_bf), torch,
                           iters=20)
    ms8p, dec_p = cuda_time(lambda: pq_ops._decode_rows_plain(cc, cb_bf),
                            torch, iters=20)
    flat_cb = cb_bf.reshape(m * ksub, dsub)
    emb_idx = cc.long() + torch.arange(m, device=dev) * ksub
    ms8l, dec_l = cuda_time(lambda: F.embedding(emb_idx, flat_cb), torch,
                            iters=20)
    if not (torch.equal(dec_k.view(torch.int16), dec_p.view(torch.int16))
            and torch.equal(dec_l.reshape(chunk, -1).view(torch.int16),
                            dec_p.view(torch.int16))):
        fail("K8 (or F.embedding) differs from the plain decode at the "
             "scan chunk")
    b8 = bound(0.0, chunk * m + m * ksub * dsub * 2 + chunk * D * 2,
               PEAK_BF16)
    q_hi, q_lo = pq_ops._split_query(pq_ops._maybe_rotate(queries, rot))
    ms_gemm, scores = cuda_time(lambda: pq_ops._score_dots(q_hi, q_lo,
                                                           dec_k), torch)
    if scores.dtype != torch.float32:
        fail(f"the score GEMM returned {scores.dtype}")
    ms_topk, _ = cuda_time(lambda: torch.topk(scores, 64, dim=1,
                                              largest=False), torch)
    nc = n // chunk
    say(f"phase 8 PQ store N={n} ({len(dead)} deleted) x {D}, m={m}, "
        f"ksub={ksub}, OPQ, Q={nq} k={K}: load {load_s:.3f} s (host); train "
        f"{train_s:.3f} s; first batch (incl. the full encode) "
        f"{first_s * 1e3:.3f} ms; per batch at refine 64 "
        f"{[round(t * 1e3, 3) for t in batch_s[64]]} ms, at refine 32 "
        f"{[round(t * 1e3, 3) for t in batch_s[32]]} ms; recall@{K} "
        f"{recall[64]:.4f} (refine 64), {recall[32]:.4f} (refine 32) "
        f"against the f32 oracle; returned distances = their ids' f32 "
        f"distances (max err {max(derr.values()):.3e}); Q=256 pool with K8 "
        f"= plain decode's; pool scores vs f64, in units of the limit "
        f"{PQ_SCORE_LIMIT:.3g} S: "
        f"{ {k: round(v, 4) for k, v in score_off.items()} }; mirror vs host venues agree ({vties} tied "
        f"positions); HTTP /search refine 32 -> {st}  [{card}]")
    say(f"phase 8 times [{card}]: one refine-64 batch = scan "
        f"{[round(x[0], 3) for x in splits]} ms + device re-rank "
        f"{[round(x[1], 3) for x in splits]} ms + host mapping "
        f"{[round(x[2], 3) for x in splits]} ms; per scan chunk ({chunk} "
        f"rows, {nc} "
        f"chunks): K8 {ms8:.4f} ms (plain {ms8p:.4f}, F.embedding "
        f"{ms8l:.4f}, bound {b8[0]:.4f}), score GEMMs bf16->f32 "
        f"{ms_gemm:.3f} ms ({4.0 * nq * chunk * D / ms_gemm / 1e9:.1f} "
        f"TFLOP/s), top-64 {ms_topk:.3f} ms")
    out = {"launches": counts["pq_decode"], "ms": ms8, "plain_ms": ms8p,
           "bound": b8, "library_ms": ms8l}
    del store, index, state, rr_rows, db_t, queries, scores, dec_k, dec_p
    del dec_l, sv, sl, dv, ds, sv_k, sl_k, sv_p, sl_p, results, res_m, res_h
    free(torch)
    return out


def oracle_metric(queries, db, sq, valid, metric, k, torch):
    """On-card f32 oracle of any metric (chunked matmul at "highest"
    precision, dead rows masked, exact top-(k+1)): (dists, ids)."""
    outs_d, outs_i = [], []
    norms = torch.sqrt(sq)
    for q0 in range(0, queries.shape[0], 256):
        q = queries[q0:q0 + 256]
        dots = q @ db.T
        if metric == "euclidean":
            d = torch.sqrt(torch.clamp((q * q).sum(1, keepdim=True)
                                       + sq[None, :] - 2.0 * dots, min=0.0))
        elif metric == "dot_product":
            d = -dots
        else:
            den = torch.sqrt((q * q).sum(1, keepdim=True)) * norms[None, :]
            den = torch.where(den == 0.0, torch.ones_like(den), den)
            d = 1.0 - torch.clamp(dots / den, -1.0, 1.0)
        d = torch.where(valid[None, :], d, float("inf"))
        v, i = torch.topk(d, k + 1, dim=1, largest=False)
        outs_d.append(v)
        outs_i.append(i)
    return torch.cat(outs_d).cpu().numpy(), torch.cat(outs_i).cpu().numpy()


def k9_phase(rows, qs, rng, card, mods):
    """Phase 9 (module docstring). Returns the K9 row's numbers."""
    from vectordb_tpu_torch.ops import flat_kernel as fk
    np, torch, cuda_kernels = mods["np"], mods["torch"], mods["cuda_kernels"]
    dev = torch.device("cuda")
    n, nq = rows.shape[0], min(K9_QUERIES, qs.shape[0])
    db = torch.from_numpy(rows).to(dev)
    valid = torch.from_numpy(rng.random(n) >= 0.1).to(dev)
    queries = torch.from_numpy(qs[:nq]).to(dev)
    sq = (db * db).sum(1)
    norms = torch.sqrt(sq)
    metrics = ("euclidean", "dot_product", "cosine")
    got = {}
    # the path's run: the three searches between reset and read
    cuda_kernels.reset_launches()
    for metric in metrics:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d_, i_ = fk.two_phase_search(queries, db, sq, norms, valid, metric, K)
        got[metric] = (d_.cpu().numpy(), i_.cpu().numpy(),
                       time.perf_counter() - t0)
    launches = cuda_kernels.launches["scan_min"]
    if launches < len(metrics):
        fail(f"the two-phase searches launched K9 {launches} times")
    notes = []
    for metric in metrics:
        ora_d, ora_i = oracle_metric(queries, db, sq, valid, metric, K,
                                     torch)
        d_, i_, secs = got[metric]
        ties, err = check_exact_d(f"two-phase {metric}", i_[:, :K],
                                  d_[:, :K], ora_d, ora_i, K, np)
        notes.append(f"{metric} {secs * 1e3:.3f} ms ({ties} ties, max err "
                     f"{err:.3e})")
    # K9 against its plain version at the path's shape (euclidean)
    inv = 1.0 - valid.float()
    qsq = (queries * queries).sum(1)
    ms9, t9 = cuda_time(lambda: cuda_kernels.scan_min(
        queries, qsq, db, sq, inv, "euclidean", 512), torch)
    ms9p, t9p = cuda_time(lambda: fk._tile_minima_plain(
        queries, qsq, db, sq, inv, "euclidean", 512), torch)
    e9 = live_err(t9, t9p)
    del t9
    s9 = float(torch.sqrt(sq.max() * qsq.max()))
    c9 = live_err(fk._tile_minima_plain(
        queries.bfloat16().float(), qsq, db.bfloat16().float(), sq, inv,
        "euclidean", 512), t9p)
    if not e9 <= K9_LIMIT * s9 < c9:
        fail(f"K9 at the path's shape: err {e9:.3e}, control {c9:.3e}, "
             f"limit {K9_LIMIT * s9:.3e}")
    lib9, _ = cuda_time(lambda: queries @ db.T, torch)
    b9 = bound(2.0 * nq * n * D, n * D * 4 + nq * D * 4 + 3 * n * 4
               + nq * 4 + nq * (n // 512) * 4, PEAK_F32)
    say(f"phase 9 two-phase search N={n} x {D} f32 (10% dead) Q={nq} k={K}:"
        f" exact against the f32 oracle: {'; '.join(notes)}; K9 launches "
        f"{launches}  [{card}]")
    say(f"phase 9 times [{card}]: K9 N={n} Q={nq} {ms9:.3f} ms (plain "
        f"{ms9p:.3f}, f32 matmul {lib9:.3f}, bound {b9[0]:.3f}, "
        f"{2.0 * nq * n * D / ms9 / 1e9:.1f} TFLOP/s), max err {e9:.3e} "
        f"(limit {K9_LIMIT * s9:.3e}, bf16-operand control {c9:.3e})")
    del db, valid, queries, sq, norms, t9p, inv
    free(torch)
    return {"launches": launches, "err": e9, "ms": ms9, "plain_ms": ms9p,
            "bound": b9, "library_ms": lib9}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=1 << 20)
    ap.add_argument("--queries", type=int, default=4096)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    sys.path.insert(0, ROOT)
    try:
        import numpy as np
        from vectordb_tpu_torch import (BatchInsertItem, DistanceMetric,
                                        Vector, VectorStore)
        from vectordb_tpu_torch.index import flat
        from vectordb_tpu_torch.ops import coarse_kernel as ck
        from vectordb_tpu_torch.ops import cuda_kernels, topk
        from vectordb_tpu_torch.server.app import (AppState,
                                                   start_server_background)
    except ImportError as e:
        fail(f"the vectordb_tpu_torch package is not beside this script "
             f"({e})")
    os.makedirs(OUT_DIR, exist_ok=True)
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    card = card_line()
    say(f"card: {card}")
    nvcc = subprocess.run([cuda_kernels._nvcc(), "--version"],
                          capture_output=True, text=True).stdout
    say(f"versions: python {sys.version.split()[0]} torch {torch.__version__}"
        f" cuda {torch.version.cuda} nvcc "
        f"{nvcc.strip().splitlines()[-1] if nvcc else '?'}")
    t0 = time.perf_counter()
    info = cuda_kernels.load()
    say(f"phase 1 build: {time.perf_counter() - t0:.3f} s "
        f"(nvcc {info['seconds']:.3f} s, one process per source) -> "
        f"{os.path.relpath(info['path'], ROOT)}")
    with open(os.path.join(OUT_DIR, "kernel_build.log"), "w") as f:
        f.write(info["log"])
    rng = np.random.default_rng(args.seed)
    mode_of = {DistanceMetric.EUCLIDEAN: "euclidean",
               DistanceMetric.DOT_PRODUCT: "dot",
               DistanceMetric.COSINE: "cosine"}

    # -- phase 2: kernels against their plain versions ------------------
    worst: dict = {}
    phase2(rng, mode_of, card, np, torch, ck, cuda_kernels, flat, worst)
    # its own generators: the rows of the later phases stay those of
    # earlier runs
    accum = accum_phase(np.random.default_rng([args.seed, 2]),
                        np.random.default_rng([args.seed, 3]), card, np,
                        torch, ck, cuda_kernels)
    free(torch)

    # -- phase 3: the slice at full size through the entry points -------
    n, nq = args.rows, args.queries
    if n != 1 << 20 or nq != 4096:
        say(f"NOTE: reduced run: rows {n}, queries {nq} (full size is "
            f"1048576 x 768, Q=4096)")
    store = VectorStore.with_flat_index(DistanceMetric.EUCLIDEAN,
                                        device="cuda")
    t0 = time.perf_counter()
    rows = make_rows(rng, n, D, np)
    dead = rng.choice(n, n // 1024, replace=False)
    load_store(store, rows, dead, BatchInsertItem, Vector)
    say(f"phase 3 load: {len(store)} live rows x {D} in "
        f"{time.perf_counter() - t0:.3f} s (host)")
    small = VectorStore.with_flat_index(DistanceMetric.EUCLIDEAN,
                                        device="cuda")
    srows = make_rows(rng, 20000, D, np)
    small.insert_batch([BatchInsertItem(str(i), Vector(srows[i]))
                        for i in range(20000)])
    qs = rng.standard_normal((nq, D), dtype=np.float32)
    batch = [(Vector(q), K) for q in qs]
    small_batch = batch[:1024]

    # the main path's run: only store searches between reset and read
    cuda_kernels.reset_launches()
    t0 = time.perf_counter()
    res = store.search_batch(batch)     # first search builds device state
    first_s = time.perf_counter() - t0
    exact_s = []
    for _ in range(2):
        t0 = time.perf_counter()
        res = store.search_batch(batch)
        exact_s.append(time.perf_counter() - t0)
    index = store.index
    index.search_mode = "fast"
    fast_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        res_fast = store.search_batch(batch)
        fast_s.append(time.perf_counter() - t0)
    index.search_mode = "exact"
    k3_big = cuda_kernels.launches["coarse_minima"]
    t0 = time.perf_counter()
    sres = small.search_batch(small_batch)
    small_s = time.perf_counter() - t0
    counts = dict(cuda_kernels.launches)
    k1_bodies = check_wgmma("phase 3", "coarse_minima_1p_sup", cuda_kernels)
    # K3: tier 2 of the big store's uncertified queries, the 20k-row store
    k3_bodies = check_wgmma("phases 3-4", "coarse_minima", cuda_kernels)
    k3_small = counts["coarse_minima"] - k3_big

    with index._lock:
        state = dict(index._sync_device())
    queries = torch.from_numpy(qs).to(dev)
    ora_d2, ora_i = oracle_sq(queries, state["db"], state["sq_norms"],
                              state["valid"], K, torch)
    ids, dists = store_ids(res, np)
    ties, derr = check_exact("slice exact", ids, dists, ora_d2, ora_i, K, np)
    fids, _ = store_ids(res_fast, np)
    fast_agree = float(np.mean([len(set(a) & set(b)) / K
                                for a, b in zip(fids, ora_i[:, :K])]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    topk.flat_search_exact_tiled(queries, state["db"], state["sq_norms"],
                                 state["norms"], state["valid"],
                                 DistanceMetric.EUCLIDEAN, K)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    say(f"phase 3 slice N={n} Q={nq} k={K}: exact ids match the oracle "
        f"({ties} boundary ties), max dist err {derr:.3e}; first batch "
        f"(incl. device build) {first_s * 1e3:.3f} ms; exact per batch "
        f"{[round(s * 1e3, 3) for s in exact_s]} ms; fast per batch "
        f"{[round(s * 1e3, 3) for s in fast_s]} ms (top-{K} agreement "
        f"{fast_agree:.4f}); plain tier-3 scan {plain_s * 1e3:.3f} ms  "
        f"[{card}]")
    path_keys = ("coarse_minima_1p_sup", "coarse_minima", "refine_dots")
    say(f"launch counts (main path: the store searches of phases 3 and 4): "
        f"{ {k: counts[k] for k in path_keys} }; K1 by body {k1_bodies}; "
        f"K3 by body {k3_bodies} ({k3_big} in the 2^20-row store's tier 2)")
    if min(counts[k] for k in path_keys) < 1:
        fail(f"a kernel of the path never launched: {counts}")

    # -- phase 4: small store (tier 2) and a forced fallback ------------
    with small.index._lock:
        sstate = dict(small.index._sync_device())
    o_d2, o_i = oracle_sq(queries[:1024], sstate["db"], sstate["sq_norms"],
                          sstate["valid"], K, torch)
    sties, _ = check_exact("small store", *store_ids(sres, np), o_d2, o_i,
                           K, np)
    if k3_small < 1:
        fail("the 20000-row store's search launched no K3")
    forced = dict(state)
    forced["elo_max"] = torch.tensor(1e9, device=dev)
    cert = ck.coarse_search_1p(queries[:256], forced["db"],
                               forced["sq_norms"], forced["norms"],
                               forced["valid"], forced["hi"],
                               forced["elo_max"], DistanceMetric.EUCLIDEAN,
                               K)[2]
    if bool(cert.any()):
        fail("inflated elo_max still certified a query")
    k3_before = cuda_kernels.launches["coarse_minima"]
    fd, fi = topk.flat_search_batched(qs[:256], forced,
                                      DistanceMetric.EUCLIDEAN, K)
    if cuda_kernels.launches["coarse_minima"] == k3_before:
        fail("the forced fallback did not run tier 2 (K3)")
    k3_bodies = check_wgmma("phase 4 forced fallback", "coarse_minima",
                            cuda_kernels)
    fties, _ = check_exact("forced fallback", fi[:, :K], fd[:, :K],
                           ora_d2[:256], ora_i[:256], K, np)
    say(f"phase 4 small store 20000 x {D} (tier 2) Q=1024 exact "
        f"({sties} ties) in {small_s * 1e3:.3f} ms, K3 launches {k3_small};"
        f" forced fallback Q=256 certified 0/256 in tier 1, exact after "
        f"fallback ({fties} ties); K3 by body since phase 3 {k3_bodies}  "
        f"[{card}]")

    # -- phase 5: HTTP -------------------------------------------------
    hstore = VectorStore.with_flat_index(DistanceMetric.EUCLIDEAN,
                                         device="cuda")
    server, thread = start_server_background("127.0.0.1:0",
                                             AppState(hstore))
    port = server.server_address[1]

    def call(method, path, body=None):
        return http_call(port, method, path, body)

    try:
        hrows = srows[:512]
        st, _ = call("POST", "/vectors/batch", {"vectors": [
            {"id": f"v{i}", "vector": hrows[i].tolist()}
            for i in range(len(hrows))]})
        st1, hits = call("POST", "/search",
                         {"vector": hrows[7].tolist(), "k": 5})
        st2, bhits = call("POST", "/search/batch", {"queries": [
            {"vector": hrows[i].tolist(), "k": 3} for i in (1, 2)]})
        st3, health = call("GET", "/health")
        st4, metrics = call("GET", "/metrics")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    if (st, st1, st2, st3, st4) != (201, 200, 200, 200, 200):
        fail(f"HTTP statuses {(st, st1, st2, st3, st4)}")
    if hits[0]["id"] != "v7" or [b[0]["id"] for b in bhits] != ["v1", "v2"]:
        fail(f"HTTP search top hits wrong: {hits[0]}, {bhits}")
    if health["vector_count"] != 512 or metrics["total_queries"] != 2:
        fail(f"HTTP health/metrics wrong: {health}, {metrics}")
    say(f"phase 5 http on 127.0.0.1:{port}: batch insert 512 -> 201, "
        f"/search top hit v7, /search/batch top hits v1 v2, /health "
        f"{health['vector_count']}, /metrics {metrics['total_queries']} "
        f"queries")

    # -- phase 6: kernel vs plain at the main path's shapes: agreement
    # and time (these launches are not counted) -------------------------
    mode = "euclidean"
    qThi, qlo, qsq, qn, qrow, col, inv_col = ck._query_terms(
        queries, state["sq_norms"], state["norms"], state["valid"], mode)
    xmax = float(torch.sqrt(state["sq_norms"].max()))
    lim, lim2 = limits(mode, xmax, float(qn.max()))
    ms1, (tile_tq, sup_tq) = cuda_time(
        lambda: cuda_kernels.coarse_minima_1p_sup(qThi, qrow, state["hi"],
                                                  col, inv_col, mode), torch)
    ms1p, (tile_p, sup_p) = cuda_time(lambda: ck._minima_1p_sup_plain(
        qThi, qrow, state["hi"], col, inv_col, mode), torch)
    e1 = max(live_err(tile_tq, tile_p), live_err(sup_tq, sup_p))
    del tile_p, sup_p
    lib1 = library_ms(state["hi"], qThi, torch)
    mp2, mp = ck._exact1p_pool(K, n // 16)
    tidx, _ = ck._select_tiles_1p(tile_tq, sup_tq, nq, n // 16, mp2, mp)
    del tile_tq, sup_tq
    ms2, dots_k = cuda_time(lambda: cuda_kernels.refine_dots(
        tidx, queries, state["db"], mp), torch)
    ms2p, dots_p = cuda_time(lambda: ck._refine_dots_plain(
        tidx, queries, state["db"], mp), torch)
    e2 = float((dots_k - dots_p).abs().max())
    b2 = refine_bound(tidx, D, 4, torch)
    del dots_k, dots_p
    # K3 at its three shapes: the 2^20-row store's tier 2 (Q=65 of its
    # 4096 queries stay uncertified) and forced fallback (Q=256), the
    # 20k-row store (Q=1024)
    k3 = [k3_at(state, queries, 65, mode, torch, ck, cuda_kernels),
          k3_at(state, queries, 256, mode, torch, ck, cuda_kernels),
          k3_at(sstate, queries, 1024, mode, torch, ck, cuda_kernels)]
    say(f"phase 6 agreement at the main path's shapes: K1 {e1:.3e} (limit "
        f"{lim:.3e}); K2 {e2:.3e} (limit {lim2:.3e}); K3 3-pass " + "; ".join(
            f"N={r['n']} Q={r['q']} {r['err']:.3e} (limit {r['limit']:.3e};"
            f" control, 1-pass kernel: {r['control']:.3e})" for r in k3)
        + f"  [{card}]")
    if not (e1 <= lim and e2 <= lim2
            and all(r["err"] <= r["limit"] for r in k3)):
        fail("kernel disagrees with its plain version at the main path's "
             "shapes")
    if not all(r["control"] > r["limit"] for r in k3):
        fail("the 1-pass control passed the K3 limit at the main path's "
             "shapes")
    if any(r["body"] != "wgmma" for r in k3):
        fail(f"K3 at the main path's shapes does not route to wgmma: "
             f"{[r['body'] for r in k3]}")
    worst["coarse_minima_1p_sup"] = max(worst["coarse_minima_1p_sup"], e1)
    worst["refine_dots"] = max(worst["refine_dots"], e2)
    worst["coarse_minima"] = max([worst["coarse_minima"]]
                                 + [r["err"] for r in k3])
    _, _, cert = ck.coarse_search_1p(queries, state["db"],
                                     state["sq_norms"], state["norms"],
                                     state["valid"], state["hi"],
                                     state["elo_max"],
                                     DistanceMetric.EUCLIDEAN, K)
    rate = float(cert.float().mean())
    b1 = coarse_bound(n, D, nq, 1, n * D * 2, True)
    k3_line = "; ".join(
        f"N={r['n']} Q={r['q']} {r['ms']:.3f} ms "
        f"({6.0 * r['n'] * r['q'] * D / r['ms'] / 1e9:.1f} TFLOP/s; plain "
        f"{r['plain_ms']:.3f}, bf16 matmul (N, 3d) x (3d, Q) "
        f"{r['library_ms']:.3f}, bound {r['bound'][0]:.3f} by "
        f"{r['bound'][1]})" for r in k3)
    say(f"phase 6 times [{card}]: K1 N={n} Q={nq} {ms1:.3f} ms "
        f"({2.0 * n * nq * D / ms1 / 1e9:.1f} TFLOP/s, body "
        f"{cuda_kernels.coarse_body('mirrors', state['hi'], 1, True)}; plain "
        f"{ms1p:.3f}, bf16 matmul {lib1:.3f}, bound {b1[0]:.3f}); K2 Q={nq} "
        f"m={mp} {ms2:.3f} ms (plain {ms2p:.3f}, bound {b2[0]:.3f}); K3 "
        f"3-pass (body {k3[0]['body']}) {k3_line}; tier-1 "
        f"certification rate {rate:.6f} ({int(cert.sum())}/{nq}) with "
        f"the wgmma coefficient {ck._accum_coeff('wgmma')} (phase-2 K1 "
        f"reading {max(v for (k, _, _), v in accum.items() if k == 'K1'):.6f})")
    table = [
        kernel_row("K1 coarse_minima_1p_sup", "coarse_wgmma.cu", 261,
                   counts["coarse_minima_1p_sup"],
                   worst["coarse_minima_1p_sup"], ms1, ms1p, b1, lib1,
                   body="wgmma"),
        kernel_row("K2 refine_dots", "refine_dots.cu", 471,
                   counts["refine_dots"], worst["refine_dots"], ms2, ms2p,
                   b2, None),
        # K3's row: the big store's tier 2 (most of its launches), the
        # other two shapes beside it
        kernel_row("K3 coarse_minima", "coarse_wgmma.cu", 96,
                   counts["coarse_minima"], worst["coarse_minima"],
                   k3[0]["ms"], k3[0]["plain_ms"], k3[0]["bound"],
                   k3[0]["library_ms"], body=k3[0]["body"],
                   shapes=[{"N": r["n"], "Q": r["q"], "ms": r["ms"],
                            "plain_ms": r["plain_ms"],
                            "bound_ms": r["bound"][0],
                            "bound_by": r["bound"][1],
                            "library_ms": r["library_ms"]} for r in k3])]
    del store, small, hstore, state, sstate, forced, res, res_fast, sres
    del tidx, index
    free(torch)

    # -- phase 7: the storage modes at full size ------------------------
    mods = dict(np=np, torch=torch, ck=ck, cuda_kernels=cuda_kernels,
                topk=topk, flat=flat, VectorStore=VectorStore,
                DistanceMetric=DistanceMetric, Vector=Vector,
                BatchInsertItem=BatchInsertItem, accum=accum)
    got = {kind: storage_phase(kind, rows, dead, qs, queries, card, mods,
                               worst)
           for kind in ("bf16", "int8", "f32")}
    f32 = got["f32"]
    table[2:2] = [
        kernel_row("K2 refine_dots_bf16 (bf16 rows)", "refine_dots.cu", 471,
                   got["bf16"]["counts"]["refine_dots_bf16"],
                   worst["refine_dots_bf16"], *got["bf16"]["refine"][:2],
                   got["bf16"]["refine"][2], None),
        kernel_row("K2 refine_dots_int8 (int8 codes x pow2 scales)",
                   "refine_dots.cu", 471,
                   got["int8"]["counts"]["refine_dots_int8"],
                   worst["refine_dots_int8"], *got["int8"]["refine"][:2],
                   got["int8"]["refine"][2], None)]
    # K5's windows: the f32 store's searches (tier 2), its forced
    # fallback, the legacy fast run
    k5_launches = (f32["counts"]["coarse_minima_f32"]
                   + f32["fb_counts"]["coarse_minima_f32"]
                   + f32["legacy"]["coarse_minima_f32"])
    table += [
        kernel_row("K4 coarse_minima_f32_1p_sup", "coarse_wgmma.cu", 295,
                   f32["counts"]["coarse_minima_f32_1p_sup"],
                   worst["coarse_minima_f32_1p_sup"], f32["coarse"][0],
                   f32["coarse"][1], f32["coarse"][3], f32["coarse"][2],
                   body="wgmma"),
        kernel_row("K5 coarse_minima_f32", "coarse_wgmma.cu", 704,
                   k5_launches, worst["coarse_minima_f32"], f32["k5"][0],
                   f32["k5"][1], f32["k5"][3], f32["k5"][2],
                   body=f32["k5_body"]),
        kernel_row("K6 coarse_minima_1p", "coarse_minima.cu", 185,
                   f32["legacy"]["coarse_minima_1p"],
                   worst["coarse_minima_1p"], f32["k6"][0], f32["k6"][1],
                   f32["k6"][3], f32["k6"][2]),
        kernel_row("K7 coarse_minima_int8_1p_sup", "coarse_wgmma.cu", 329,
                   got["int8"]["counts"]["coarse_minima_int8_1p_sup"],
                   worst["coarse_minima_int8_1p_sup"],
                   got["int8"]["coarse"][0], got["int8"]["coarse"][1],
                   got["int8"]["coarse"][3], got["int8"]["coarse"][2],
                   body=got["int8"]["body"])]

    # -- phase 8: PQ-Flat at full width ----------------------------------
    k8 = pq_phase(args, rng, card, mods)
    # -- phase 9: the two-phase exact scan (K9) ---------------------------
    k9 = k9_phase(rows, qs, rng, card, mods)
    table += [
        kernel_row("K8 pq_decode", "pq_decode.cu", 286, k8["launches"],
                   worst["pq_decode"], k8["ms"], k8["plain_ms"], k8["bound"],
                   k8["library_ms"], src="vectordb_tpu/ops/pq.py"),
        kernel_row("K9 scan_min", "scan_min.cu", 43, k9["launches"],
                   max(worst["scan_min"], k9["err"]), k9["ms"],
                   k9["plain_ms"], k9["bound"], k9["library_ms"],
                   src="vectordb_tpu/ops/flat_kernel.py")]
    if min(r["launches"] for r in table) < 1:
        fail(f"a kernel never launched on its path: "
             f"{[(r['name'], r['launches']) for r in table]}")
    if "jax" in sys.modules:
        fail("jax was imported")
    say(f"total {time.perf_counter() - t_start:.3f} s")
    say(json.dumps({"kernels": table}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
