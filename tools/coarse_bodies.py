#!/usr/bin/env python3
"""Time the two coarse bodies of K1, K4, K7, K5, K3 and K6 side by side
on one card, K2 on its three sources, and K9 against its plain version.

    python3 tools/coarse_bodies.py [--rows N] [--queries Q] [--dim D]
                                   [--iters I] [--seed S]
                                   [--kernels K1,K4,K7,K5,K3,K6,K2,K8,K9]
                                   [--root DIR]

Seeded N(0,1) rows (N x D: f32, their bf16 hi and lo mirrors, and int8
codes with pow2 row scales of the same rows) and Q queries, 10% of the
rows dead. For K1 (bf16 mirror, Q queries), K4 (f32 rows, Q), K7 (int8
codes, Q), K5 at 3 passes (f32 rows, 256 and 65 queries: the forced
fallback's and the tier-2 re-run's shapes) and K3 at 3 passes (the hi and
lo mirrors: N rows at 65 and 256 queries, the mirrors store's tier 2 and
its forced fallback, and 32768 rows at 1024 queries, the 20k-row store's
shape) it runs the "wgmma" body (csrc/coarse_wgmma.cu, the route the
wrappers take at these shapes) and the "mma_sync" body
(csrc/coarse_minima.cu, called through its C entry point directly), in
turns (mma_sync, wgmma, wgmma, mma_sync), each timed by CUDA events over I
launches after a warm-up, and prints each time beside its TFLOP/s (2 N Q
D flops per pass), one bf16 torch.matmul of the same GEMM shape ((N, 3D)
x (3D, Q) for 3 passes) and the bound (the larger of the flops at 989
TFLOP/s and the bytes -- rows, queries, per-row terms and minima, each
once -- at 3.35 TB/s), and the largest difference between the two
bodies' tile (and super) minima over live tiles.

K6 (``--kernels K6``): one bf16 pass without super minima over the first
256 rows (the legacy fast path's state) for Q queries on both bodies, the
"wgmma" body through ``cuda_kernels.coarse_minima_1p`` (its route) and
the "mma_sync" body through its C entry point, beside a bf16 torch.matmul
of the same GEMM: each call timed by CUDA events over max(I, 50)
launches, and each call's kernels timed by ``torch.profiler`` over the
same count (device time per call, by kernel name: the wgmma call's
K-major query copy apart from the coarse kernel).

K2 (``--kernels K2``): the refine dots at the main path's selection -- K1's
minima over the bf16 mirror of the rows, ``_select_tiles_1p`` with the
pool of k=10 (m=32 at N=2^20) -- over the f32 rows, their bf16 mirror and
the int8 codes with their pow2 scales, each ``cuda_kernels.refine_dots``
call (work list included) timed over max(I, 10) launches, beside its body,
its bound (the distinct candidate rows read once, as chip_smoke.py's
``refine_bound``), the pairs per distinct tile and the largest difference
from ``_refine_dots_plain``.

K9 (``--kernels K9``): the euclidean per-tile minima of 512-row tiles of
the f32 rows for the first min(Q, 1024) queries through
``cuda_kernels.scan_min``, timed beside its plain version, one f32
torch.matmul of the same product and its bound (the flops at the 67
TFLOP/s f32 rate), with its largest difference from the plain version.
K8 (``--kernels K8``): the PQ decode at the scan chunk (16384 rows, m=96,
ksub=256, dsub=8: seeded codes and a bf16 codebook) through
``cuda_kernels.pq_decode`` (the route's body: "tile_ring" since K8's
redesign, the one body before it) and through the "grid_stride" body's C
entry point (every version has it), beside ``F.embedding`` of the same
lookup, in turns (grid_stride, route, route, grid_stride): each call
timed by CUDA events over max(I, 200) launches, and its kernels by
``torch.profiler`` over the same count; a fill of the output's bytes as
the floor; the host time of a call, its stream lookup and its
allocation (perf_counter over 500 calls); then each body followed by
the scan's two score GEMMs (``pq._score_dots`` of Q queries' hi/lo split
against the decoded chunk), timed per chunk over 20 and split into
kernels. Every output is held bit for bit to the plain decode; the bound
is the codes, the codebook and the output, each once, at 3.35 TB/s.
``--root`` imports vectordb_tpu_torch from another checkout (a parent
commit unpacked with ``git archive``), so two versions of K2 or K9 (or of
the wgmma call of K6) are timed by running this script once per root, in
turns, in one call; the other bodies are reached through the C entry
points every version has.

Every line carries the card's nvidia-smi name and power limit. It exits
non-zero without a card.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
HBM = 3.35e12
K9_TILE = 512
K8_CHUNK = 16384            # ops/pq.py's scan chunk (index/pq._SCAN_CHUNK)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters, torch):
    """(mean ms per call by CUDA events after a warm-up call, its result)."""
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


def kernels_ms(fn, iters, torch):
    """{kernel name: device ms per call} of ``fn`` over ``iters`` calls,
    by torch.profiler (empty if it saw no device time)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    got = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
        if us > 0:
            got[ev.key] = us / 1e3 / iters
    return got


def show(by_kernel):
    if not by_kernel:
        return "not measured"
    return ", ".join(f"{name[:48]} {ms:.4f}"
                     for name, ms in sorted(by_kernel.items(),
                                            key=lambda kv: -kv[1]))


def k8(args, torch, cuk, card, where) -> None:
    """K8 at the scan chunk (module docstring)."""
    import torch.nn.functional as F
    from vectordb_tpu_torch.ops import pq as pq_ops
    dev = torch.device("cuda")
    rows, m, ksub, dsub = K8_CHUNK, 96, 256, 8
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    codes = torch.randint(0, ksub, (rows, m), generator=gen, device=dev,
                          dtype=torch.uint8)
    cb = torch.randn((m, ksub, dsub), generator=gen,
                     device=dev).to(torch.bfloat16)
    want = pq_ops._decode_rows_plain(codes, cb).view(torch.int16)

    def grid_stride():
        out = torch.empty((rows, m * dsub), dtype=torch.bfloat16, device=dev)
        cuk._raise_on(cuk._lib().vdb_pq_decode(
            codes.data_ptr(), cb.data_ptr(), out.data_ptr(), rows, m, ksub,
            dsub, cuk._stream(dev)), "pq_decode (grid_stride)")
        return out

    flat_cb = cb.reshape(m * ksub, dsub)
    emb_idx = codes.long() + torch.arange(m, device=dev) * ksub
    calls = {"grid_stride": grid_stride,
             "route": lambda: cuk.pq_decode(codes, cb),
             "F.embedding": lambda: F.embedding(emb_idx, flat_cb)}
    body = (cuk.decode_body(codes, cb)
            if hasattr(cuk, "decode_body") else "grid_stride")
    iters = max(args.iters, 200)
    call, kern = {}, {}
    for name in ("grid_stride", "route", "F.embedding", "route",
                 "grid_stride", "F.embedding"):
        t, out = cuda_ms(calls[name], iters, torch)
        if not torch.equal(out.reshape(rows, -1).view(torch.int16), want):
            sys.exit(f"K8 {name} differs from the plain decode")
        call.setdefault(name, []).append(round(t, 4))
        by = kernels_ms(calls[name], iters, torch)
        kern.setdefault(name, []).append(show(by))
    nbytes = rows * m + m * ksub * dsub * 2 + rows * m * dsub * 2
    bnd = nbytes / HBM * 1e3
    # the output's bytes alone, written by PyTorch's fill kernel
    buf = torch.empty((rows, m * dsub), dtype=torch.bfloat16, device=dev)
    fill_ms = [round(cuda_ms(lambda: buf.fill_(0), iters, torch)[0], 4),
               show(kernels_ms(lambda: buf.fill_(0), iters, torch))]
    del buf
    print(f"K8 rows={rows} m={m} ksub={ksub} dsub={dsub} (package at "
          f"{where}, route {body}): call ms over {iters}: {call}; bound "
          f"{bnd:.4f} ms (bytes); a fill of the output's bytes: call, "
          f"kernels {fill_ms}  [{card}]", flush=True)
    for name, ks in kern.items():
        print(f"K8 kernels of the {name} call, device ms per call over "
              f"{iters} (torch.profiler): {ks}  [{card}]", flush=True)

    def host_us(fn, n=500):
        """Host microseconds a call of ``fn`` over ``n`` calls (fewer
        than the launch queue holds, so no call waits on the device)."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        us = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
        return round(us, 2)

    on = codes.device
    host = {"torch.cuda.current_stream": host_us(
                lambda: torch.cuda.current_stream(on).cuda_stream),
            "K8's stream lookup": host_us(lambda: getattr(
                cuk, "_raw_stream", cuk._stream)(on)),
            "torch.empty": host_us(lambda: torch.empty(
                (rows, m * dsub), dtype=torch.bfloat16, device=on)),
            "route call": host_us(calls["route"]),
            "grid_stride call": host_us(grid_stride)}
    print(f"K8 host time of a call, us (perf_counter over 500): {host}  "
          f"[{card}]", flush=True)
    # each body followed by the scan's two score GEMMs, as one chunk of
    # pq_scan_topr runs them
    q = torch.randn((args.queries, m * dsub), generator=gen, device=dev)
    q_hi, q_lo = pq_ops._split_query(q)
    chunk = {name: (lambda f=calls[name]: pq_ops._score_dots(q_hi, q_lo,
                                                             f()))
             for name in ("grid_stride", "route")}
    per = {}
    for name in ("grid_stride", "route", "route", "grid_stride"):
        t, _ = cuda_ms(chunk[name], 20, torch)
        per.setdefault(name, []).append(round(t, 4))
    print(f"K8 + score GEMMs per chunk (Q={args.queries}), ms over 20: "
          f"{per}  [{card}]", flush=True)
    for name in ("grid_stride", "route"):
        print(f"K8 + score GEMMs, kernels of the {name} chunk, device ms "
              f"per chunk over 20 (torch.profiler): "
              f"{show(kernels_ms(chunk[name], 20, torch))}  [{card}]",
              flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=1 << 20)
    ap.add_argument("--queries", type=int, default=4096)
    ap.add_argument("--dim", type=int, default=768)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernels", default="K1,K4,K7,K5,K3,K6,K2")
    ap.add_argument("--root", default=ROOT)
    args = ap.parse_args()
    kernels = set(args.kernels.split(","))

    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    sys.path.insert(0, os.path.abspath(args.root))
    from vectordb_tpu_torch.ops import coarse_kernel as ck
    from vectordb_tpu_torch.ops import cuda_kernels as cuk
    from vectordb_tpu_torch.ops import flat_kernel as fk

    card = card_line()
    dev = torch.device("cuda")
    where = os.path.relpath(os.path.abspath(args.root), ROOT) or "."
    if "K8" in kernels:
        k8(args, torch, cuk, card, where)
        if kernels == {"K8"}:
            return
    n, d = args.rows, args.dim
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    db = torch.randn((n, d), generator=gen, device=dev)
    valid = torch.rand((n,), generator=gen, device=dev) >= 0.1
    queries = torch.randn((args.queries, d), generator=gen, device=dev)

    def timed(fn, iters=args.iters):
        return cuda_ms(fn, iters, torch)

    def mma_sync_call(src, qThi, qTlo, qrow, arr, arr_lo, sc, col, inv, q,
                      m, passes, sup):
        """The mma.sync body through its C entry point (every version of
        the package has it), whatever the route would pick."""
        tile = torch.empty((m // 16, q), device=dev)
        sups = torch.empty((m // 256, q), device=dev) if sup else None
        ptr = lambda t: t.data_ptr() if t is not None else None  # noqa
        rc = cuk._lib().vdb_coarse_minima(
            qThi.data_ptr(), ptr(qTlo if passes == 3 else None),
            qrow.data_ptr(), arr.data_ptr(), ptr(arr_lo), ptr(sc),
            col.data_ptr(), inv.data_ptr(), tile.data_ptr(), ptr(sups), m, d,
            q, 0, cuk._COARSE_SRC[src][0], passes, int(sup),
            cuk._stream(dev))
        cuk._raise_on(rc, "coarse_minima (mma_sync)")
        return tile, sups

    if "K9" in kernels:
        nq = min(args.queries, 1024)
        qs = queries[:nq].contiguous()
        qsq, sq = (qs * qs).sum(1), (db * db).sum(1)
        inv = 1.0 - valid.float()
        ms, got = timed(lambda: cuk.scan_min(qs, qsq, db, sq, inv,
                                             "euclidean", K9_TILE))
        ms_p, want = timed(lambda: fk._tile_minima_plain(
            qs, qsq, db, sq, inv, "euclidean", K9_TILE))
        ms_l, _ = timed(lambda: qs @ db.T)
        live = want < 1e29
        err = float((got - want).abs()[live].max())
        flops = 2.0 * nq * n * d
        nbytes = (n * d * 4 + nq * d * 4 + 3 * n * 4 + nq * 4
                  + nq * (n // K9_TILE) * 4)
        bnd = max(flops / PEAK_F32, nbytes / HBM) * 1e3
        print(f"K9 N={n} Q={nq} d={d} tile {K9_TILE} (package at {where}): "
              f"{ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s); plain "
              f"{ms_p:.3f} ms; f32 matmul {ms_l:.3f} ms; bound {bnd:.3f} ms; "
              f"max |kernel - plain| {err:.3e}  [{card}]", flush=True)
        del got, want

    coarse = kernels - {"K8", "K9"}
    if not coarse:
        return
    # int8 storage of the same rows: pow2 row scales, codes within +-127
    scales = torch.exp2(torch.ceil(torch.log2(
        db.abs().amax(1).clamp_min(1e-30) / 127.0)))
    codes = torch.round(db / scales[:, None]).clamp(-127, 127).to(torch.int8)
    hi, lo = ck.split_hi_lo(db)

    def terms(rows, q, m):
        sq = (rows * rows).sum(1)
        qThi, qlo, _, _, qrow, col, inv = ck._query_terms(
            queries[:q], sq, torch.sqrt(sq), valid[:m], "euclidean")
        return qThi, qlo.to(torch.bfloat16), qrow, col, inv

    if "K2" in coarse:
        q = args.queries
        qThi, _, qrow, col, inv = terms(db, q, n)
        tile_tq, sup_tq = cuk.coarse_minima_1p_sup(qThi, qrow, hi, col, inv,
                                                   "euclidean")
        mp2, mp = ck._exact1p_pool(10, n // 16)
        tidx, _ = ck._select_tiles_1p(tile_tq, sup_tq, q, n // 16, mp2, mp)
        del tile_tq, sup_tq
        distinct = int(torch.unique(tidx).numel())
        iters = max(args.iters, 10)
        for name, rows, sc in (("f32", db, None), ("bf16", hi, None),
                               ("int8", codes, scales)):
            ms, got = timed(lambda: cuk.refine_dots(tidx, queries, rows, mp,
                                                    sc), iters)
            want = ck._refine_dots_plain(tidx, queries, rows, mp, sc)
            err = float((got - want).abs().max())
            body = (cuk.refine_body(rows, queries)
                    if hasattr(cuk, "refine_body") else "query_major")
            nbytes = (distinct * 16 * d * rows.element_size()
                      + (distinct * 16 * 4 if sc is not None else 0)
                      + q * d * 4 + q * mp * 8 + q * mp * 16 * 4)
            bnd = max(2.0 * q * mp * 16 * d / PEAK_F32, nbytes / HBM) * 1e3
            split = show(kernels_ms(lambda: cuk.refine_dots(
                tidx, queries, rows, mp, sc), iters, torch))
            print(f"K2 {name} N={n} Q={q} m={mp} d={d} (package at {where}"
                  f", body {body}): {ms:.3f} ms over {iters}; bound "
                  f"{bnd:.3f} ms; {q * mp / distinct:.3f} pairs per distinct "
                  f"tile; max |kernel - plain| {err:.3e}; kernels of the "
                  f"call, device ms (torch.profiler): {split}  [{card}]",
                  flush=True)
            del got, want
        del tidx, qThi, qrow, col, inv

    if "K6" in coarse:
        q, m = args.queries, 256
        qThi, _, qrow, col, inv = terms(db[:m], q, m)
        hi6 = hi[:m]
        iters = max(args.iters, 50)
        calls = {
            "wgmma": lambda: cuk.coarse_minima_1p(qThi, qrow, hi6, col, inv,
                                                  "euclidean"),
            "mma_sync": lambda: mma_sync_call(
                "mirrors", qThi, None, qrow, hi6, None, None, col, inv, q, m,
                1, False)[0],
            "bf16 matmul": lambda: torch.matmul(hi6, qThi)}
        ms, outs = {}, {}
        for name in ("mma_sync", "wgmma", "bf16 matmul", "wgmma",
                     "mma_sync", "bf16 matmul"):
            t, outs[name] = timed(calls[name], iters)
            ms.setdefault(name, []).append(round(t, 4))
        diff = float((outs["wgmma"] - outs["mma_sync"]).abs()[
            outs["mma_sync"] < 1e29].max())
        bnd = max(2.0 * m * q * d / PEAK_BF16,
                  (m * d * 2 + d * q * 2 + q * 4 + m * 8 + (m // 16) * q * 4)
                  / HBM) * 1e3
        route = cuk.coarse_body("mirrors", hi6, 1, False)
        print(f"K6 N={m} Q={q} d={d} (package at {where}, route {route}): "
              f"call ms over {iters}: {ms}; bound {bnd:.4f} ms; max |wgmma "
              f"call - mma_sync| {diff:.3e}  [{card}]", flush=True)
        for name, fn in calls.items():
            by = kernels_ms(fn, iters, torch)
            print(f"K6 kernels of the {name} call, device ms per call over "
                  f"{iters} (torch.profiler): {show(by)}  [{card}]",
                  flush=True)
        del outs, qThi, qrow, col, inv

    # (name, src, rows read, lo mirror, scales, passes, rows of the terms,
    # queries, row count)
    cases = []
    if "K1" in coarse:
        cases.append(("K1", "mirrors", hi, None, None, 1, db, args.queries,
                      n))
    if "K4" in coarse:
        cases.append(("K4", "f32", db, None, None, 1, db, args.queries, n))
    if "K7" in coarse:
        cases.append(("K7", "int8", codes, None, scales.reshape(1, -1), 1,
                      codes.float() * scales[:, None], args.queries, n))
    if "K5" in coarse:
        cases += [("K5 3-pass", "f32", db, None, None, 3, db, q, n)
                  for q in (256, 65)]
    if "K3" in coarse:
        cases += [("K3 3-pass", "mirrors", hi[:m], lo[:m], None, 3, db[:m],
                   q, m) for q, m in ((65, n), (256, n),
                                      (1024, min(n, 32768)))]
    for name, src, arr, arr_lo, sc, passes, rows, q, m in cases:
        qThi, qTlo, qrow, col, inv = terms(rows, q, m)
        del rows
        sup = passes == 1

        def mma_sync():
            return mma_sync_call(src, qThi, qTlo, qrow, arr, arr_lo, sc, col,
                                 inv, q, m, passes, sup)

        def wgmma():
            if src == "mirrors" and passes == 3:
                return cuk.coarse_minima(qThi, qTlo, qrow, arr, arr_lo, col,
                                         inv, 3, "euclidean"), None
            if src == "mirrors":
                return cuk.coarse_minima_1p_sup(qThi, qrow, arr, col, inv,
                                                "euclidean")
            if src == "int8":
                return cuk.coarse_minima_int8_1p_sup(qThi, qrow, arr, sc,
                                                     col, inv, "euclidean")
            if passes == 1:
                return cuk.coarse_minima_f32_1p_sup(qThi, qrow, arr, col,
                                                    inv, "euclidean")
            return cuk.coarse_minima_f32(qThi, qTlo, qrow, arr, col, inv, 3,
                                         "euclidean"), None

        if cuk.coarse_body(src, arr, passes, sup, arr_lo) != "wgmma":
            sys.exit(f"{name}: this shape does not route to wgmma")
        if passes == 3:
            h3, l3 = ((arr, arr_lo) if arr_lo is not None
                      else ck.split_hi_lo(arr))
            a16 = torch.cat([h3, l3, h3], dim=1)
            b16 = torch.cat([qThi, qThi, qTlo], dim=0)
            del h3, l3
        else:
            a16 = arr if arr.dtype == torch.bfloat16 else arr.to(
                torch.bfloat16)
            b16 = qThi
        lib_ms, _ = timed(lambda: torch.matmul(a16, b16))
        del a16, b16
        ms = {"mma_sync": [], "wgmma": []}
        outs = {}
        for body in ("mma_sync", "wgmma", "wgmma", "mma_sync"):
            t, outs[body] = timed(mma_sync if body == "mma_sync" else wgmma)
            ms[body].append(t)
        ref = outs["mma_sync"]
        diff = float((outs["wgmma"][0] - ref[0]).abs()[ref[0] < 1e29].max())
        if sup:
            diff = max(diff, float((outs["wgmma"][1] - ref[1]).abs()
                                   [ref[1] < 1e29].max()))
        flops = 2.0 * m * q * d * passes
        src_bytes = m * d * arr.element_size() * (1 if arr_lo is None else 2)
        nbytes = (src_bytes + d * q * 2 * (passes // 2 + 1)
                  + m * 4 * (3 if sc is not None else 2) + (m // 16) * q * 4
                  + ((m // 256) * q * 4 if sup else 0))
        bnd = max(flops / PEAK_BF16, nbytes / HBM) * 1e3
        say = ", ".join(
            f"{b} {[round(t, 3) for t in ts]} ms "
            f"({flops / min(ts) / 1e9:.1f} TFLOP/s)" for b, ts in ms.items())
        print(f"{name} N={m} Q={q} d={d}: {say}; bf16 matmul {lib_ms:.3f} "
              f"ms; bound {bnd:.3f} ms; max |wgmma - "
              f"mma_sync| {diff:.3e}  [{card}]", flush=True)
        del outs, ref


if __name__ == "__main__":
    main()
