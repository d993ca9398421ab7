#!/usr/bin/env python3
"""Time the two coarse bodies of K1, K4, K7, K5 and K3 side by side on one
card, and K9 against its plain version.

    python3 tools/coarse_bodies.py [--rows N] [--queries Q] [--dim D]
                                   [--iters I] [--seed S]
                                   [--kernels K1,K4,K7,K5,K3,K9]
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

K9 (``--kernels K9``): the euclidean per-tile minima of 512-row tiles of
the f32 rows for the first min(Q, 1024) queries through
``cuda_kernels.scan_min``, timed beside its plain version, one f32
torch.matmul of the same product and its bound (the flops at the 67
TFLOP/s f32 rate), with its largest difference from the plain version.
``--root`` imports vectordb_tpu_torch from another checkout (a parent
commit unpacked with ``git archive``), so two versions of K9 are timed by
running this script once per root, in turns, in one call.

Every line carries the card's nvidia-smi name and power limit. It exits
non-zero without a card.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
HBM = 3.35e12
K9_TILE = 512


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=1 << 20)
    ap.add_argument("--queries", type=int, default=4096)
    ap.add_argument("--dim", type=int, default=768)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernels", default="K1,K4,K7,K5,K3")
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
    n, d = args.rows, args.dim
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    db = torch.randn((n, d), generator=gen, device=dev)
    valid = torch.rand((n,), generator=gen, device=dev) >= 0.1
    queries = torch.randn((args.queries, d), generator=gen, device=dev)

    def timed(fn):
        out = fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / args.iters, out

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
        print(f"K9 N={n} Q={nq} d={d} tile {K9_TILE} (package at "
              f"{os.path.relpath(os.path.abspath(args.root), ROOT) or '.'}): "
              f"{ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s); plain "
              f"{ms_p:.3f} ms; f32 matmul {ms_l:.3f} ms; bound {bnd:.3f} ms; "
              f"max |kernel - plain| {err:.3e}  [{card}]", flush=True)
        del got, want

    coarse = kernels - {"K9"}
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
        code = cuk._COARSE_SRC[src][0]

        def mma_sync():
            tile = torch.empty((m // 16, q), device=dev)
            sups = torch.empty((m // 256, q), device=dev) if sup else None
            ptr = lambda t: t.data_ptr() if t is not None else None  # noqa
            rc = cuk._lib().vdb_coarse_minima(
                qThi.data_ptr(), ptr(qTlo if passes == 3 else None),
                qrow.data_ptr(), arr.data_ptr(), ptr(arr_lo), ptr(sc),
                col.data_ptr(), inv.data_ptr(), tile.data_ptr(), ptr(sups),
                m, d, q, 0, code, passes, int(sup), cuk._stream(dev))
            cuk._raise_on(rc, "coarse_minima (mma_sync)")
            return tile, sups

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
