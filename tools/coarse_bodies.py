#!/usr/bin/env python3
"""Time the two coarse bodies of K1, K4, K7 and K5 side by side on one card.

    python3 tools/coarse_bodies.py [--rows N] [--queries Q] [--dim D]
                                   [--iters I] [--seed S]

Seeded N(0,1) rows (N x D: f32, their bf16 mirror, and int8 codes with
pow2 row scales of the same rows) and Q queries, 10% of the rows dead. For
K1 (bf16 mirror, Q queries), K4 (f32 rows, Q), K7 (int8 codes, Q) and K5
at 3 passes (f32 rows, 256 and 65 queries: the forced fallback's and the
tier-2 re-run's shapes) it
runs the "wgmma" body (csrc/coarse_wgmma.cu, the route the wrappers take
at these shapes) and the "mma_sync" body (csrc/coarse_minima.cu, called
through its C entry point directly), in turns (mma_sync, wgmma, wgmma,
mma_sync), each timed by CUDA events over I launches after a warm-up, and
prints each time beside its TFLOP/s (2 N Q D flops per pass), one bf16
torch.matmul of the same GEMM shape ((N, 3D) x (3D, Q) for 3 passes) and
the bound (the larger of the flops at 989 TFLOP/s and the bytes -- rows,
queries, per-row terms and minima, each once -- at 3.35 TB/s), and the
largest difference between the two bodies' tile (and super) minima over
live tiles. Every line carries the card's nvidia-smi name and power
limit. It exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PEAK_BF16 = 989e12
HBM = 3.35e12


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
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    sys.path.insert(0, ROOT)
    from vectordb_tpu_torch.ops import coarse_kernel as ck
    from vectordb_tpu_torch.ops import cuda_kernels as cuk

    card = card_line()
    dev = torch.device("cuda")
    n, d = args.rows, args.dim
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    db = torch.randn((n, d), generator=gen, device=dev)
    valid = torch.rand((n,), generator=gen, device=dev) >= 0.1
    queries = torch.randn((args.queries, d), generator=gen, device=dev)
    # int8 storage of the same rows: pow2 row scales, codes within +-127
    scales = torch.exp2(torch.ceil(torch.log2(
        db.abs().amax(1).clamp_min(1e-30) / 127.0)))
    codes = torch.round(db / scales[:, None]).clamp(-127, 127).to(torch.int8)

    def terms(rows, q):
        sq = (rows * rows).sum(1)
        qThi, qlo, _, _, qrow, col, inv = ck._query_terms(
            queries[:q], sq, torch.sqrt(sq), valid, "euclidean")
        return qThi, qlo.to(torch.bfloat16), qrow, col, inv

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

    cases = [
        ("K1", "mirrors", db.to(torch.bfloat16), None, 1, db, args.queries),
        ("K4", "f32", db, None, 1, db, args.queries),
        ("K7", "int8", codes, scales.reshape(1, -1), 1,
         codes.float() * scales[:, None], args.queries)]
    cases += [("K5 3-pass", "f32", db, None, 3, db, q) for q in (256, 65)]
    for name, src, arr, sc, passes, rows, q in cases:
        qThi, qTlo, qrow, col, inv = terms(rows, q)
        del rows
        sup = passes == 1
        code = cuk._COARSE_SRC[src][0]

        def mma_sync():
            tile = torch.empty((n // 16, q), device=dev)
            sups = torch.empty((n // 256, q), device=dev) if sup else None
            ptr = lambda t: t.data_ptr() if t is not None else None  # noqa
            rc = cuk._lib().vdb_coarse_minima(
                qThi.data_ptr(), ptr(qTlo if passes == 3 else None),
                qrow.data_ptr(), arr.data_ptr(), None, ptr(sc),
                col.data_ptr(), inv.data_ptr(), tile.data_ptr(), ptr(sups),
                n, d, q, 0, code, passes, int(sup), cuk._stream(dev))
            cuk._raise_on(rc, "coarse_minima (mma_sync)")
            return tile, sups

        def wgmma():
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

        if cuk.coarse_body(src, arr, passes, sup) != "wgmma":
            sys.exit(f"{name}: this shape does not route to wgmma")
        if passes == 3:
            hi, lo = ck.split_hi_lo(arr)
            a16 = torch.cat([hi, lo, hi], dim=1)
            b16 = torch.cat([qThi, qThi, qTlo], dim=0)
            del hi, lo
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
        flops = 2.0 * n * q * d * passes
        nbytes = (n * d * arr.element_size() + d * q * 2 * (passes // 2 + 1)
                  + n * 4 * (3 if sc is not None else 2) + (n // 16) * q * 4
                  + ((n // 256) * q * 4 if sup else 0))
        bnd = max(flops / PEAK_BF16, nbytes / HBM) * 1e3
        say = ", ".join(
            f"{b} {[round(t, 3) for t in ts]} ms "
            f"({flops / min(ts) / 1e9:.1f} TFLOP/s)" for b, ts in ms.items())
        print(f"{name} N={n} Q={q} d={d}: {say}; bf16 matmul {lib_ms:.3f} "
              f"ms; bound {bnd:.3f} ms; max |wgmma - "
              f"mma_sync| {diff:.3e}  [{card}]", flush=True)
        del outs, ref


if __name__ == "__main__":
    main()
