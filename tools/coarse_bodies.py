#!/usr/bin/env python3
"""Time the two coarse bodies of K1 and K4 side by side on one CUDA card.

    python3 tools/coarse_bodies.py [--rows N] [--queries Q] [--dim D]
                                   [--iters I] [--seed S]

Seeded N(0,1) rows (N x D, f32 and their bf16 mirror) and Q queries, 10%
of the rows dead. For K1 (bf16 mirror) and K4 (f32 rows) it runs the
"wgmma" body (csrc/coarse_wgmma.cu, the route the wrappers take at this
shape) and the "mma_sync" body (csrc/coarse_minima.cu, called through its
C entry point directly), in turns (mma_sync, wgmma, wgmma, mma_sync),
each timed by CUDA events over I launches after a warm-up, and prints
each time beside its TFLOP/s (2 N Q D flops), one bf16 torch.matmul of
the same GEMM shape and the tensor-core bound (989 TFLOP/s), and the
largest difference between the two bodies' tile and super minima over
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
    n, q, d = args.rows, args.queries, args.dim
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    db = torch.randn((n, d), generator=gen, device=dev)
    valid = torch.rand((n,), generator=gen, device=dev) >= 0.1
    queries = torch.randn((q, d), generator=gen, device=dev)
    sq = (db * db).sum(1)
    qThi, _, _, _, qrow, col, inv = ck._query_terms(
        queries, sq, torch.sqrt(sq), valid, "euclidean")
    hi = db.to(torch.bfloat16)

    def mma_sync(src, arr):
        code = cuk._COARSE_SRC[src][0]
        tile = torch.empty((n // 16, q), device=dev)
        sup = torch.empty((n // 256, q), device=dev)
        rc = cuk._lib().vdb_coarse_minima(
            qThi.data_ptr(), None, qrow.data_ptr(), arr.data_ptr(), None,
            None, col.data_ptr(), inv.data_ptr(), tile.data_ptr(),
            sup.data_ptr(), n, d, q, 0, code, 1, 1, cuk._stream(dev))
        cuk._raise_on(rc, "coarse_minima (mma_sync)")
        return tile, sup

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

    flops = 2.0 * n * q * d
    lib_ms, _ = timed(lambda: torch.matmul(hi, qThi))
    for name, src, arr, launch in (
            ("K1", "mirrors", hi, cuk.coarse_minima_1p_sup),
            ("K4", "f32", db, cuk.coarse_minima_f32_1p_sup)):
        if cuk.coarse_body(src, arr, 1, True) != "wgmma":
            sys.exit(f"{name}: this shape does not route to wgmma")
        ms = {"mma_sync": [], "wgmma": []}
        outs = {}
        for body in ("mma_sync", "wgmma", "wgmma", "mma_sync"):
            fn = ((lambda: launch(qThi, qrow, arr, col, inv, "euclidean"))
                  if body == "wgmma" else (lambda: mma_sync(src, arr)))
            t, outs[body] = timed(fn)
            ms[body].append(t)
        live = outs["mma_sync"][0] < 1e29
        diff = max(float((outs["wgmma"][0] - outs["mma_sync"][0])
                         .abs()[live].max()),
                   float((outs["wgmma"][1] - outs["mma_sync"][1]).abs()
                         [outs["mma_sync"][1] < 1e29].max()))
        say = ", ".join(
            f"{b} {[round(t, 3) for t in ts]} ms "
            f"({flops / min(ts) / 1e9:.1f} TFLOP/s)" for b, ts in ms.items())
        print(f"{name} N={n} Q={q} d={d}: {say}; bf16 matmul {lib_ms:.3f} "
              f"ms; bound {flops / PEAK_BF16 * 1e3:.3f} ms; max |wgmma - "
              f"mma_sync| {diff:.3e}  [{card}]", flush=True)
        del outs


if __name__ == "__main__":
    main()
