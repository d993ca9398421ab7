#!/usr/bin/env python3
"""Drive the PyTorch port's paths once on one CUDA card.

    python3 chip_smoke.py [--rows N] [--queries Q] [--seed S]

Phases (each prints one line or a few; any failure exits non-zero,
nothing is caught and passed over):
  1. card (nvidia-smi name and power limit), versions, kernel build time;
  2. each hand-written kernel (K1-K7, K2 over f32, bf16 and int8 rows)
     against its plain PyTorch version on the same CUDA tensors (d=768,
     N=2^16, Q=256, all three metrics, 10% dead rows), max error beside
     its limit (see ``limits``), and a control per kernel that must break
     the limit; then the accumulation reading of both coarse bodies: raw
     dots read through K1, K6, K7 (integer codes, unit scales), K5 at 3
     passes and K3 at 3 passes (the "wgmma" body) and through K6's
     operands on the "mma_sync" body (its C entry point,
     ``cuda_kernels.coarse_minima_mma_sync``)
     with 15 of every 16 rows dead (``ck._probe_inv``), against f64 dots
     of the same bf16 operands (for K5 and K3 the sum of their three
     products), max |err| / (d 2^-24 sum|x_i q_i|) on N(0,1) data and on
     U(1, 2) data (every product positive), each held to the
     certificates' coefficient for its body; and K8 by body, bit for bit
     against the plain decode (limit 0; control: every code off by one):
     "tile_ring" and "grid_stride" at the scan chunk (16384 x 96, dsub
     8), "grid_stride" at a shape only it takes (dsub 4);
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
     Q=65, the tier-2 re-run's sizes; K6 and its bf16 matmul over 50
     launches, beside the mma.sync body's call, whose tile minima K6's
     must equal bit for bit on live tiles);
  8. PQ-Flat at full width: the intrinsic-dim-32 row set of
     benchmarks/pq_bench.py (2^20 x 768, 1024 rows deleted, Q=4096, k=10)
     into VectorStore.with_index(PqFlatIndex(EUCLIDEAN, device="cuda"))
     (m=96, ksub=256, OPQ), trained, searched at refine 64 and 32 and over
     HTTP; every returned distance equal to the on-card f32 distance of
     its id, recall@10 >= 0.95 against an on-card f32 oracle at refine 64,
     the scan's pool with K8 identical to the pool with the plain decode,
     the pool's scores within PQ_SCORE_LIMIT of their f64 recomputation
     (controls: a bf16-output score GEMM, a dropped q_lo term), the
     "mirror" and "host" re-rank venues in agreement; K8 at the scan
     chunk on both bodies, beside its plain version and F.embedding, in
     turns: the call by CUDA events and its kernel by torch.profiler over
     200 launches each, and each body followed by the scan's two score
     GEMMs (over 20); every K8 launch of the store's searches must take
     the "tile_ring" body;
  9. the two-phase exact scan (ops.flat_kernel.two_phase_search, K9) at
     2^20 x 768 f32, Q=1024, k=10, all three metrics, 10% dead rows,
     exact against an on-card f32 oracle; K9 against its plain version
     (control: bf16 operands), timed beside an f32 torch.matmul;
 10. durability, in a temporary data directory (its filesystem type and
     free bytes printed first; fewer than 8 GB free fails; removed at the
     end): a child process of this script (``--writer``) opens
     StorageEngine(dir, EngineConfig(index_type="flat", device="cuda")),
     loads 2^20 x 768 seeded f32 rows through insert_batch (65536 a
     batch, metadata on every 64th row), checkpoints, writes a WAL tail
     (65536 rows in one insert_batch, 1024 deletes, 15 single inserts),
     saves its exact and fast answers (Q=4096, k=10), logs one more
     insert and ends with os._exit(0). This script cuts 3 bytes off the
     WAL's last frame, reopens the directory and searches, timed by the
     host clock (the split: snapshot apply, WAL replay, the device build
     on its thread), and holds the reopened store to the child's: len,
     next_id, the torn insert and the deleted ids absent, sampled
     metadata, the stored values (sha256), exact and fast ids (but for
     ties) and distances; exact against the on-card f32 oracle over the
     stored values; K1 on "wgmma" and K2 on "tile_major"; the tier-1
     certification rate beside phase 6's. Then a checkpoint, a close and
     a second reopen that answers the same. bf16 and int8 stores go
     through the same cycle at 2^17 rows, Q=1024 (K1 / K7 + K2). A
     PQ-Flat store of 2^17 intrinsic-dim-32 rows is trained, searched,
     checkpointed (pq_state.npz) and reopened: the codebook bit-equal, no
     train, the same ids and distances, every K8 launch "tile_ring".
     ``serve --durable-dir`` on 127.0.0.1:0 (a process, on the native
     front end): 4096 rows by four batch inserts (the front end
     takes bodies up to 48 MB), POST /checkpoint, 64 inserts, a stop by
     SIGINT, and a second server on the directory answers /search/batch
     the same.
 11. serving on the card, run between phases 6 and 7 over phase 3's
     2^20 x 768 f32 store (still loaded): first one drain cycle's submit
     timed apart from its collect (Q=64 and 512; the submit behind one
     batch in flight must not wait for the card); then
     ``serve(..., backend="auto")`` on 127.0.0.1:0, which must resolve
     to the native front end, at VDB_HTTP_DEPTH 1 and 2, each under 64
     and 512 closed-loop clients (threads of 4 child processes of this
     script, ``--http-client``, keep-alive HTTP/1.1 POST /search k=10
     over raw sockets with phase 3's queries) for 3 s: requests/s, p50
     and p99 latency,
     mean requests per drained batch, and every 8th answer of a client
     held to phase 3's oracle (ids but for k-th/(k+1)-th ties, distances
     at rtol 2e-5); then through the native server one POST
     /search/batch, a filtered and a radius search, insert / get /
     delete / health / metrics; then the query batcher,
     ``serve(..., batch_window_ms=2.0, backend="python")``, under 64
     clients with the same checks. In each window every K1 launch must
     take "wgmma" and every K2 launch "tile_major";
 12. HNSW: 16384 x 768 intrinsic-dim-32 rows (phase 8's generator, its
     own seed; reduced from the 1M-row north star, the graph builds on
     the host) into three seeded graphs built at once, each on its own
     host thread: ``python -m vectordb_tpu_torch --index hnsw
     --hnsw-seed S serve`` (a child process, native front end, by POST
     /vectors/batch of 1024 rows), an in-process HnswIndex store fed the
     same batches, and a durable HNSW engine; Q=1024 through
     /search/batch at ef 50, 100 and 200: recall@10 against an on-card
     f32 oracle (>= 0.90 at ef=200), host ms per query, the served ids
     equal to the in-process index's; then the engine's checkpoint
     (hnsw_graph.npz), close and reopen: the graph imported, not
     rebuilt, and the answers equal the writer's.
 13. the HNSW device programs: 2^20 x 768 intrinsic-dim-32 rows (phase
     12's protocol, a generator of its own) into
     ``VectorStore.with_index(HnswIndex(..., bulk_build="auto",
     device="cuda"))`` by one insert_batch, which must take the device
     build (index/hnsw_build_device.py); its seconds split as
     ``VDB_TPU_BUILD_TIMING`` splits them, and the K1 ("wgmma") and K2
     ("tile_major") launches of its window; then ``search_batch_device``
     (kernel H1) for Q=1024, k=10 at ef 50, 100 and 200: the batch by CUDA
     events and by the host clock, recall@10 against an on-card f32
     oracle, held to the host traversal's recall on the same graph (no
     more than 0.02 below it); H1 timed alone beside its plain version
     and its bound (the bytes of the rows this run's hops gathered, as
     the plain version counts them), and held to it on 64 queries (the
     same slots but for k-th ties, distances at rtol 1e-5); a search
     with a slot mask passing half the slots (eligible-only, recall@10
     against the masked oracle no more than 0.05 below the unmasked
     recall at ef 200); and H1 over phase
     12's host-built 16384-row graph (recall@10 >= 0.90 at ef 200);
 14. IVF-Flat: 2^20 x 768 intrinsic-dim-32 rows (a generator of its own)
     into an f32 ``IvfFlatIndex(device="cuda")``, auto nlist (8192: the
     hierarchical assignment), trained (k-means, assignment, balance +
     repack and the device build timed apart); ``calibrate_nprobe(0.95)``
     (its exact truth: K4 "wgmma" + K2); Q=4096, k=10 at nprobe 1, 4, 8,
     16, 32: the store's batch and the index-level batch timed apart,
     recall@10 against an on-card f32 oracle, every returned distance
     equal to the f32 distance of its id (rtol / atol 2e-5), every K2
     launch "tile_major"; nprobe 1 and 8 over the native front end; bf16
     and int8 stores at 2^18 rows (reduced: the quantized refine routes,
     not scale) with their exact truth (K1 / K7 + K2); a durable
     ``index_type="ivf"`` engine at 2^17 rows (reduced) checkpointed and
     reopened: ``ivf_state.npz`` imported with no train, the writer's ids,
     distances within f32 rounding of |x|^2 (ROADMAP queue 3);
 15. IVF-PQ: 2^20 x 768 rows of benchmarks/pq_bench.py's
     clustered_intrinsic protocol (2048 N(0,1) centers, deviations 0.25 z
     @ basis in a shared 32-dim subspace; a generator of its own), 1024
     deleted, into ``IvfPqIndex(EUCLIDEAN, device="cuda")`` with its
     defaults (auto nlist 8192, m=96, ksub=256, OPQ, rerank "auto"),
     trained (k-means, assignment, repack, spill centroids, OPQ, codebook
     timed apart) and encoded; Q=4096, k=10 at refine 16, 32, 64 and 128:
     recall@10 against an on-card f32 oracle (>= 0.95 at refine 128),
     every returned distance the f32 distance of its id, every search's
     scan on the fused route (K8s, ``ops/pq.py`` ``_ivfpq_scan_fused``:
     one launch a query block, no K8); at Q=256 K8s's pool against the
     chunk loop's on the card (each query within its largest score limit
     below, but for ties), the chunk loop's pool with K8 equal to the one
     with the plain decode (and K8 bit for bit at both shapes), the
     pool's scores within PQ_SCORE_LIMIT of their f64 recomputation from
     c + r_hat (controls:
     a bf16-output c.r_hat and a dropped q_lo must break it), the
     "mirror" and "host" venues agreeing, refine 2048 taking the exact
     fallback (K4 + K2) exactly; refine 16 and 128 over the native front
     end (nprobe refused, 400); the scan and device re-rank of a batch at
     each refine and the chunk loop's steps at one chunk by CUDA events;
     K8s alone at the benchmark cell's scan (P15_CELL) beside its bound,
     the top r, the fused call (and its device operations by profiler),
     the chunk loop with K8 and with the plain decode, their pools; a
     durable ``index_type="ivfpq"`` engine at 2^17 rows (reduced: the
     reopen) checkpointed and reopened with ``ivfpq_state.npz`` imported
     (no train), its answers bit-equal to the writer's.
Launch counters are zeroed just before each path's run and read right
after it: the store searches of phases 3 and 4 (K1, K2, K3); each
storage store's searches (K4/K7 and K2 by source); each forced fallback
(K5); the legacy fast runs (K6, K5); the PQ store's searches (K8); the
two-phase searches (K9); each phase-10 reopen with its first searches (K1
or K7, and K2; K8); each phase-11 load run and route window (K1, K2);
phase 13's device build (K1, K2, K3) and its three device batches (H1);
phase 14's calibration (K4, K2), probed searches (K2) and quantized
stores' searches and truths (K1 / K7, K2); phase 15's store searches (K8s)
and its exact fallback (K4, K2); phase 16's sharded stores, its
DistributedFlatIndex batches and its PQ mesh's batch (K1, K4, K7, K2, K8;
"mesh_launches" in the kernel table). Every kernel of a path must have
launched in its window; the direct comparison calls are outside them.
Every K1, K4 and K7
launch in the windows of phase 3 and of phase 7's bf16, int8 and f32
stores, every K3 launch of phases 3-4 (the 2^20-row store's tier 2, the
20k-row store, the forced fallback), and every K5 launch in the f32
store's window (tier 2 of the queries tier 1 leaves uncertified), its
forced fallback (3 passes) and the legacy fast f32 run (1 pass), and
every K6 launch of the legacy fast mirrors run, must have taken the
"wgmma" body, every K2 launch in every window the "tile_major" body and
every K8 launch of the PQ store's searches the "tile_ring" body
(``cuda_kernels.routes``; K2 is timed over 10 launches, beside its
pairs per distinct tile and per tile read). Phase 7 prints each store's
tier-1 certification rate (and, for the f32 fallback, tier 2's) beside the
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
import urllib.error
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
REFINE_KEYS = ("refine_dots", "refine_dots_bf16", "refine_dots_int8")
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
PQ_CHUNK = 16384           # the PQ scan's chunk (index/pq._SCAN_CHUNK)
K8_LAUNCHES = 200          # K8 readings: launches a call or kernel time


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


def intrinsic_rows(rng, n, nq, np):
    """The intrinsic-dim-32 protocol of benchmarks/pq_bench.py:103-108
    (phase 8's and 12's rows), from the caller's generator: (rows, queries)
    f32, chunked so no (n, 32) temporary outlives its chunk."""
    basis = (rng.standard_normal((32, D), dtype=np.float32)
             / np.float32(np.sqrt(32)))
    rows = np.empty((n, D), np.float32)
    for r0 in range(0, n, 1 << 16):
        r1 = min(r0 + (1 << 16), n)
        rows[r0:r1] = rng.standard_normal((r1 - r0, 32),
                                          dtype=np.float32) @ basis
    qs = rng.standard_normal((nq, 32), dtype=np.float32) @ basis
    return rows, qs


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


def device_ms(fn, torch, iters=K8_LAUNCHES):
    """Device time per call of ``fn``'s kernels (their sum), by
    torch.profiler over ``iters`` calls after a warm-up; None if the
    profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
             for ev in prof.key_averages())
    return us / 1e3 / iters if us > 0 else None


def device_launches(fn, torch, iters=3):
    """Device operations (kernels, copies, fills) a call of ``fn`` issues,
    by torch.profiler over ``iters`` calls after a warm-up: (count a call,
    {name: count a call}); (None, {}) where the profiler saw no device
    event (a later profiler run in this process may see none)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    names = {ev.key[:48]: ev.count / iters for ev in prof.key_averages()
             if ev.count and getattr(ev, "self_device_time_total",
                                     getattr(ev, "self_cuda_time_total", 0))}
    return (sum(names.values()) if names else None), names


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


def refine_sharing(tidx, cuda_kernels):
    """Pairs per distinct tile of a K2 launch's tile ids, and pairs per
    tile read by the tile-major body (one read per work item)."""
    tiles, _ = cuda_kernels._refine_work(tidx)
    distinct = int((tiles[1:] != tiles[:-1]).sum()) + 1
    reads = int(cuda_kernels._refine_items(tiles).numel())
    return tidx.numel() / distinct, tidx.numel() / reads


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


def check_tile_major(window, cuda_kernels):
    """Every K2 launch counted since the last reset took the "tile_major"
    body (each K2 shape on the paths, 768-d aligned rows, is one it
    takes); returns the route counts of the sources that launched."""
    got = {k: dict(cuda_kernels.routes[k]) for k in REFINE_KEYS
           if cuda_kernels.launches[k]}
    bad = {k: v for k, v in got.items()
           if v["tile_major"] != cuda_kernels.launches[k]}
    if bad:
        fail(f"{window}: K2 launches by body {bad}: every one must take the "
             f"tile_major body")
    return got


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


def decode_bodies(rng, card, np, torch, cuda_kernels, worst):
    """Phase 2's K8 check of each body: bit for bit (limit 0) against the
    plain decode at the scan chunk (16384 x 96, dsub 8: "tile_ring" by the
    route, "grid_stride" through its own entry point) and at a shape only
    "grid_stride" takes (dsub 4); control: every code off by one."""
    from vectordb_tpu_torch.ops import pq as pq_ops
    dev = torch.device("cuda")
    e, c = {}, {}
    for name, rows, m, dsub, route in (
            ("scan chunk", PQ_CHUNK, 96, 8, "tile_ring"),
            ("dsub 4", 4096, 192, 4, "grid_stride")):
        cb = torch.from_numpy(rng.standard_normal(
            (m, 256, dsub), dtype=np.float32)).to(dev).to(torch.bfloat16)
        codes = torch.from_numpy(rng.integers(0, 256, (rows, m),
                                              dtype=np.uint8)).to(dev)
        want = pq_ops._decode_rows_plain(codes, cb)
        before = dict(cuda_kernels.routes["pq_decode"])
        runs = {route: cuda_kernels.pq_decode(codes, cb)}
        if cuda_kernels.routes["pq_decode"][route] != before[route] + 1:
            fail(f"K8 at {name} did not take the {route} body")
        runs["grid_stride"] = cuda_kernels.pq_decode_grid_stride(codes, cb)
        for body, got in runs.items():
            same = torch.equal(got.view(torch.int16), want.view(torch.int16))
            e[f"{body} at {name}"] = (float((got.float() - want.float())
                                            .abs().max()) if same else
                                      float("inf"))
        c[name] = float((pq_ops._decode_rows_plain(codes ^ 1, cb).float()
                         - want.float()).abs().max())
    torch.cuda.synchronize()
    say("phase 2 K8 by body, max |kernel - plain| (limit 0, bit for bit): "
        + "; ".join(f"{k} {v:.3e}" for k, v in e.items()) + "; controls "
        "(codes off by one) " + "; ".join(f"{k} {v:.3e}" for k, v in
                                          c.items()) + f"  [{card}]")
    if any(v != 0.0 for v in e.values()):
        fail(f"a K8 body differs from the plain decode: {e}")
    if not all(v > 0.0 for v in c.values()):
        fail(f"a K8 control passed the limit: {c}")
    worst["pq_decode"] = max(worst.get("pq_decode", 0.0), max(e.values()))


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
                ("K6", "mirrors", hi, 1, False, None),
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
        # K6's operands on the mma.sync body, through its C entry point
        t6m, _ = cuda_kernels.coarse_minima_mma_sync(
            "mirrors", qThi, None, qrow, hi, None, None, col, inv, "dot", 1,
            False)
        torch.cuda.synchronize()
        read[("K1", "wgmma", data)] = ck._accum_reading(t1, hi.float(), qThi,
                                                        live)
        read[("K7", "wgmma", data)] = ck._accum_reading(t7, codes.float(),
                                                        qThi, live)
        read[("K5 3-pass", "wgmma", data)] = ck._accum_reading(
            t5, hi.float(), qThi, live, lo.float(), qTlo)
        read[("K3 3-pass", "wgmma", data)] = ck._accum_reading(
            t3, hi.float(), qThi, live, lo.float(), qTlo)
        read[("K6", "wgmma", data)] = ck._accum_reading(t6, hi.float(),
                                                        qThi, live)
        read[("K6", "mma_sync", data)] = ck._accum_reading(t6m, hi.float(),
                                                           qThi, live)
        del xt, hi, lo, qThi, qTlo, codes, t1, t7, t5, t3, t6, t6m
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
    bodies.update(check_tile_major(f"phase 7 {kind}", cuda_kernels))
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
    check_tile_major(f"phase 7 {kind} forced fallback", cuda_kernels)
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
        tidx, queries, db, mp, scales), torch, iters=10)
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
    out["refine_body"] = cuda_kernels.refine_body(db, queries)
    out["refine_share"] = refine_sharing(tidx, cuda_kernels)
    say(f"phase 7 {kind} times [{card}]: {coarse_key} N={n} Q={nq} "
        f"{ms_c:.3f} ms ({2.0 * n * nq * D / ms_c / 1e9:.1f} TFLOP/s, body "
        f"{out['body']}; plain {ms_cp:.3f}, "
        f"bf16 matmul {lib_c:.3f}, bound "
        f"{out['coarse'][3][0]:.3f}), max err {e_c:.3e} (limit {lim:.3e}); "
        f"{refine_key} Q={nq} m={mp} {ms_r:.3f} ms (body "
        f"{out['refine_body']}; plain {ms_rp:.3f}, bound "
        f"{out['refine'][2][0]:.3f}; {out['refine_share'][0]:.3f} pairs per "
        f"distinct tile, {out['refine_share'][1]:.3f} per tile read), max "
        f"err {e_r:.3e} (limit {lim2:.3e})")
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
        check_wgmma(f"phase 7 legacy fast {name}", key, cuda_kernels)
        check_tile_major(f"phase 7 legacy fast {name}", cuda_kernels)
        check_exact(f"legacy fast {name}", li[:, :K], ld[:, :K], o_d2, o_i,
                    K, np)
    sThi, _, _, _, sqrow, scol, sinv = ck._query_terms(
        queries, small["sq_norms"], small["norms"], small["valid"], mode)
    # K6 is one ~0.08 ms launch: 50 launches a reading, the wrapper's call
    # (its K-major query copy included) on each body, beside the matmul
    ms6, k6 = cuda_time(lambda: cuda_kernels.coarse_minima_1p(
        sThi, sqrow, mir["hi"], scol, sinv, mode), torch, iters=50)
    ms6m, (k6m, _) = cuda_time(lambda: cuda_kernels.coarse_minima_mma_sync(
        "mirrors", sThi, None, sqrow, mir["hi"], None, None, scol, sinv,
        mode, 1, False), torch, iters=50)
    ms6p, k6p = cuda_time(lambda: ck._coarse_minima_1p_plain(
        sThi, sqrow, mir["hi"], scol, sinv, mode), torch)
    e6 = live_err(k6.T, k6p)
    d6 = live_err(k6, k6m)
    if d6 != 0.0:
        fail(f"K6 on wgmma differs from the mma.sync body by {d6:.3e}")
    lib6, _ = cuda_time(lambda: torch.matmul(mir["hi"], sThi), torch,
                        iters=50)
    b6 = coarse_bound(256, D, queries.shape[0], 1, 256 * D * 2, False)
    body6 = cuda_kernels.coarse_body("mirrors", mir["hi"], 1, False)
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
        f"{k5_line}; K6 N=256 Q={queries.shape[0]}, body {body6}: "
        f"{ms6:.4f} ms a call over 50 (mma_sync body {ms6m:.4f}, max "
        f"|wgmma - mma_sync| {d6:.1e}; plain {ms6p:.3f}, bf16 matmul "
        f"{lib6:.4f} over 50, bound {b6[0]:.4f}), max err {e6:.3e}")
    return {"k5": k5[256][:4], "k5_body": k5_body,
            "k6": (ms6, ms6p, lib6, b6), "k6_body": body6,
            "k6_mma_sync_ms": ms6m, "legacy": legacy}


def http_call(port, method, path, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data, method=method,
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:          # 4xx / 5xx: their body
        return e.code, json.loads(e.read() or b"null")


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
    rows, qs = intrinsic_rows(rng, n, nq, np)
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
    k8_routes = dict(cuda_kernels.routes["pq_decode"])
    say(f"phase 8 launch counts (the PQ store's searches): "
        f"{ {k: v for k, v in counts.items() if v} }; K8 by body "
        f"{k8_routes}")
    if counts["pq_decode"] < 1:
        fail(f"the PQ store's searches launched no K8: {counts}")
    if k8_routes["tile_ring"] != counts["pq_decode"]:
        fail(f"K8 launches by body {k8_routes}: every one of the PQ "
             f"store's must take the tile_ring body")

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
        cols = index._collect_device_rerank(qs, [(dv_h, ds_h, sv, sl, nq)],
                                            K, index._tick,
                                            index.slot_layout_version, None)
        mapped = store._map_columns(cols, [K] * nq)
        t3 = time.perf_counter()
        if [r.id for r in mapped[0]] != [r.id for r in results[64][0]]:
            fail("the split batch disagrees with the store's batch")
        splits.append(((t1 - t0) * 1e3, (t2 - t1) * 1e3, (t3 - t2) * 1e3))

    # K8 at the scan chunk, and the scan's other per-chunk steps
    cb_bf = state["codebook"]
    ksub, dsub = cb_bf.shape[1], cb_bf.shape[2]
    # (each body, the plain decode and F.embedding: the call by CUDA events
    # and its kernels by torch.profiler over K8_LAUNCHES, in turns)
    cc = state["codes"][:chunk]
    flat_cb = cb_bf.reshape(m * ksub, dsub)
    emb_idx = cc.long() + torch.arange(m, device=dev) * ksub
    calls = {"tile_ring": lambda: cuda_kernels.pq_decode(cc, cb_bf),
             "grid_stride": lambda: cuda_kernels.pq_decode_grid_stride(
                 cc, cb_bf),
             "plain": lambda: pq_ops._decode_rows_plain(cc, cb_bf),
             "F.embedding": lambda: F.embedding(emb_idx, flat_cb)}
    call_ms, kern_ms, outs = {}, {}, {}
    for name in ("grid_stride", "tile_ring", "plain", "F.embedding",
                 "tile_ring", "grid_stride"):
        t, outs[name] = cuda_time(calls[name], torch, iters=K8_LAUNCHES)
        call_ms.setdefault(name, []).append(t)
        kern_ms.setdefault(name, []).append(device_ms(calls[name], torch))
    dec_p = outs["plain"].view(torch.int16)
    if not all(torch.equal(o.reshape(chunk, -1).view(torch.int16), dec_p)
               for o in outs.values()):
        fail("a K8 body (or F.embedding) differs from the plain decode at "
             "the scan chunk")
    dec_k = outs["tile_ring"]
    if cuda_kernels.decode_body(cc, cb_bf) != "tile_ring":
        fail("K8 at the scan chunk does not route to tile_ring")
    b8 = bound(0.0, chunk * m + m * ksub * dsub * 2 + chunk * D * 2,
               PEAK_BF16)
    q_hi, q_lo = pq_ops._split_query(pq_ops._maybe_rotate(queries, rot))
    ms_gemm, scores = cuda_time(lambda: pq_ops._score_dots(q_hi, q_lo,
                                                           dec_k), torch)
    # K8 followed by the scan's two score GEMMs, as each chunk runs them
    with_gemms = {}
    for name in ("grid_stride", "tile_ring", "tile_ring", "grid_stride"):
        t, _ = cuda_time(lambda f=calls[name]: pq_ops._score_dots(
            q_hi, q_lo, f()), torch, iters=20)
        with_gemms.setdefault(name, []).append(t)
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
        f"rows, {nc} chunks): score GEMMs bf16->f32 {ms_gemm:.3f} ms "
        f"({4.0 * nq * chunk * D / ms_gemm / 1e9:.1f} TFLOP/s), top-64 "
        f"{ms_topk:.3f} ms")

    def r4(by_name):
        return {k: [None if t is None else round(t, 4) for t in v]
                for k, v in by_name.items()}

    say(f"phase 8 K8 at the scan chunk, in turns, ms per launch over "
        f"{K8_LAUNCHES}: call (CUDA events) {r4(call_ms)}; kernels "
        f"(torch.profiler) {r4(kern_ms)}; bound {b8[0]:.4f} ({b8[1]}); "
        f"K8 + the two score GEMMs per chunk, over 20: {r4(with_gemms)}  "
        f"[{card}]")
    def mean(ts):
        return sum(ts) / len(ts)

    # ms is the call, as in every row; kernel_ms is the kernel alone, None
    # where the profiler saw no device time
    kernel = [t for t in kern_ms["tile_ring"] if t is not None]
    out = {"launches": counts["pq_decode"],
           "trained": index.export_trained_state(),
           "ms": mean(call_ms["tile_ring"]),
           "kernel_ms": mean(kernel) if kernel else None,
           "plain_ms": mean(call_ms["plain"]), "bound": b8,
           "library_ms": mean(call_ms["F.embedding"])}
    del store, index, state, rr_rows, db_t, queries, scores, dec_k, dec_p
    del outs, sv, sl, dv, ds, sv_k, sl_k, sv_p, sl_p, results, res_m, res_h
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


# ---------------------------------------------------------------------------
# phase 10: durability on the card
# ---------------------------------------------------------------------------

P10_SMALL = 1 << 17        # the bf16, int8 and PQ stores' rows (reduced)
P10_TAIL = 65536           # WAL tail: one insert_batch of this many rows
P10_DELETES = 1024
P10_SINGLES = 15
P10_META_EVERY = 64
P10_MIN_FREE = 8 * 10 ** 9
P10_HTTP_ROWS = 4096
P10_HTTP_SINGLES = 64
P10_SMALL_QUERIES = 1024


def p10_config(kind):
    """The engine's config for a phase-10 store ("f32", "bf16", "int8" or
    "pq"); the checkpoint interval is above every count the phase writes,
    so only its explicit checkpoints run."""
    from vectordb_tpu_torch.persistence import EngineConfig
    if kind == "pq":
        return EngineConfig(index_type="pq", device="cuda",
                            checkpoint_interval=10 ** 9)
    return EngineConfig(index_type="flat", storage=kind, device="cuda",
                        checkpoint_interval=10 ** 9)


def stored_digest(store, np):
    """sha256 of the internal ids and stored values (f32 bits) of the live
    rows in internal-id order, read from the host rows chunk by chunk."""
    import hashlib
    index = store.index
    with index._lock:
        live = np.nonzero(index._valid)[0]
        ids = index._id_of_slot[live]
        order = live[np.argsort(ids, kind="stable")]
        h = hashlib.sha256(np.sort(ids).tobytes())
        for a in range(0, order.size, 1 << 16):
            rows = index._stored(index._vectors[order[a:a + (1 << 16)]])
            h.update(np.ascontiguousarray(rows, np.float32).tobytes())
    return h.hexdigest()


def writer_main(args) -> None:
    """The phase-10 writer, a child process of this script on the card:
    open a durable store, load seeded rows through ``insert_batch`` (65536
    a batch, metadata on every 64th row), checkpoint, write a WAL tail (one
    batch of P10_TAIL rows, P10_DELETES deletes, P10_SINGLES single
    inserts), search exact and fast and save the answers into the
    directory, write one more single insert and end with ``os._exit(0)``:
    no close, no checkpoint."""
    import numpy as np
    from vectordb_tpu_torch import BatchInsertItem, Metadata, Vector
    from vectordb_tpu_torch.persistence import StorageEngine
    d, n, kind = args.writer, args.rows, args.storage
    rng = np.random.default_rng([args.seed, 10, n])
    torn = n + P10_TAIL + P10_SINGLES
    rows = make_rows(rng, torn + 1, D, np)
    out = {}
    t0 = time.perf_counter()
    eng = StorageEngine.open(d, p10_config(kind))
    out["open_s"] = time.perf_counter() - t0

    def items(lo, hi):
        return [BatchInsertItem(
            str(i), Vector(rows[i]),
            Metadata({"m": str(i)}) if i % P10_META_EVERY == 0
            else Metadata()) for i in range(lo, hi)]

    t0 = time.perf_counter()
    for r0 in range(0, n, 1 << 16):
        eng.insert_batch(items(r0, min(r0 + (1 << 16), n)))
    out["load_s"] = time.perf_counter() - t0
    out["wal_bytes_loaded"] = os.path.getsize(os.path.join(d, "wal.log"))
    t0 = time.perf_counter()
    eng.checkpoint()
    out["checkpoint_s"] = time.perf_counter() - t0
    out["snapshot_bytes"] = os.path.getsize(os.path.join(d, "snapshot.bin"))
    t0 = time.perf_counter()
    eng.insert_batch(items(n, n + P10_TAIL))
    dead = rng.choice(n, P10_DELETES, replace=False)
    for i in dead:
        eng.delete(str(int(i)))
    for i in range(n + P10_TAIL, torn):
        eng.insert(str(i), Vector(rows[i]))
    out["tail_s"] = time.perf_counter() - t0
    qs = rng.standard_normal((args.queries, D), dtype=np.float32)
    np.save(os.path.join(d, "queries.npy"), qs)
    batch = [(Vector(q), K) for q in qs]
    t0 = time.perf_counter()
    res = eng.search_batch(batch)
    out["first_search_s"] = time.perf_counter() - t0
    eng.store.index.search_mode = "fast"
    res_fast = eng.search_batch(batch)
    eng.store.index.search_mode = "exact"
    for name, r in (("exact", res), ("fast", res_fast)):
        ids, dists = store_ids(r, np)
        np.save(os.path.join(d, f"{name}_ids.npy"), ids)
        np.save(os.path.join(d, f"{name}_dists.npy"), dists)
    out.update(len=len(eng), next_id=eng.store.next_internal_id,
               dead=[int(i) for i in dead], torn=str(torn),
               digest=stored_digest(eng.store, np))
    with open(os.path.join(d, "expect.json"), "w") as f:
        json.dump(out, f)
    eng.insert(str(torn), Vector(rows[torn]))     # logged, then the crash
    sys.stdout.flush()
    os._exit(0)


def fs_info(path):
    """(filesystem type from /proc/mounts, mount point) of ``path``."""
    path = os.path.realpath(path)
    best = ("?", "/")
    with open("/proc/mounts") as f:
        for line in f:
            parts = line.split()
            mnt = parts[1].replace("\\040", " ")
            if (path == mnt or path.startswith(mnt.rstrip("/") + "/")) \
                    and len(mnt) >= len(best[1]):
                best = (parts[2], mnt)
    return best


def same_answers(name, ids, dists, want_ids, want_d, ora_d, ora_i, np):
    """Ids equal ``want_ids`` except at the oracle's k-th / (k+1)-th ties
    (or a swap of two tied ids); returns (ties, max |dists - want_d|)."""
    tol = 2e-5 * np.abs(ora_d) + 2e-5
    ties = 0
    for qi in range(ids.shape[0]):
        if np.array_equal(ids[qi], want_ids[qi]):
            continue
        boundary = ora_d[qi, K] - ora_d[qi, K - 1] <= tol[qi, K]
        swap = set(ids[qi]) == set(want_ids[qi])
        if not (boundary or swap):
            fail(f"{name}: query {qi} ids {ids[qi].tolist()} != before "
                 f"{want_ids[qi].tolist()}")
        ties += 1
    return ties, float(np.abs(dists - want_d).max())


def crash_cycle(kind, n, nq, base, args, card, mods):
    """Phase 10's write / crash / torn tail / reopen cycle of one flat
    store (module docstring). Returns its numbers."""
    np, torch, ck = mods["np"], mods["torch"], mods["ck"]
    cuda_kernels, Vector = mods["cuda_kernels"], mods["Vector"]
    from vectordb_tpu_torch.persistence import StorageEngine
    d = os.path.join(base, kind)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--writer", d,
         "--storage", kind, "--rows", str(n), "--queries", str(nq),
         "--seed", str(args.seed)], capture_output=True, text=True,
        timeout=900)
    writer_s = time.perf_counter() - t0
    if proc.returncode != 0 or not os.path.exists(
            os.path.join(d, "expect.json")):
        fail(f"phase 10 {kind} writer exited {proc.returncode}: "
             f"{(proc.stdout + proc.stderr)[-3000:]}")
    with open(os.path.join(d, "expect.json")) as f:
        want = json.load(f)
    wal = os.path.join(d, "wal.log")
    wal_bytes = os.path.getsize(wal)
    os.truncate(wal, wal_bytes - 3)           # a torn last frame
    qs = np.load(os.path.join(d, "queries.npy"))
    batch = [(Vector(q), K) for q in qs]
    coarse = ("coarse_minima_int8_1p_sup" if kind == "int8"
              else "coarse_minima_1p_sup")
    refine = {"f32": "refine_dots", "bf16": "refine_dots_bf16",
              "int8": "refine_dots_int8"}[kind]

    # the path's run: reopen, hydration and the first searches
    cuda_kernels.reset_launches()
    t0 = time.perf_counter()
    eng = StorageEngine.open(d, p10_config(kind))
    open_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = eng.search_batch(batch)
    first_s = time.perf_counter() - t0
    eng.store.index.search_mode = "fast"
    res_fast = eng.search_batch(batch)
    eng.store.index.search_mode = "exact"
    counts = dict(cuda_kernels.launches)
    bodies = check_wgmma(f"phase 10 {kind} reopen", coarse, cuda_kernels)
    bodies.update(check_tile_major(f"phase 10 {kind} reopen", cuda_kernels))
    if counts[coarse] < 1 or counts[refine] < 1:
        fail(f"phase 10 {kind}: the reopened store's searches launched "
             f"{coarse} {counts[coarse]}, {refine} {counts[refine]} times")
    marks = dict(eng.recovery_marks)
    if len(eng) != want["len"] or \
            eng.store.next_internal_id != want["next_id"]:
        fail(f"phase 10 {kind}: reopened len {len(eng)} next_id "
             f"{eng.store.next_internal_id}, before the crash {want['len']} "
             f"{want['next_id']}")
    if eng.get(want["torn"]) is not None:
        fail(f"phase 10 {kind}: the torn insert {want['torn']} is present")
    if any(eng.get(str(i)) is not None for i in want["dead"]):
        fail(f"phase 10 {kind}: a deleted id is present")
    dead = set(want["dead"])
    sample = [i for i in range(0, n, P10_META_EVERY) if i not in dead]
    sample = sample[::max(1, len(sample) // 512)]
    for i in sample:
        meta = eng.get_metadata(str(i))
        if meta is None or meta.fields() != {"m": str(i)}:
            fail(f"phase 10 {kind}: metadata of {i} reads {meta}")
    plain = next(i for i in range(1, P10_META_EVERY) if i not in dead)
    if eng.get_metadata(str(plain)).fields():
        fail(f"phase 10 {kind}: row {plain} has metadata")
    digest = stored_digest(eng.store, np)
    if digest != want["digest"]:
        fail(f"phase 10 {kind}: the stored values differ from before the "
             f"crash")
    index = eng.store.index
    with index._lock:
        state = dict(index._sync_device())
    queries = torch.from_numpy(qs).to("cuda")
    vals = state["db"].float()
    if kind == "int8":
        vals = vals * state["scales"][:, None]
    ora_d2, ora_i = oracle_sq(queries, vals, state["sq_norms"],
                              state["valid"], K, torch)
    del vals
    # the oracle ranks slots: single inserts of the tail took the slots of
    # deleted rows, so map slots to the rows' ids
    with index._lock:
        iid_of_slot = index._id_of_slot.copy()
    sid = eng.store.internal_to_string_ids()
    id_of_slot = np.array([int(sid[i]) if i >= 0 else -1
                           for i in iid_of_slot.tolist()])
    ora_i = id_of_slot[ora_i]
    ora_d = np.sqrt(np.maximum(ora_d2, 0.0))
    ids, dists = store_ids(res, np)
    oties, oerr = check_exact(f"phase 10 {kind} reopen", ids, dists, ora_d2,
                              ora_i, K, np)
    ties, derr = same_answers(
        f"phase 10 {kind} exact", ids, dists,
        np.load(os.path.join(d, "exact_ids.npy")),
        np.load(os.path.join(d, "exact_dists.npy")), ora_d, ora_i, np)
    fids, fd = store_ids(res_fast, np)
    fties, ferr = same_answers(
        f"phase 10 {kind} fast", fids, fd,
        np.load(os.path.join(d, "fast_ids.npy")),
        np.load(os.path.join(d, "fast_dists.npy")), ora_d, ora_i, np)
    rate = None
    if kind == "f32":
        rate = float(ck.coarse_search_1p(
            queries, state["db"], state["sq_norms"], state["norms"],
            state["valid"], state["hi"], state["elo_max"],
            mods["DistanceMetric"].EUCLIDEAN, K)[2].float().mean())
    del state, queries
    # checkpoint the recovered state, close, and reopen a second time
    t0 = time.perf_counter()
    eng.checkpoint()
    ckpt_s = time.perf_counter() - t0
    eng.close()
    del eng, index
    free(torch)
    t0 = time.perf_counter()
    eng = StorageEngine.open(d, p10_config(kind))
    open2_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res2 = eng.search_batch(batch)
    first2_s = time.perf_counter() - t0
    ids2, dists2 = store_ids(res2, np)
    if not (np.array_equal(ids2, ids) and np.array_equal(dists2, dists)):
        fail(f"phase 10 {kind}: the second reopen answers differently "
             f"(max dist diff {float(np.abs(dists2 - dists).max()):.3e})")
    eng.close()
    del eng, res, res_fast, res2
    free(torch)
    return {"kind": kind, "n": n, "nq": nq, "writer_s": writer_s,
            "want": want, "wal_bytes": wal_bytes, "open_s": open_s,
            "first_s": first_s, "marks": marks, "counts": counts,
            "bodies": bodies, "coarse": coarse, "refine": refine,
            "ties": ties, "oracle_ties": oties, "oracle_err": oerr,
            "dist_diff": derr, "fast_ties": fties, "fast_diff": ferr,
            "rate": rate, "checkpoint_s": ckpt_s, "open2_s": open2_s,
            "first2_s": first2_s, "meta_checked": len(sample)}


def pq_reopen(base, args, card, mods):
    """Phase 10's PQ-Flat store: trained once, checkpointed, reopened
    without training; the same codebook, answers and tile_ring K8."""
    np, torch = mods["np"], mods["torch"]
    cuda_kernels, Vector = mods["cuda_kernels"], mods["Vector"]
    from vectordb_tpu_torch import BatchInsertItem
    from vectordb_tpu_torch.index.pq import PqFlatIndex
    from vectordb_tpu_torch.persistence import StorageEngine
    d = os.path.join(base, "pq")
    rng = np.random.default_rng([args.seed, 11])
    n, nq = P10_SMALL, P10_SMALL_QUERIES
    rows, qs = intrinsic_rows(rng, n, nq, np)
    batch = [(Vector(q), K) for q in qs]
    eng = StorageEngine.open(d, p10_config("pq"))
    t0 = time.perf_counter()
    for r0 in range(0, n, 1 << 16):
        eng.insert_batch([BatchInsertItem(str(i), Vector(rows[i]))
                          for i in range(r0, min(r0 + (1 << 16), n))])
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng.store.index.train()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    ids0, d0 = store_ids(eng.search_batch(batch), np)
    cb0 = eng.store.index._codebook.copy()
    t0 = time.perf_counter()
    eng.checkpoint()
    ckpt_s = time.perf_counter() - t0
    eng.close()
    del eng
    free(torch)
    if not os.path.exists(os.path.join(d, "pq_state.npz")):
        fail("phase 10 pq: the checkpoint wrote no pq_state.npz")
    trains = []
    real_train = PqFlatIndex.train

    def counted(self):
        trains.append(1)
        return real_train(self)

    PqFlatIndex.train = counted
    try:
        # the path's run: reopen and the first search
        cuda_kernels.reset_launches()
        t0 = time.perf_counter()
        eng = StorageEngine.open(d, p10_config("pq"))
        open_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ids, dists = store_ids(eng.search_batch(batch), np)
        first_s = time.perf_counter() - t0
    finally:
        PqFlatIndex.train = real_train
    k8 = cuda_kernels.launches["pq_decode"]
    routes = dict(cuda_kernels.routes["pq_decode"])
    if trains or not eng.store.index.is_trained:
        fail(f"phase 10 pq: the reopen trained {len(trains)} times")
    if not np.array_equal(eng.store.index._codebook.view(np.uint32),
                          cb0.view(np.uint32)):
        fail("phase 10 pq: the reopened codebook differs")
    if k8 < 1 or routes["tile_ring"] != k8:
        fail(f"phase 10 pq: K8 launches {k8}, by body {routes}: every one "
             f"must take tile_ring")
    if not (np.array_equal(ids, ids0) and np.array_equal(dists, d0)):
        fail(f"phase 10 pq: the reopened store answers differently "
             f"({int((ids != ids0).any(1).sum())} queries' ids, max dist "
             f"diff {float(np.abs(dists - d0).max()):.3e})")
    eng.close()
    del eng
    free(torch)
    return {"n": n, "nq": nq, "load_s": load_s, "train_s": train_s,
            "checkpoint_s": ckpt_s, "open_s": open_s, "first_s": first_s,
            "k8": k8, "routes": routes}


def durable_http(base, rows, np):
    """Phase 10's durable HTTP server: ``serve --durable-dir`` (the CLI's
    entry point to ``start_durable``) on 127.0.0.1:0 as its own process:
    a batch insert, a checkpoint, single inserts, a batch search; a stop
    by SIGINT; a second process on the same directory answers the same."""
    import select
    import signal
    d = os.path.join(base, "http")
    env = dict(os.environ, PYTHONPATH=ROOT)
    queries = {"queries": [{"vector": rows[P10_HTTP_ROWS + 100 + j].tolist(),
                            "k": K} for j in range(16)]}

    def start():
        proc = subprocess.Popen(
            [sys.executable, "-m", "vectordb_tpu_torch", "serve",
             "--durable-dir", d, "--addr", "127.0.0.1:0"], cwd=ROOT,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        ready, _, _ = select.select([proc.stdout], [], [], 300)
        line = proc.stdout.readline() if ready else ""
        if "listening on" not in line:
            proc.kill()
            proc.wait()
            fail(f"phase 10 http: the server did not start: {line}"
                 f"{proc.stdout.read()[-2000:]}")
        return proc, int(line.strip().rsplit(":", 1)[1])

    def stop(proc):
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            proc.stdout.close()
        return proc.returncode

    t0 = time.perf_counter()
    proc, port = start()
    try:
        # four POSTs of 1024 rows: the native front end (the default of
        # "auto") takes bodies up to 48 MB (httpcore.cpp kMaxBody)
        st0 = max(http_call(port, "POST", "/vectors/batch", {"vectors": [
            {"id": f"h{i}", "vector": rows[i].tolist()}
            for i in range(r0, r0 + 1024)]})[0]
            for r0 in range(0, P10_HTTP_ROWS, 1024))
        st1, ck = http_call(port, "POST", "/checkpoint")
        singles = [http_call(port, "POST", "/vectors", {
            "id": f"h{i}", "vector": rows[i].tolist()})[0]
            for i in range(P10_HTTP_ROWS, P10_HTTP_ROWS + P10_HTTP_SINGLES)]
        st2, before = http_call(port, "POST", "/search/batch", queries)
        st3, health = http_call(port, "GET", "/health")
    finally:
        rc0 = stop(proc)
    proc, port = start()
    try:
        st4, after = http_call(port, "POST", "/search/batch", queries)
        st5, health2 = http_call(port, "GET", "/health")
    finally:
        rc1 = stop(proc)
    total_s = time.perf_counter() - t0
    if (st0, st1, st2, st3, st4, st5) != (201, 200, 200, 200, 200, 200) \
            or set(singles) != {201}:
        fail(f"phase 10 http statuses {(st0, st1, st2, st3, st4, st5)}, "
             f"singles {set(singles)}")
    n_rows = P10_HTTP_ROWS + P10_HTTP_SINGLES
    if ck["vector_count"] != P10_HTTP_ROWS or \
            health["vector_count"] != n_rows or \
            health2["vector_count"] != n_rows:
        fail(f"phase 10 http counts: checkpoint {ck}, health {health}, "
             f"after the reopen {health2}")
    ids = [[h["id"] for h in row] for row in before]
    if [[h["id"] for h in row] for row in after] != ids:
        fail("phase 10 http: /search/batch ids differ after the reopen")
    d0 = np.array([[h["distance"] for h in row] for row in before])
    d1 = np.array([[h["distance"] for h in row] for row in after])
    if not np.allclose(d1, d0, rtol=2e-5, atol=2e-5):
        fail(f"phase 10 http: distances moved by up to "
             f"{float(np.abs(d1 - d0).max()):.3e} after the reopen")
    return {"total_s": total_s, "rcs": (rc0, rc1), "rows": n_rows,
            "dist_diff": float(np.abs(d1 - d0).max())}


def say_cycle(r, card, fs, rate3):
    """Phase 10's lines for one crash cycle (crash_cycle's numbers)."""
    m, w = r["marks"], r["want"]
    say(f"phase 10 {r['kind']} store N={r['n']} x {D} (+{P10_TAIL} "
        f"WAL-tail rows, {P10_DELETES} deletes, {P10_SINGLES} single "
        f"inserts; metadata on every {P10_META_EVERY}th row) Q={r['nq']} "
        f"k={K} [{card}; {fs}]: writer process {r['writer_s']:.3f} s "
        f"(load through the WAL {w['load_s']:.3f} s, "
        f"{w['wal_bytes_loaded']} WAL bytes; checkpoint "
        f"{w['checkpoint_s']:.3f} s, {w['snapshot_bytes']} snapshot "
        f"bytes; tail {w['tail_s']:.3f} s; first search "
        f"{w['first_search_s']:.3f} s); torn tail: 3 bytes cut off "
        f"{r['wal_bytes']} WAL bytes; reopen {r['open_s']:.3f} s "
        f"(snapshot apply {m['snapshot applied']:.3f} s, WAL replay "
        f"{m['wal replayed'] - m['snapshot applied']:.3f} s, hydration "
        f"build {m.get('hydration build', 0.0):.3f} s on its thread, "
        f"joined {m['hydration joined'] - m['wal replayed']:.3f} s after "
        f"the replay); first search {r['first_s']:.3f} s; time to "
        f"recover {r['open_s'] + r['first_s']:.3f} s")
    say(f"phase 10 {r['kind']} checks: len {w['len']} and next_id "
        f"{w['next_id']} as before the crash; the torn insert and the "
        f"{P10_DELETES} deleted ids absent; {r['meta_checked']} sampled "
        f"metadata read back; stored values bit-equal (sha256 "
        f"{w['digest'][:16]}); exact ids as before ({r['ties']} ties), "
        f"max |dist - before| {r['dist_diff']:.3e}; fast ids as before "
        f"({r['fast_ties']} ties), max |dist - before| "
        f"{r['fast_diff']:.3e}; exact against the on-card f32 oracle "
        f"over the stored values ({r['oracle_ties']} ties, max err "
        f"{r['oracle_err']:.3e}); launch counts (reopen + searches) "
        f"{r['coarse']} {r['counts'][r['coarse']]}, {r['refine']} "
        f"{r['counts'][r['refine']]}, by body {r['bodies']}"
        + (f"; tier-1 certification rate {r['rate']:.6f} (phase 6: "
           f"{rate3:.6f})" if r["rate"] is not None else "")
        + f"; after a checkpoint ({r['checkpoint_s']:.3f} s) and close, "
        f"a second reopen {r['open2_s']:.3f} s + first search "
        f"{r['first2_s']:.3f} s answers the same")


def durability_phase(args, rows, card, mods, rate3):
    """Phase 10 (module docstring). Returns the launch counts of its
    windows by kernel key."""
    import shutil
    import tempfile
    base = tempfile.mkdtemp(prefix="vdb_phase10_")
    fs, mnt = fs_info(base)
    free_b = shutil.disk_usage(base).free
    say(f"phase 10 data directory {base}: filesystem {fs} (mounted at "
        f"{mnt}), {free_b} bytes free")
    try:
        if free_b < P10_MIN_FREE:
            fail(f"phase 10 needs {P10_MIN_FREE} free bytes for its data "
                 f"directory; {base} has {free_b}")
        cycles = []
        for kind in ("f32", "bf16", "int8"):
            n, nq = ((args.rows, args.queries) if kind == "f32"
                     else (P10_SMALL, P10_SMALL_QUERIES))
            cycles.append(crash_cycle(kind, n, nq, base, args, card, mods))
            say_cycle(cycles[-1], card, fs, rate3)
        pq = pq_reopen(base, args, card, mods)
        say(f"phase 10 pq store N={pq['n']} x {D} intrinsic-dim-32 rows "
            f"(reduced from phase 8's 2^20) Q={pq['nq']} k={K} [{card}; "
            f"{fs}]: load {pq['load_s']:.3f} s, train {pq['train_s']:.3f} "
            f"s, checkpoint {pq['checkpoint_s']:.3f} s (pq_state.npz); "
            f"reopen {pq['open_s']:.3f} s with no train, codebook "
            f"bit-equal; first search {pq['first_s']:.3f} s, ids and "
            f"distances as before; K8 launches {pq['k8']} by body "
            f"{pq['routes']}")
        http = durable_http(base, rows, mods["np"])
    finally:
        shutil.rmtree(base, ignore_errors=True)
    say(f"phase 10 http: serve --durable-dir on 127.0.0.1:0, POST "
        f"/vectors/batch {P10_HTTP_ROWS} rows in 4, POST /checkpoint, "
        f"{P10_HTTP_SINGLES} POST /vectors, stop (exit {http['rcs'][0]}), "
        f"a second server on the directory: /health {http['rows']}, the "
        f"same /search/batch ids, max |dist - before| "
        f"{http['dist_diff']:.3e} (exit {http['rcs'][1]}); "
        f"{http['total_s']:.3f} s")
    counts: dict = {}
    for r in cycles:
        for key in (r["coarse"], r["refine"]):
            counts[key] = counts.get(key, 0) + r["counts"][key]
    counts["pq_decode"] = pq["k8"]
    return counts


# ---------------------------------------------------------------------------
# phase 11: serving on the card; phase 12: HNSW
# ---------------------------------------------------------------------------

P11_SECONDS = 3.0          # each closed-loop load run
P11_CLIENT_PROCS = 4       # client processes; the clients are their threads
P11_SAMPLE_EVERY = 8       # every 8th answer of a client is held to the oracle
P11_SUBMIT_ROUNDS = 5
P12_ROWS = 16384           # reduced from the 1M-row north star (host build)
P12_QUERIES = 1024
P12_CHUNK = 1024           # rows per POST /vectors/batch
P12_EFS = (50, 100, 200)
P12_RECALL_MIN = 0.90      # at ef=200


def client_main(args) -> None:
    """A load-generating child of this script (phase 11): ``threads``
    closed-loop clients, each on its own keep-alive HTTP/1.1 connection
    (a raw socket and prebuilt request bytes, so that the clients' own
    Python is light), POST /search k=K with the queries of an .npy file
    from a start time until a deadline; writes its latencies and sampled
    answers as JSON. Imports no torch: the card is the server's."""
    import socket
    import threading

    import numpy as np
    spec = json.loads(args.http_client)
    qs = np.load(spec["queries"])
    reqs = []
    for q in qs:
        body = json.dumps({"vector": q.tolist(), "k": K}).encode()
        reqs.append(b"POST /search HTTP/1.1\r\nHost: 127.0.0.1\r\n"
                    b"Content-Type: application/json\r\nContent-Length: "
                    + str(len(body)).encode() + b"\r\n\r\n" + body)
    lats, samples, errors = [], [], []
    lock = threading.Lock()

    def response(sock, buf):
        """(status, body, rest of buf) of the next response."""
        while b"\r\n\r\n" not in buf:
            chunk = sock.recv(65536)
            if not chunk:
                raise ConnectionError("closed by the server")
            buf += chunk
        head, _, buf = buf.partition(b"\r\n\r\n")
        lines = head.split(b"\r\n")
        status = int(lines[0].split()[1])
        length = next(int(v) for k, _, v in (ln.partition(b":")
                                             for ln in lines[1:])
                      if k.strip().lower() == b"content-length")
        while len(buf) < length:
            chunk = sock.recv(65536)
            if not chunk:
                raise ConnectionError("closed by the server")
            buf += chunk
        return status, buf[:length], buf[length:]

    def run(tid):
        sock = socket.create_connection(("127.0.0.1", spec["port"]),
                                        timeout=120)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        my_lat, my_samples, n, buf = [], [], 0, b""
        qi = (spec["offset"] + tid * 37) % len(reqs)
        while time.time() < spec["start"]:
            time.sleep(0.001)
        try:
            while True:
                t0 = time.perf_counter()
                if t0 > spec["deadline"]:
                    break
                sock.sendall(reqs[qi])
                status, data, buf = response(sock, buf)
                my_lat.append((time.perf_counter() - t0) * 1e3)
                if status != 200:
                    raise RuntimeError(f"status {status}: {data[:200]}")
                if n % P11_SAMPLE_EVERY == 0:
                    my_samples.append([int(qi), json.loads(data)])
                n += 1
                qi = (qi + 1) % len(reqs)
        except Exception as e:  # noqa: BLE001 — reported to the parent
            with lock:
                errors.append(repr(e))
        finally:
            sock.close()
        with lock:
            lats.extend(my_lat)
            samples.extend(my_samples)

    # the deadline is on the perf_counter clock of this process
    spec["deadline"] = time.perf_counter() + (spec["start"] - time.time()) \
        + spec["seconds"]
    threads = [threading.Thread(target=run, args=(t,))
               for t in range(spec["threads"])]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    with open(spec["out"], "w") as f:
        json.dump({"lat": lats, "samples": samples, "errors": errors}, f)
    sys.exit(0)


def load_run(port, clients, qfile, tmp, offset):
    """Drive a server with ``clients`` closed-loop clients spread over
    P11_CLIENT_PROCS child processes for P11_SECONDS. Returns (requests
    per second, p50 ms, p99 ms, samples)."""
    import numpy as np
    per = [clients // P11_CLIENT_PROCS + (1 if p < clients % P11_CLIENT_PROCS
                                          else 0)
           for p in range(P11_CLIENT_PROCS)]
    start = time.time() + 3.0          # the children's imports come first
    procs = []
    for p, threads in enumerate(per):
        out = os.path.join(tmp, f"client_{clients}_{p}.json")
        spec = {"port": port, "queries": qfile, "threads": threads,
                "seconds": P11_SECONDS, "start": start, "out": out,
                "offset": offset + p * 1009}
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--http-client",
             json.dumps(spec)], cwd=ROOT), out))
    lats, samples = [], []
    for proc, out in procs:
        if proc.wait(timeout=300) != 0:
            fail(f"phase 11: a client process exited {proc.returncode}")
        with open(out) as f:
            got = json.load(f)
        if got["errors"]:
            fail(f"phase 11: client errors {got['errors'][:3]}")
        lats += got["lat"]
        samples += got["samples"]
    lat = np.array(lats)
    return (len(lats) / P11_SECONDS, float(np.percentile(lat, 50)),
            float(np.percentile(lat, 99)), samples)


def check_samples(name, samples, ora_d2, ora_i, np):
    """Served answers against the phase-3 oracle: ids but for k-th /
    (k+1)-th ties, distances at rtol 2e-5 (check_exact)."""
    qi = np.array([s[0] for s in samples])
    ids = np.array([[int(h["id"]) for h in s[1]] for s in samples])
    dists = np.array([[h["distance"] for h in s[1]] for s in samples],
                     np.float32)
    if ids.shape != (len(samples), K):
        fail(f"{name}: answers of shape {ids.shape}")
    return check_exact(name, ids, dists, ora_d2[qi], ora_i[qi], K, np)


def serve_thread(store, **kw):
    """``serve`` on 127.0.0.1:0 in a thread; returns (state, thread)."""
    import threading

    from vectordb_tpu_torch.server.app import AppState, serve
    state = AppState(store)
    ready = threading.Event()
    thread = threading.Thread(target=serve, args=("127.0.0.1:0", state),
                              kwargs={"ready_event": ready, **kw},
                              daemon=True)
    thread.start()
    if not ready.wait(120):
        fail("phase 11: the server did not start")
    return state, thread


def stop_server(state, thread):
    state.server.shutdown()
    thread.join(timeout=60)
    if thread.is_alive():
        fail("phase 11: the server thread did not stop")


def submit_timing(store, qs, Vector, torch, np):
    """One drain cycle's submit apart from its collect, at the batch
    sizes the load runs drain: the submit with the card idle, the submit
    behind one batch in flight (were it to wait for the card, it would
    take about the device time), the collect, and the device time of one
    batch (submit + synchronize)."""
    out = {}
    for nb in (64, 512):
        batch = [(Vector(q), K) for q in qs[:nb]]
        store.search_batch(batch)
        rec = {"submit_idle": [], "submit_busy": [], "collect": [],
               "device": []}
        for _ in range(P11_SUBMIT_ROUNDS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            h1 = store.search_batch_submit(batch)
            t1 = time.perf_counter()
            h2 = store.search_batch_submit(batch)
            t2 = time.perf_counter()
            h1.collect()
            t3 = time.perf_counter()
            h2.collect()
            torch.cuda.synchronize()
            t4 = time.perf_counter()
            h3 = store.search_batch_submit(batch)
            torch.cuda.synchronize()
            t5 = time.perf_counter()
            h3.collect()
            rec["submit_idle"].append((t1 - t0) * 1e3)
            rec["submit_busy"].append((t2 - t1) * 1e3)
            rec["collect"].append((t3 - t2) * 1e3)
            rec["device"].append((t5 - t4) * 1e3)
            del t4
        out[nb] = {k: float(np.median(v)) for k, v in rec.items()}
    return out


def serving_phase(store, rows, dead, qs, ora_d2, ora_i, card, mods):
    """Phase 11 (module docstring). Returns the K1 and K2 launch counts
    of the serving windows."""
    import tempfile

    from vectordb_tpu_torch.server.native_http import (DEFAULT_DEPTH,
                                                       NativeHttpServer)
    np, torch, cuda_kernels = mods["np"], mods["torch"], mods["cuda_kernels"]
    Vector = mods["Vector"]
    gone = set(int(i) for i in dead)
    live = next(i for i in range(11, rows.shape[0]) if i not in gone)
    timing = submit_timing(store, qs, Vector, torch, np)
    say("phase 11 submit vs collect, median of "
        f"{P11_SUBMIT_ROUNDS} rounds, ms [{card}]: " + "; ".join(
            f"Q={nb}: submit {t['submit_idle']:.3f} idle, "
            f"{t['submit_busy']:.3f} behind one batch in flight; collect "
            f"{t['collect']:.3f}; device (submit + synchronize) "
            f"{t['device']:.3f}" for nb, t in timing.items()))
    launches = {"coarse_minima_1p_sup": 0, "refine_dots": 0}
    runs = []
    tmp = tempfile.mkdtemp(prefix="vdb_p11_")
    qfile = os.path.join(tmp, "queries.npy")
    np.save(qfile, qs)
    old_depth = os.environ.get("VDB_HTTP_DEPTH")

    def window(name, fn):
        """Reset the counters, run, check and count the window."""
        cuda_kernels.reset_launches()
        out = fn()
        for key in launches:
            if cuda_kernels.launches[key] < 1:
                fail(f"phase 11 {name}: {key} never launched")
            launches[key] += cuda_kernels.launches[key]
        check_wgmma(f"phase 11 {name}", "coarse_minima_1p_sup",
                    cuda_kernels)
        check_tile_major(f"phase 11 {name}", cuda_kernels)
        return out

    try:
        for depth in (1, 2):
            os.environ["VDB_HTTP_DEPTH"] = str(depth)
            state, thread = serve_thread(store, backend="auto")
            try:
                if not isinstance(state.server, NativeHttpServer):
                    fail(f"phase 11: backend 'auto' served with "
                         f"{type(state.server).__name__}")
                for clients in (64, 512):
                    state.server.drain_sizes.clear()
                    rps, p50, p99, samples = window(
                        f"native depth {depth} clients {clients}",
                        lambda: load_run(state.server.port, clients, qfile,
                                         tmp, 17 * clients + depth))
                    drains = [s for s in state.server.drain_sizes]
                    ties, err = check_samples(
                        f"phase 11 native depth {depth} clients {clients}",
                        samples, ora_d2, ora_i, np)
                    runs.append(("native", depth, clients, rps, p50, p99,
                                 float(np.mean(drains)), len(samples),
                                 ties, err))
            finally:
                stop_server(state, thread)
        # the other routes through the native front end (default depth)
        if old_depth is None:
            os.environ.pop("VDB_HTTP_DEPTH", None)
        else:
            os.environ["VDB_HTTP_DEPTH"] = old_depth
        state, thread = serve_thread(store, backend="native")
        try:
            routes = window("native routes", lambda: native_routes(
                state.server.port, rows, live, qs, ora_d2, ora_i, np))
        finally:
            stop_server(state, thread)
        # the query batcher behind the stdlib server
        state, thread = serve_thread(store, backend="python",
                                     batch_window_ms=2.0)
        try:
            port = state.server.server_address[1]
            rps, p50, p99, samples = window(
                "batcher clients 64", lambda: load_run(port, 64, qfile, tmp,
                                                       5))
            ties, err = check_samples("phase 11 batcher", samples, ora_d2,
                                      ora_i, np)
            runs.append(("batcher 2 ms", 0, 64, rps, p50, p99, float("nan"),
                         len(samples), ties, err))
        finally:
            stop_server(state, thread)
    finally:
        if old_depth is None:
            os.environ.pop("VDB_HTTP_DEPTH", None)
        else:
            os.environ["VDB_HTTP_DEPTH"] = old_depth
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)
    for kind, depth, clients, rps, p50, p99, mean_drain, ns, ties, err in runs:
        say(f"phase 11 {kind}" + (f" depth {depth}" if depth else "")
            + f" clients {clients}: {rps:.1f} req/s, p50 {p50:.3f} ms, p99 "
            f"{p99:.3f} ms, mean requests per drained batch "
            + (f"{mean_drain:.2f}" if mean_drain == mean_drain else "n/a")
            + f"; {ns} sampled answers exact against the oracle ({ties} "
            f"boundary ties, max dist err {err:.3e})  [{card}]")
    say(f"phase 11 native routes: {routes}; default VDB_HTTP_DEPTH "
        f"{DEFAULT_DEPTH}; launch counts over the serving windows "
        f"{launches}, K1 all wgmma, K2 all tile_major")
    return launches


def native_routes(port, rows, live, qs, ora_d2, ora_i, np):
    """POST /search/batch (the pre-parsed batch path), a filtered and a
    radius search (around live row ``live``), and insert / get / delete /
    health / metrics through the native front end; the store is left as
    it was."""
    qi = [3, 9, 27, 81]
    st, batch = http_call(port, "POST", "/search/batch", {"queries": [
        {"vector": qs[i].tolist(), "k": K} for i in qi]})
    if st != 200:
        fail(f"phase 11 /search/batch status {st}")
    check_samples("phase 11 /search/batch", list(zip(qi, batch)), ora_d2,
                  ora_i, np)
    probe = (rows[live] + np.float32(1e-3)).tolist()
    st1, _ = http_call(port, "POST", "/vectors", {
        "id": "p11", "vector": probe, "metadata": {"tag": "served"}})
    st2, got = http_call(port, "GET", "/vectors/p11")
    st3, flt = http_call(port, "POST", "/search", {
        "vector": probe, "k": K,
        "filter": {"op": "eq", "field": "tag", "value": "served"}})
    st4, rad = http_call(port, "POST", "/search", {
        "vector": rows[live].tolist(), "radius": 0.05, "limit": 10})
    st5, _ = http_call(port, "DELETE", "/vectors/p11")
    st6, health = http_call(port, "GET", "/health")
    st7, metrics = http_call(port, "GET", "/metrics")
    if (st1, st2, st3, st4, st5, st6, st7) != (201, 200, 200, 200, 200,
                                               200, 200):
        fail(f"phase 11 route statuses {(st1, st2, st3, st4, st5, st6, st7)}")
    if got["metadata"] != {"tag": "served"} or [h["id"] for h in flt] != \
            ["p11"]:
        fail(f"phase 11 get / filtered search: {got.get('metadata')}, {flt}")
    if sorted(h["id"] for h in rad) != sorted([str(live), "p11"]):
        fail(f"phase 11 radius search: {rad}")
    return (f"/search/batch Q={len(qi)} exact; filtered search -> p11; "
            f"radius 0.05 -> {sorted(h['id'] for h in rad)}; insert/get/"
            f"delete 201/200/200; /health {health['vector_count']}; "
            f"/metrics {metrics['total_queries']} queries")


def hnsw_phase(args, card, mods):
    """Phase 12 (module docstring)."""
    import select
    import shutil
    import signal
    import tempfile
    import threading

    from vectordb_tpu_torch import HnswIndex, HnswParams
    from vectordb_tpu_torch.persistence import EngineConfig, StorageEngine
    np, torch = mods["np"], mods["torch"]
    VectorStore, Vector = mods["VectorStore"], mods["Vector"]
    BatchInsertItem = mods["BatchInsertItem"]
    E = mods["DistanceMetric"].EUCLIDEAN
    n, nq = P12_ROWS, P12_QUERIES
    # phase 8's rows, from a generator of its own
    rows, qs = intrinsic_rows(np.random.default_rng([args.seed, 12]), n, nq,
                              np)
    chunks = [(c0, min(c0 + P12_CHUNK, n)) for c0 in range(0, n, P12_CHUNK)]

    def items(c0, c1):
        return [BatchInsertItem(str(i), Vector(rows[i]))
                for i in range(c0, c1)]

    # three builds of one graph, each on its own host thread: the served
    # store (a child process, over HTTP), an in-process store and a
    # durable engine; a seeded graph builds on one thread, so all three
    # are the same graph
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-m", "vectordb_tpu_torch", "--index", "hnsw",
         "--hnsw-seed", str(args.seed), "serve", "--addr", "127.0.0.1:0"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    base = tempfile.mkdtemp(prefix="vdb_p12_")
    try:
        ready, _, _ = select.select([proc.stdout], [], [], 300)
        line = proc.stdout.readline() if ready else ""
        if "(native) listening on" not in line:
            fail(f"phase 12: the HNSW server did not start natively: {line}"
                 f"{proc.stdout.read()[-2000:] if proc.poll() else ''}")
        port = int(line.strip().rsplit(":", 1)[1])
        params = HnswParams(seed=args.seed)
        local = VectorStore.with_index(HnswIndex(E, params))
        # no auto-checkpoint mid-load: one checkpoint after it
        cfg = EngineConfig(checkpoint_interval=1 << 30, index_type="hnsw",
                           hnsw_params=params, device="cuda")
        times = {}

        def timed(name, fn):
            t0 = time.perf_counter()
            fn()
            times[name] = time.perf_counter() - t0

        def serve_build():
            for c0, c1 in chunks:
                st, _ = http_call(port, "POST", "/vectors/batch", {
                    "vectors": [{"id": str(i), "vector": rows[i].tolist()}
                                for i in range(c0, c1)]})
                if st != 201:
                    raise RuntimeError(f"POST /vectors/batch status {st}")

        def local_build():
            for c0, c1 in chunks:
                local.insert_batch(items(c0, c1))

        def durable_build():
            with StorageEngine.open(base, cfg) as eng:
                for c0, c1 in chunks:
                    eng.insert_batch(items(c0, c1))
                times["writer"] = [eng.search(Vector(q), K, ef=100)
                                   for q in qs[:64]]
                t0 = time.perf_counter()
                eng.checkpoint()
                times["checkpoint"] = time.perf_counter() - t0

        errors = []

        def run(name, fn):
            try:
                timed(name, fn)
            except BaseException as e:  # noqa: BLE001 — reported below
                errors.append((name, repr(e)))

        builders = [threading.Thread(target=run, args=(name, fn))
                    for name, fn in (("served build", serve_build),
                                     ("local build", local_build),
                                     ("durable build", durable_build))]
        for t in builders:
            t.start()
        for t in builders:
            t.join()
        if errors:
            fail(f"phase 12 builds failed: {errors}")

        # the on-card f32 oracle
        dev = torch.device("cuda")
        db = torch.from_numpy(rows).to(dev)
        q = torch.from_numpy(qs).to(dev)
        ora_d2, ora_i = oracle_sq(q, db, (db * db).sum(1),
                                  torch.ones(n, dtype=torch.bool, device=dev),
                                  K, torch)
        del db, q
        lines = []
        for ef in P12_EFS:
            t0 = time.perf_counter()
            st, served = http_call(port, "POST", "/search/batch", {
                "queries": [{"vector": qq.tolist(), "k": K} for qq in qs],
                "ef": ef})
            http_s = time.perf_counter() - t0
            if st != 200:
                fail(f"phase 12 /search/batch ef={ef} status {st}")
            t0 = time.perf_counter()
            mine = local.search_batch([(Vector(qq), K) for qq in qs], ef=ef)
            host_ms = (time.perf_counter() - t0) * 1e3 / nq
            sids = [[int(h["id"]) for h in row] for row in served]
            lids = [[int(r.id) for r in row] for row in mine]
            if sids != lids:
                bad = next(i for i in range(nq) if sids[i] != lids[i])
                fail(f"phase 12 ef={ef}: the served ids differ from the "
                     f"in-process index's at query {bad}: {sids[bad]} vs "
                     f"{lids[bad]}")
            rec = float(np.mean([len(set(s) & set(o[:K].tolist())) / K
                                 for s, o in zip(sids, ora_i)]))
            if ef == max(P12_EFS) and rec < P12_RECALL_MIN:
                fail(f"phase 12 recall@{K} {rec:.4f} at ef={ef} is below "
                     f"{P12_RECALL_MIN}")
            lines.append(f"ef={ef}: recall@{K} {rec:.4f}, host "
                         f"{host_ms:.3f} ms/query in process, "
                         f"{http_s * 1e3 / nq:.3f} ms/query over HTTP")
        # single /search requests with the knob (the front end's grouped
        # submit by (k, ef, ...)) answer as the in-process index
        for i in range(16):
            st, hits = http_call(port, "POST", "/search", {
                "vector": qs[i].tolist(), "k": K, "ef": P12_EFS[0]})
            want = [r.id for r in local.search(Vector(qs[i]), K,
                                               ef=P12_EFS[0])]
            if st != 200 or [h["id"] for h in hits] != want:
                fail(f"phase 12 /search ef={P12_EFS[0]} query {i}: {hits}")
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            proc.stdout.close()

    # the durable engine: reopen imports the checkpointed graph
    try:
        if not os.path.exists(os.path.join(base, "hnsw_graph.npz")):
            fail("phase 12: the checkpoint wrote no hnsw_graph.npz")
        rebuilt = []
        orig = StorageEngine._apply_snapshot
        StorageEngine._apply_snapshot = (
            lambda self, snap: rebuilt.append(1) or orig(self, snap))
        try:
            t0 = time.perf_counter()
            with StorageEngine.open(base, cfg) as eng:
                reopen_s = time.perf_counter() - t0
                again = [eng.search(Vector(qq), K, ef=100) for qq in qs[:64]]
                n_eng = len(eng)
        finally:
            StorageEngine._apply_snapshot = orig
        if rebuilt:
            fail("phase 12: the reopen rebuilt the graph instead of "
                 "importing it")
        if n_eng != n or again != times["writer"]:
            fail("phase 12: the reopened engine answers differently from "
                 "its writer")
        graph_mb = os.path.getsize(os.path.join(base, "hnsw_graph.npz")) / 1e6
    finally:
        shutil.rmtree(base, ignore_errors=True)
    say(f"phase 12 HNSW N={n} x {D} intrinsic-dim-32 rows (reduced from "
        f"the 1M-row north star: host build), m={params.m}, "
        f"ef_construction={params.ef_construction}, seed {args.seed}, "
        f"Q={nq} k={K} [{card}]: builds (one host thread each, "
        f"concurrent) served over HTTP {times['served build']:.3f} s, in "
        f"process {times['local build']:.3f} s, durable "
        f"{times['durable build']:.3f} s; served ids equal the in-process "
        f"index's; " + "; ".join(lines))
    say(f"phase 12 durable HNSW: checkpoint {times['checkpoint']:.3f} s "
        f"(hnsw_graph.npz {graph_mb:.1f} MB), reopen {reopen_s:.3f} s with "
        f"the graph imported (no rebuild), 64 answers equal the writer's")
    return {"store": local, "index": local.index, "qs": qs, "ora_i": ora_i}


# ---------------------------------------------------------------------------
# phase 13: the HNSW device programs; phase 14: IVF-Flat
# ---------------------------------------------------------------------------

P13_ROWS = 1 << 20
P13_QUERIES = 1024
P13_EFS = (50, 100, 200)
P13_CHECK_QUERIES = 64     # H1 held to its plain version on these
P13_HOST_GAP = 0.02        # device recall may trail the host traversal's by
P13_MASKED_GAP = 0.05      # masked recall@10 may trail the unmasked by
P14_ROWS = 1 << 20
P14_QUERIES = 4096
P14_NPROBES = (1, 4, 8, 16, 32)
P14_SMALL = 1 << 18        # the bf16 and int8 stores' rows (reduced)
P14_DURABLE = 1 << 17      # the durable engine's rows (reduced)


def recall_at(got_ids, ora_ids, np):
    return float(np.mean([len(set(g) & set(o[:K].tolist())) / K
                          for g, o in zip(got_ids, ora_ids)]))


def events_ms(fn, torch):
    """(ms by CUDA events, ms by the host clock, result) of one call that
    ends in a device-to-host copy."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    host = (time.perf_counter() - t0) * 1e3
    return start.elapsed_time(end), host, out


def hnsw_device_phase(args, card, mods, p12):
    """Phase 13 (module docstring). Returns the H1 row's numbers and the
    build's launch counts."""
    import contextlib
    import io

    from vectordb_tpu_torch import HnswIndex, HnswParams
    from vectordb_tpu_torch.index import hnsw_build_device as hbd
    from vectordb_tpu_torch.ops import hnsw_device as hd
    np, torch = mods["np"], mods["torch"]
    cuda_kernels = mods["cuda_kernels"]
    VectorStore, Vector = mods["VectorStore"], mods["Vector"]
    BatchInsertItem = mods["BatchInsertItem"]
    E = mods["DistanceMetric"].EUCLIDEAN
    n, nq = P13_ROWS, P13_QUERIES
    rows, qs = intrinsic_rows(np.random.default_rng([args.seed, 13]), n, nq,
                              np)
    params = HnswParams(seed=args.seed)
    index = HnswIndex(E, params, bulk_build="auto", device="cuda")
    store = VectorStore.with_index(index)
    items = [BatchInsertItem(str(i), Vector(rows[i])) for i in range(n)]
    took = []
    real = hbd.build_device_tables

    def spy(*a, **kw):
        took.append(kw.get("device"))
        return real(*a, **kw)

    # the build's window: only the store's insert between reset and read
    hbd.build_device_tables = spy
    os.environ["VDB_TPU_BUILD_TIMING"] = "1"
    log = io.StringIO()
    cuda_kernels.reset_launches()
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            store.insert_batch(items)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
    finally:
        hbd.build_device_tables = real
        del os.environ["VDB_TPU_BUILD_TIMING"]
    build_counts = dict(cuda_kernels.launches)
    del items
    if took != ["cuda"]:
        fail(f"phase 13: bulk_build='auto' did not take the device build "
             f"on the card ({took})")
    k1b = check_wgmma("phase 13 build", "coarse_minima_1p_sup",
                      cuda_kernels)
    k2b = check_tile_major("phase 13 build", cuda_kernels)
    if build_counts["coarse_minima_1p_sup"] < 1 or \
            build_counts["refine_dots"] < 1:
        fail(f"phase 13: the build launched no K1 or K2: {build_counts}")
    split = [ln.strip().replace("[build-timing] ", "")
             for ln in log.getvalue().splitlines() if "build-timing" in ln]
    if len(index) != n:
        fail(f"phase 13: the index holds {len(index)} rows, not {n}")

    dev = torch.device("cuda")
    db = torch.from_numpy(rows).to(dev)
    q = torch.from_numpy(qs).to(dev)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    ora_d2, ora_i = oracle_sq(q, db, (db * db).sum(1), valid, K, torch)
    # the device tables: built at the first search, timed apart
    t0 = time.perf_counter()
    searcher = index.device_searcher()
    torch.cuda.synchronize()
    tables_s = time.perf_counter() - t0
    t = searcher.tables
    targs = (t["vectors"], t["norms"], t["neighbors"], t["valid"])
    start = min(t["max_level"], params.max_layers - 1)
    id_map = store.internal_to_string_ids()
    index.search_batch_device(qs[:8], K, ef=P13_EFS[0])     # warm-up
    # the path's window: the three batches, nothing else
    cuda_kernels.reset_launches()
    path = {ef: events_ms(lambda: index.search_batch_device(qs, K, ef=ef),
                          torch) for ef in P13_EFS}
    h1_launches = cuda_kernels.launches["hnsw_search"]
    if h1_launches < len(P13_EFS):
        fail(f"phase 13: search_batch_device launched H1 {h1_launches} "
             "times")
    lines, h1, recs = [], {}, {}
    for ef in P13_EFS:
        ev, host, res = path[ef]
        got = [[int(id_map[i]) for i, _ in r] for r in res]
        rec = recs[ef] = recall_at(got, ora_i, np)
        t0 = time.perf_counter()
        hres = [index.search_with_ef(Vector(qq), K, ef) for qq in qs]
        host_ms = (time.perf_counter() - t0) * 1e3 / nq
        hrec = recall_at([[int(id_map[i]) for i, _ in r] for r in hres],
                         ora_i, np)
        if rec < hrec - P13_HOST_GAP:
            fail(f"phase 13 ef={ef}: device recall@{K} {rec:.4f} trails the "
                 f"host traversal's {hrec:.4f} by more than {P13_HOST_GAP}")
        # H1 alone at this ef, and its plain version on the same queries
        # (these launches are outside the path's window)
        ms, (kd, ks) = cuda_time(lambda: cuda_kernels.hnsw_search(
            *targs, q, t["entry"], start, "euclidean", K, ef), torch)
        stats = {}
        ms_p, _, (pd, ps) = events_ms(lambda: hd._hnsw_search_plain(
            *targs, q, t["entry"], start, "euclidean", K, ef, stats=stats),
            torch)
        h1[ef] = {"ms": ms, "plain_ms": ms_p, "rows": stats["rows"],
                  "hops": stats["hops"], "kd": kd, "ks": ks, "pd": pd,
                  "ps": ps}
        # the bytes the run's hops need: each gathered row once, the
        # adjacency rows of the expansions, the queries, the outputs
        nbytes = (stats["rows"] * D * 4 + stats["hops"] * 32 * 4
                  + nq * D * 4 + nq * K * 8)
        h1[ef]["bound"] = bound(2.0 * stats["rows"] * D, nbytes, PEAK_F32)
        lines.append(
            f"ef={ef}: batch {ev:.3f} ms by CUDA events, {host:.3f} ms by "
            f"the host clock; H1 {ms:.3f} ms (plain {ms_p:.3f}, bound "
            f"{h1[ef]['bound'][0]:.3f} by {h1[ef]['bound'][1]}: "
            f"{stats['rows']} rows gathered, {stats['hops']} hops); "
            f"recall@{K} {rec:.4f} (host traversal {hrec:.4f}, "
            f"{host_ms:.3f} ms/query)")

    # H1 against its plain version on the first 64 queries, at each ef:
    # the same slots but for k-th/(k+1)-th ties, distances at rtol 1e-5
    worst = 0.0
    ties = 0
    for ef, r in h1.items():
        c = P13_CHECK_QUERIES
        ks, ps = r["ks"][:c].cpu().numpy(), r["ps"][:c].cpu().numpy()
        kd, pd = r["kd"][:c].cpu().numpy(), r["pd"][:c].cpu().numpy()
        for qi in range(c):
            if np.array_equal(ks[qi], ps[qi]):
                continue
            if (np.array_equal(ks[qi, :K - 1], ps[qi, :K - 1])
                    and abs(kd[qi, K - 1] - pd[qi, K - 1])
                    <= 1e-5 * abs(pd[qi, K - 1])):
                ties += 1
                continue
            fail(f"phase 13 ef={ef}: H1 slots of query {qi} "
                 f"{ks[qi].tolist()} differ from the plain version's "
                 f"{ps[qi].tolist()}")
        same = ks == ps
        rel = np.abs(kd - pd)[same] / np.maximum(np.abs(pd)[same], 1e-30)
        worst = max(worst, float(rel.max()))
    if worst > 1e-5:
        fail(f"phase 13: H1 distances off the plain version's by {worst:.3e}"
             " relative")

    # a filtered search: half the slots pass
    mrng = np.random.default_rng([args.seed, 131])
    mask = mrng.random(t["valid"].shape[0]) < 0.5
    mres = index.search_batch_device(qs, K, ef=max(P13_EFS), slot_mask=mask)
    for r in mres:
        if len(r) != K or not all(mask[index.slot_of(i)] for i, _ in r):
            fail("phase 13: the masked search returned an ineligible slot "
                 "or fewer than k")
    row_slots = np.array([index.slot_of(int(store._id_to_internal[str(i)]))
                          for i in range(n)])
    elig = torch.from_numpy(mask[row_slots]).to(dev)
    _, mora = oracle_sq(q, db, (db * db).sum(1), elig, K, torch)
    mrec = recall_at([[int(id_map[i]) for i, _ in r] for r in mres], mora,
                     np)
    if mrec < recs[max(P13_EFS)] - P13_MASKED_GAP:
        fail(f"phase 13: masked recall@{K} {mrec:.4f} trails the unmasked "
             f"{recs[max(P13_EFS)]:.4f} by more than {P13_MASKED_GAP}")

    # the device traversal over phase 12's host-built 16384-row graph
    small = p12["index"]
    sres = small.search_batch_device(p12["qs"], K, ef=max(P12_EFS))
    smap = p12["store"].internal_to_string_ids()
    srec = recall_at([[int(smap[i]) for i, _ in r] for r in sres],
                     p12["ora_i"], np)
    if srec < P12_RECALL_MIN:
        fail(f"phase 13: the device traversal over phase 12's graph has "
             f"recall@{K} {srec:.4f} at ef={max(P12_EFS)}, below "
             f"{P12_RECALL_MIN}")
    del db, q, valid, elig, searcher, t, targs
    say(f"phase 13 HNSW device N={n} x {D} intrinsic-dim-32 rows, m="
        f"{params.m}, seed {args.seed}, Q={nq} k={K} [{card}]: "
        f"bulk_build='auto' took the device build in {build_s:.3f} s "
        f"({'; '.join(split)}); its window launched K1 "
        f"{build_counts['coarse_minima_1p_sup']} ({k1b}), K2 "
        f"{build_counts['refine_dots']} ({k2b}), K3 "
        f"{build_counts['coarse_minima']}; device tables "
        f"{tables_s:.3f} s; " + "; ".join(lines))
    say(f"phase 13 checks: H1 equals its plain version on "
        f"{P13_CHECK_QUERIES} queries at each ef ({ties} k-th ties, "
        f"distances within {worst:.3e} relative); masked search (half the "
        f"slots) eligible-only, recall@{K} {mrec:.4f} at ef="
        f"{max(P13_EFS)}; phase 12's {P12_ROWS}-row host graph on the card "
        f"recall@{K} {srec:.4f} at ef={max(P12_EFS)}")
    for r in h1.values():
        for key in ("kd", "ks", "pd", "ps"):
            del r[key]
    return {"launches": h1_launches, "err": worst, "h1": h1,
            "build": {k: build_counts[k] for k in
                      ("coarse_minima_1p_sup", "refine_dots",
                       "coarse_minima")}}


def ivf_returned_exact(name, res, queries, rows_dev, torch, np):
    """Every distance an IVF search returned equals the on-card f32
    distance of its id (rtol / atol 2e-5); returns the largest error."""
    ids = torch.tensor([[int(r.id) for r in row] for row in res],
                       device=rows_dev.device)
    got = torch.tensor([[r.distance for r in row] for row in res],
                       device=rows_dev.device)
    x = rows_dev[ids]                                   # (Q, k, d)
    q = queries[:, None, :]
    d2 = ((q * q).sum(-1) + (x * x).sum(-1)
          - 2.0 * torch.bmm(x, queries[:, :, None])[..., 0])
    want = torch.sqrt(torch.clamp(d2, min=0.0))
    err = (got - want).abs()
    if bool((err > 2e-5 * want.abs() + 2e-5).any()):
        fail(f"{name}: a returned distance is off the f32 distance of its "
             f"id by {float(err.max()):.3e}")
    return float(err.max())


def ivf_store(kind, n, rows, mods, **kw):
    from vectordb_tpu_torch import IvfFlatIndex
    VectorStore, Vector = mods["VectorStore"], mods["Vector"]
    BatchInsertItem = mods["BatchInsertItem"]
    E = mods["DistanceMetric"].EUCLIDEAN
    index = IvfFlatIndex(E, storage=kind, auto_train_min=1 << 40,
                         device="cuda", **kw)
    store = VectorStore.with_index(index)
    for r0 in range(0, n, 1 << 16):
        store.insert_batch([BatchInsertItem(str(i), Vector(rows[i]))
                            for i in range(r0, min(r0 + (1 << 16), n))])
    return store, index


# a training's stages by their spans (utils/profiling.annotate)
TRAIN_SPANS = {"kmeans": "vdb/ivf.kmeans", "assign": "vdb/ivf.assign",
               "repack": "vdb/ivf.repack", "spill_cids": "vdb/pq.spill_cids",
               "opq": "vdb/pq.opq", "codebook": "vdb/pq.codebook"}


def span_seconds(before: dict) -> dict:
    """Seconds of each training stage since ``before`` (a copy of
    ``profiling.spans()``), by stage."""
    from vectordb_tpu_torch.utils import profiling
    now = profiling.spans()

    def total(table, name):
        return table.get(name, {}).get("total_s", 0.0)
    return {stage: total(now, name) - total(before, name)
            for stage, name in TRAIN_SPANS.items()}


def ivf_train(index, torch):
    """(train seconds, its split, device build seconds)."""
    from vectordb_tpu_torch.utils import profiling
    before = profiling.spans()
    t0 = time.perf_counter()
    index.train()
    train_s = time.perf_counter() - t0
    marks = span_seconds(before)
    t0 = time.perf_counter()
    with index._lock:
        index._sync_device()
    torch.cuda.synchronize()
    return train_s, marks, time.perf_counter() - t0


def ivf_phase(args, card, mods):
    """Phase 14 (module docstring). Returns the launch counts of its
    windows by kernel key."""
    import shutil
    import tempfile

    from vectordb_tpu_torch import FlatIndex, IvfFlatIndex
    from vectordb_tpu_torch.persistence import EngineConfig, StorageEngine
    np, torch = mods["np"], mods["torch"]
    cuda_kernels = mods["cuda_kernels"]
    Vector, BatchInsertItem = mods["Vector"], mods["BatchInsertItem"]
    E = mods["DistanceMetric"].EUCLIDEAN
    n, nq = P14_ROWS, P14_QUERIES
    rows, qs = intrinsic_rows(np.random.default_rng([args.seed, 14]), n, nq,
                              np)
    t0 = time.perf_counter()
    store, index = ivf_store("f32", n, rows, mods)
    load_s = time.perf_counter() - t0
    train_s, marks, build_s = ivf_train(index, torch)
    if index._nlist != min(1 << 15, n // 128):
        fail(f"phase 14: auto nlist is {index._nlist}, not n / 128")
    windows = {}

    # calibration: the exact truth is the flat path over the trained
    # layout (K4 + K2 over f32 rows, K5 as tier 2)
    cuda_kernels.reset_launches()
    t0 = time.perf_counter()
    cal = index.calibrate_nprobe(0.95)
    cal_s = time.perf_counter() - t0
    windows["calibrate"] = dict(cuda_kernels.launches)
    k4 = check_wgmma("phase 14 calibrate", "coarse_minima_f32_1p_sup",
                     cuda_kernels)
    check_tile_major("phase 14 calibrate", cuda_kernels)
    if windows["calibrate"]["coarse_minima_f32_1p_sup"] < 1:
        fail("phase 14: the exact truth launched no K4")

    dev = torch.device("cuda")
    db = torch.from_numpy(rows).to(dev)
    q = torch.from_numpy(qs).to(dev)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    _, ora_i = oracle_sq(q, db, (db * db).sum(1), valid, K, torch)
    batch = [(Vector(qq), K) for qq in qs]
    cuda_kernels.reset_launches()
    lines, worst = [], 0.0
    for npb in P14_NPROBES:
        t0 = time.perf_counter()
        res = store.search_batch(batch, nprobe=npb)
        store_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        index._probed_slots(qs, K, npb, None, None)
        index_ms = (time.perf_counter() - t0) * 1e3
        got = [[int(r.id) for r in row] for row in res]
        rec = recall_at(got, ora_i, np)
        worst = max(worst, ivf_returned_exact(f"phase 14 nprobe={npb}", res,
                                              q, db, torch, np))
        lines.append(f"nprobe={npb}: store batch {store_ms:.3f} ms, index "
                     f"batch {index_ms:.3f} ms, recall@{K} {rec:.4f}")
    windows["search"] = dict(cuda_kernels.launches)
    k2 = check_tile_major("phase 14 probed searches", cuda_kernels)
    if windows["search"]["refine_dots"] < len(P14_NPROBES):
        fail(f"phase 14: the probed searches launched K2 "
             f"{windows['search']['refine_dots']} times")
    hier = index._nlist >= IvfFlatIndex._HIER_AUTO_NLIST
    say(f"phase 14 IVF-Flat N={n} x {D} intrinsic-dim-32 rows, f32, nlist "
        f"{index._nlist} ({'hierarchical' if hier else 'flat'} assignment), "
        f"t_c {index._t_c}, spill "
        f"tiles {index._s_t}, Q={nq} k={K} [{card}]: load {load_s:.3f} s; "
        f"train {train_s:.3f} s (k-means {marks['kmeans']:.3f}, assignment "
        f"{marks['assign']:.3f}, balance + repack {marks['repack']:.3f}), "
        f"device build {build_s:.3f} s; calibrate_nprobe(0.95) -> "
        f"{cal['nprobe']} (recall {cal['recall']:.4f}, curve "
        f"{ {k: round(v, 4) for k, v in cal['curve'].items()} }) in "
        f"{cal_s:.3f} s, its exact truth K4 by body {k4}; " + "; ".join(lines)
        + f"; every returned distance within {worst:.3e} of the f32 distance"
        f" of its id; K2 by body {k2}")

    # nprobe over the native front end
    state, thread = serve_thread(store, backend="native")
    try:
        port = state.server.port
        for npb in (1, 8):
            want = [r.id for r in store.search(Vector(qs[3]), K,
                                               nprobe=npb)]
            st, hits = http_call(port, "POST", "/search", {
                "vector": qs[3].tolist(), "k": K, "nprobe": npb})
            st2, bhits = http_call(port, "POST", "/search/batch", {
                "queries": [{"vector": qs[3].tolist(), "k": K}],
                "nprobe": npb})
            if (st, st2) != (200, 200) or [h["id"] for h in hits] != want \
                    or [h["id"] for h in bhits[0]] != want:
                fail(f"phase 14 http nprobe={npb}: {st} {st2} differ from "
                     "the in-process answers")
    finally:
        stop_server(state, thread)
    del store, index, db, q, valid, batch
    free(torch)

    # bf16 and int8 storage at 2^18 rows (a reduction: the quantized
    # refine routes, not scale)
    small_lines = []
    for kind, k2key, coarse in (("bf16", "refine_dots_bf16",
                                 "coarse_minima_1p_sup"),
                                ("int8", "refine_dots_int8",
                                 "coarse_minima_int8_1p_sup")):
        s_store, s_idx = ivf_store(kind, P14_SMALL, rows, mods)
        s_train, s_marks, s_build = ivf_train(s_idx, torch)
        sq = qs[:1024]
        cuda_kernels.reset_launches()
        res = s_store.search_batch([(Vector(qq), K) for qq in sq], nprobe=8)
        truth = FlatIndex.search_batch(s_idx, sq, K)
        win = dict(cuda_kernels.launches)
        windows[kind] = win
        check_tile_major(f"phase 14 {kind}", cuda_kernels)
        body = check_wgmma(f"phase 14 {kind} exact truth", coarse,
                           cuda_kernels)
        if win[k2key] < 2 or win[coarse] < 1:
            fail(f"phase 14 {kind}: launches {win}")
        stored = torch.from_numpy(
            s_idx._live_rows_snapshot()).to(dev)     # slot order
        live_ids = [int(s_idx._id_of_slot[s]) for s in
                    np.flatnonzero(s_idx._valid[:s_idx._capacity])]
        by_id = torch.empty_like(stored)
        by_id[torch.tensor(live_ids, device=dev)] = stored
        err = ivf_returned_exact(f"phase 14 {kind}", res,
                                 torch.from_numpy(sq).to(dev), by_id, torch,
                                 np)
        rec = recall_at([[int(r.id) for r in row] for row in res],
                        np.array([[i for i, _ in r] for r in truth]), np)
        small_lines.append(
            f"{kind}: train {s_train:.3f} s, device build {s_build:.3f} s, "
            f"recall@{K} {rec:.4f} at nprobe 8 against its exact truth, "
            f"distances within {err:.3e}; K2 {win[k2key]} tile_major, "
            f"exact truth {'K7' if kind == 'int8' else 'K1'} "
            f"{win[coarse]} ({body})")
        del s_store, s_idx, stored, by_id, res, truth
        free(torch)

    # a durable IVF engine at 2^17 rows: reopen imports ivf_state.npz
    base = tempfile.mkdtemp(prefix="vdb_p14_")
    cfg = EngineConfig(checkpoint_interval=1 << 30, index_type="ivf",
                       device="cuda")
    dq = [Vector(qq) for qq in qs[:256]]
    try:
        t0 = time.perf_counter()
        with StorageEngine.open(base, cfg) as eng:
            for r0 in range(0, P14_DURABLE, 1 << 15):
                eng.insert_batch([BatchInsertItem(str(i), Vector(rows[i]))
                                  for i in range(r0, r0 + (1 << 15))])
            eng.store.index.train()
            before = [[(r.id, r.distance) for r in eng.search(v, K,
                                                              nprobe=8)]
                      for v in dq]
            eng.checkpoint()
        write_s = time.perf_counter() - t0
        trains = []
        orig = IvfFlatIndex.train
        IvfFlatIndex.train = lambda self: trains.append(1) or orig(self)
        try:
            t0 = time.perf_counter()
            with StorageEngine.open(base, cfg) as eng:
                reopen_s = time.perf_counter() - t0
                after = [[(r.id, r.distance) for r in eng.search(
                    v, K, nprobe=8)] for v in dq]
                trained = eng.store.index.is_trained
        finally:
            IvfFlatIndex.train = orig
        if trains or not trained:
            fail(f"phase 14 durable: the reopen trained {len(trains)} times"
                 f" (trained {trained})")
        # the same ids; a row's squared norm comes back from np.dot where
        # the batch load summed it by einsum (the JAX package's import,
        # ROADMAP queue 3), so distances may move within f32 rounding of
        # |x|^2
        if [[i for i, _ in r] for r in after] != \
                [[i for i, _ in r] for r in before]:
            fail("phase 14 durable: the reopened engine answers other ids "
                 "than its writer")
        sq_max = float(np.max(np.einsum("ij,ij->i", rows[:P14_DURABLE],
                                        rows[:P14_DURABLE])))
        moved = np.array([abs(a[1] ** 2 - b[1] ** 2)
                          for ra, rb in zip(after, before)
                          for a, b in zip(ra, rb)])
        if moved.max() > 8 * D * 2.0 ** -24 * sq_max:
            fail(f"phase 14 durable: a reopened distance moved by "
                 f"{moved.max():.3e} in d^2")
        state_kb = os.path.getsize(os.path.join(base, "ivf_state.npz")) / 1e3
    finally:
        shutil.rmtree(base, ignore_errors=True)
    say(f"phase 14 quantized stores N={P14_SMALL} (reduced: the refine "
        f"routes, not scale), Q=1024 [{card}]: " + "; ".join(small_lines))
    say(f"phase 14 durable IVF engine N={P14_DURABLE}: insert + train + "
        f"checkpoint {write_s:.3f} s (ivf_state.npz {state_kb:.1f} KB), "
        f"reopen {reopen_s:.3f} s with the layout imported (no train), "
        f"{len(dq)} answers with the writer's ids, "
        f"{int((moved > 0).sum())} of {moved.size} distances moved (at "
        f"most {moved.max():.3e} in d^2: np.dot norms on import against "
        f"the batch load's einsum); nprobe 1 and 8 over the native front "
        f"end answer as the store")
    return windows


P15_ROWS = 1 << 20
P15_QUERIES = 4096
P15_REFINES = (16, 32, 64, 128)
P15_RECALL_MIN = 0.95      # recall@10 at refine 128
P15_CHECK_QUERIES = 256    # the pool, score and venue checks
P15_DURABLE = 1 << 17      # the durable engine's rows (reduced)
P15_CENTERS = 2048         # benchmarks/pq_bench.py CENTERS, NOISE
# K8s alone at the benchmark cell's scan (cohere768-1m-ivfpq: nlist 7812,
# span 208, the spill block rounded to 2^15 slots; Q = 64, m = 96)
P15_CELL = {"nlist": 7812, "span": 208, "spill": 1 << 15, "queries": 64}
P15_NOISE = 0.25


def clustered_intrinsic_rows(rng, n, nq, np):
    """benchmarks/pq_bench.py's clustered_intrinsic protocol (:87-100):
    2048 N(0,1) centers in D dimensions, each row a center plus 0.25 z @
    basis with z in a shared 32-dim subspace; queries of the same model.
    From the caller's generator, chunked: (rows, queries) f32."""
    centers = rng.standard_normal((P15_CENTERS, D), dtype=np.float32)
    basis = (rng.standard_normal((32, D), dtype=np.float32)
             / np.float32(np.sqrt(32)))

    def draw(m):
        which = rng.integers(0, P15_CENTERS, m)
        return centers[which] + np.float32(P15_NOISE) * (
            rng.standard_normal((m, 32), dtype=np.float32) @ basis)

    rows = np.empty((n, D), np.float32)
    for r0 in range(0, n, 1 << 16):
        rows[r0:r0 + (1 << 16)] = draw(min(1 << 16, n - r0))
    return rows, draw(nq)


SCAN_POOL_LIMIT = 2e-6      # K8s against the chunk loop at the cell's
                            # scan (cosine), of each query's max|score|


def pool_agreement(sv_a, sl_a, sv_b, sl_b, tol):
    """Two scans' pools against each query's tolerance ``tol`` (a list):
    (the worst of a slot both kept, its two scores' difference over tol,
    and of a slot only one kept, its score's distance from the other
    pool's last kept score over 2 tol; the count of such positions)."""
    worst, ties = 0.0, 0
    for a_v, a_s, b_v, b_s, t in zip(sv_a.tolist(), sl_a.tolist(),
                                     sv_b.tolist(), sl_b.tolist(), tol):
        a_of, b_of = dict(zip(a_s, a_v)), dict(zip(b_s, b_v))
        for slot in a_of.keys() & b_of.keys():
            if a_of[slot] != b_of[slot]:
                worst = max(worst, abs(a_of[slot] - b_of[slot]) / t)
        for slot in a_of.keys() ^ b_of.keys():
            ties += 1
            worst = max(worst, abs(a_of.get(slot, b_of.get(slot))
                                   - b_v[-1]) / (2 * t))
    return worst, ties


def k8s_at_cell(rng, np, torch, pq_ops, cuda_kernels, metric):
    """K8s alone at the benchmark cell's scan geometry (P15_CELL: random
    codes, codebook, centroids and queries; 1% dead slots), by CUDA events:
    the kernel for each metric, the top r over its scores (its selection
    kernel, beside torch.topk and held to its values), the whole fused
    scan call and its device operations (profiler), the chunk loop with
    K8 and with the plain decode, and the two routes' pools."""
    nlist, span, spill, q = (P15_CELL[k] for k in ("nlist", "span",
                                                    "spill", "queries"))
    m, ksub, dsub, r = 96, 256, 8, 128
    dev = torch.device("cuda")
    n = nlist * span + spill
    cb = torch.from_numpy(rng.standard_normal(
        (m, ksub, dsub), dtype=np.float32) * 0.3).to(dev).to(torch.bfloat16)
    codes = torch.from_numpy(rng.integers(0, ksub, (n, m),
                                          dtype=np.uint8)).to(dev)
    valid = torch.from_numpy(rng.random(n) >= 0.01).to(dev)
    cents = torch.from_numpy(rng.standard_normal(
        (nlist, D), dtype=np.float32)).to(dev).to(torch.bfloat16).float()
    csq = (cents * cents).sum(1)
    cid_sp = torch.from_numpy(rng.integers(0, nlist, spill).astype(
        np.int32)).to(dev)
    qs = torch.from_numpy(rng.standard_normal((q, D), dtype=np.float32)).to(
        dev)
    cnorm = (cb.float() ** 2).sum(-1)
    cpc = PQ_CHUNK // span
    q_hi, q_lo = pq_ops._split_query(qs)
    cents_bf = cents.to(torch.bfloat16)
    qc = pq_ops._score_dots(q_hi, q_lo, cents_bf)
    ms = {}
    for mode in ("euclidean", "dot", "cosine"):
        ms[mode], scores = cuda_time(lambda mo=mode: cuda_kernels.ivfpq_scan(
            codes, cb, q_hi, q_lo, qc, cents_bf, csq, cid_sp, valid, span,
            nlist, mo), torch, iters=20)
    topk_ms, (sv_s, sl_s) = cuda_time(lambda: pq_ops._select_topr(scores, r),
                                      torch, 10)
    lib_topk_ms, want = cuda_time(lambda: torch.topk(scores, r, dim=1,
                                                     largest=False), torch,
                                  10)
    if not (torch.equal(sv_s, want.values)
            and torch.equal(torch.gather(scores, 1, sl_s), sv_s)):
        fail("phase 15: K8s's selection differs from torch.topk at the "
             "cell's scan")
    del scores, want, sv_s, sl_s
    args = (qs, codes, cb, cnorm, valid, cents, csq, cid_sp, metric)
    scan_ms, (sv_f, sl_f) = cuda_time(lambda: pq_ops.ivfpq_scan_topr(
        *args, r=r, cpc=cpc, span=span, nlist=nlist), torch, 10)
    launches, ops = device_launches(lambda: pq_ops.ivfpq_scan_topr(
        *args, r=r, cpc=cpc, span=span, nlist=nlist), torch)
    chunked_ms, (sv_c, sl_c) = cuda_time(lambda: pq_ops._ivfpq_scan_chunked(
        *args, r, cpc, span, nlist), torch)
    real = pq_ops.pq_decode_rows
    pq_ops.pq_decode_rows = pq_ops._decode_rows_plain
    try:
        plain_ms, _ = cuda_time(lambda: pq_ops._ivfpq_scan_chunked(
            *args, r, cpc, span, nlist), torch, 1)
    finally:
        pq_ops.pq_decode_rows = real
    tol = (SCAN_POOL_LIMIT * sv_c.abs().max(1).values).tolist()
    off, ties = pool_agreement(sv_f, sl_f, sv_c, sl_c, tol)
    if off > 1.0:
        fail(f"phase 15: at the cell's scan K8s's pool is off the chunk "
             f"loop's by {off:.3f} of SCAN_POOL_LIMIT x max|score|")
    flops = 2 * 2 * q * n * D
    nbytes = n * m + 4 * q * n
    return {"n": n, "nlist": nlist, "span": span, "spill": spill, "q": q,
            "r": r, "ms": ms["cosine"], "ms_euclidean": ms["euclidean"],
            "ms_dot": ms["dot"], "bound": bound(flops, nbytes, PEAK_BF16),
            "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
            "topk_ms": topk_ms, "lib_topk_ms": lib_topk_ms,
            "scan_ms": scan_ms,
            "route": cuda_kernels.ivfpq_scan_body(codes, cb),
            "launches": launches, "ops": ops, "chunked_ms": chunked_ms,
            "plain_ms": plain_ms, "pool_off": off, "pool_ties": ties}


def ivfpq_phase(args, card, mods):
    """Phase 15 (module docstring). Returns the launches of its windows:
    the store searches' K8 (by body), the durable engine's K8 by body,
    the exact fallback's kernels."""
    import shutil
    import tempfile

    from vectordb_tpu_torch import IvfPqIndex
    from vectordb_tpu_torch.ops import pq as pq_ops
    from vectordb_tpu_torch.persistence import EngineConfig, StorageEngine
    np, torch = mods["np"], mods["torch"]
    cuda_kernels = mods["cuda_kernels"]
    VectorStore, Vector = mods["VectorStore"], mods["Vector"]
    BatchInsertItem = mods["BatchInsertItem"]
    E = mods["DistanceMetric"].EUCLIDEAN
    dev = torch.device("cuda")
    n, nq = P15_ROWS, P15_QUERIES
    rng = np.random.default_rng([args.seed, 15])
    rows, qs = clustered_intrinsic_rows(rng, n, nq, np)
    dead = rng.choice(n, 1024, replace=False)
    store = VectorStore.with_index(IvfPqIndex(E, device="cuda"))
    index = store.index
    t0 = time.perf_counter()
    load_store(store, rows, [], BatchInsertItem, Vector)
    load_s = time.perf_counter() - t0
    from vectordb_tpu_torch.utils import profiling
    before = profiling.spans()
    t0 = time.perf_counter()
    index.train()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    marks = span_seconds(before)
    if index._nlist != min(1 << 15, n // 128):
        fail(f"phase 15: auto nlist is {index._nlist}, not n / 128")
    for i in dead:                  # deletes leave dead slots in clusters
        store.delete(str(int(i)))
    t0 = time.perf_counter()
    with index._lock:
        index._pq_sync()            # the full encode of every live row
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    nlist, span, cpc = index._nlist, index._span, index._scan_cpc()
    chunk, big_m = cpc * span, index._spill_base
    s_rows = index._capacity - big_m
    spill_live = int(index._valid[big_m:].sum())
    nfull = big_m // chunk
    tail = nlist - nfull * cpc
    per_scan = nfull + (1 if tail else 0) + (1 if s_rows else 0)
    batch = [(Vector(q), K) for q in qs]

    # the path's run: only this store's searches between reset and read
    cuda_kernels.reset_launches()
    t0 = time.perf_counter()
    store.search_batch(batch)                  # first search, refine 64
    first_s = time.perf_counter() - t0
    results, store_s = {}, {}
    for refine in P15_REFINES:
        t0 = time.perf_counter()
        results[refine] = store.search_batch(batch, refine=refine)
        store_s[refine] = time.perf_counter() - t0
    counts = dict(cuda_kernels.launches)
    k8_routes = dict(cuda_kernels.routes["pq_decode"])
    scan_routes = dict(cuda_kernels.routes["ivfpq_scan"])
    searches = 1 + len(P15_REFINES)
    with index._lock:
        state = dict(index._scan_state())
        rr_rows = index._sync_device()["db"]
    route = cuda_kernels.ivfpq_scan_body(state["codes"], state["codebook"])
    # every search: one K8s launch a query block, no K8, no chunk loop
    if (route != "fused" or counts["pq_decode"] or scan_routes["chunked"]
            or scan_routes["fused"] < searches
            or scan_routes["fused"] % searches):
        fail(f"phase 15: the store's scans took route {route!r}, K8s by "
             f"route {scan_routes}, K8 {counts['pq_decode']} over "
             f"{searches} searches: {counts}")
    fused_a_scan = scan_routes["fused"] // searches

    # (1) every returned distance is the f32 distance of its id; (2)
    # recall@10 against an on-card f32 oracle over the rows as inserted
    queries = torch.from_numpy(qs).to(dev)
    db_t = torch.from_numpy(rows).to(dev)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    valid[torch.from_numpy(dead).to(dev)] = False
    _, ora_i = oracle_sq(queries, db_t, (db_t * db_t).sum(1), valid, K,
                         torch)
    recall, derr = {}, 0.0
    for refine, res in results.items():
        ids, dists = store_ids(res, np)
        if ids.shape != (nq, K) or np.isin(ids, dead).any():
            fail(f"phase 15 refine {refine}: {ids.shape} results, or a "
                 f"deleted row returned")
        sel = torch.from_numpy(ids).to(dev)
        true = torch.sqrt(((db_t[sel] - queries[:, None, :]) ** 2).sum(-1))
        err = np.abs(dists - true.cpu().numpy())
        if not np.all(err <= 2e-5 * true.cpu().numpy() + 1e-6):
            fail(f"phase 15 refine {refine}: a returned distance is off its"
                 f" id's f32 distance by {err.max():.3e}")
        derr = max(derr, float(err.max()))
        recall[refine] = recall_at(ids.tolist(), ora_i, np)
    if recall[128] < P15_RECALL_MIN:
        fail(f"phase 15: recall@{K} at refine 128 is {recall[128]:.4f} < "
             f"{P15_RECALL_MIN}")

    # (3) the scan's pool (K8s) against the chunk loop's on the card, and
    # the chunk loop's with K8 against the one with the plain decode
    rot = index._rot_dev_arr()
    qc = queries[:P15_CHECK_QUERIES]

    def scan(qb, r=64):
        return index._scan_call(state, qb, r)

    def chunked(qb, r=64):
        return pq_ops._ivfpq_scan_chunked(
            qb, state["codes"], state["codebook"], state["cnorm"],
            state["valid"], state["cents"], state["csq"], state["cid_sp"],
            E, r, cpc, span, nlist, rot)

    sv_k, sl_k = scan(qc)
    sv_c, sl_c = chunked(qc)
    real = pq_ops.pq_decode_rows
    pq_ops.pq_decode_rows = pq_ops._decode_rows_plain
    try:
        sv_p, sl_p = chunked(qc)
    finally:
        pq_ops.pq_decode_rows = real
    if not (torch.equal(sl_c, sl_p) and torch.equal(sv_c, sv_p)):
        fail("phase 15: the chunk loop's pool with K8 differs from the "
             "plain decode's")
    # K8 at the chunk and the spill block, bit for bit (after the
    # window's read: these launches compare the kernel with its plain
    # version)
    for name, cc in (("chunk", state["codes"][:chunk]),
                     ("spill", state["codes"][big_m:])):
        if cc.shape[0] and not torch.equal(
                cuda_kernels.pq_decode(cc, state["codebook"]).view(
                    torch.int16),
                pq_ops._decode_rows_plain(cc, state["codebook"]).view(
                    torch.int16)):
            fail(f"phase 15: K8 differs from the plain decode on the {name}")

    # (4) the pool's scores against their f64 recomputation from the
    # residual reconstruction x_hat = c[cid] + r_hat; the limit must break
    # for a bf16-output c.r_hat and for a dropped q_lo term
    slots = sl_k.reshape(-1)
    cid = torch.where(slots < big_m, slots // span,
                      state["cid_sp"].long()[
                          torch.clamp(slots - big_m, min=0)].clamp(
                              0, nlist - 1))
    res_h = pq_ops._decode_rows_plain(state["codes"][slots],
                                      state["codebook"]).double()
    cen = state["cents"][cid].double()
    x64 = (cen + res_h).reshape(P15_CHECK_QUERIES, 64, D)
    qr = pq_ops._maybe_rotate(qc, rot)
    q64 = qr.double()
    xsq64 = (x64 * x64).sum(-1)
    ref = xsq64 - 2.0 * torch.bmm(x64, q64[:, :, None])[..., 0]
    lim = PQ_SCORE_LIMIT * (xsq64 + 2.0 * torch.sqrt(xsq64)
                            * torch.sqrt((q64 * q64).sum(1))[:, None])
    live = torch.isfinite(sv_k)

    def off(scores):
        return float(((scores.double() - ref).abs() / lim)[live].max())

    cr64 = (cen * res_h).sum(-1).reshape(P15_CHECK_QUERIES, 64)
    cr_bf = cr64.to(torch.bfloat16).double()
    q_hi, _ = pq_ops._split_query(qr)
    d_nolo = torch.bmm(x64, q_hi.double()[:, :, None])[..., 0]
    score_off = {"scan": off(sv_k),
                 "bf16 c.r": off(ref + 2.0 * (cr_bf - cr64)),
                 "no q_lo": off(xsq64 - 2.0 * d_nolo)}
    if score_off["scan"] > 1.0:
        fail(f"phase 15: the scan's scores are off their f64 recomputation:"
             f" {score_off} (in units of the limit)")
    if min(score_off["bf16 c.r"], score_off["no q_lo"]) <= 1.0:
        fail(f"phase 15: a score control passed the limit: {score_off}")
    # K8s's pool against the chunk loop's: each query's tolerance its
    # largest limit above (PQ_SCORE_LIMIT of |x|^2 + 2 |x| |q|); the
    # euclidean surrogate cancels most of its terms, so max|score| is no
    # scale for its rounding
    pool_off, pool_ties = pool_agreement(sv_k, sl_k, sv_c, sl_c,
                                         lim.max(1).values.tolist())
    if pool_off > 1.0:
        fail(f"phase 15: K8s's pool is off the chunk loop's by {pool_off:.3f}"
             f" of the limit (ties {pool_ties})")
    del res_h, cen, x64, ref, lim, cr64, cr_bf, d_nolo

    # (5) the "mirror" and "host" re-rank venues agree
    if index._rerank_venue() != "mirror":
        fail(f"phase 15: IVF-PQ on the card re-ranks on "
             f"{index._rerank_venue()!r}")
    res_m = index.search_batch(qs[:P15_CHECK_QUERIES], K)
    index.rerank_mode = "host"
    res_h = index.search_batch(qs[:P15_CHECK_QUERIES], K)
    index.rerank_mode = "auto"
    vties = venue_ties(res_m, res_h, 1e-6, np)

    # the exact fallback over the layout (a refine past the scan's pool):
    # K4 + K2 over the f32 device rows, exact against the oracle
    cuda_kernels.reset_launches()
    fb = store.search_batch(batch[:P15_CHECK_QUERIES], refine=2048)
    fb_counts = dict(cuda_kernels.launches)
    fb_k4 = check_wgmma("phase 15 fallback", "coarse_minima_f32_1p_sup",
                        cuda_kernels)
    check_tile_major("phase 15 fallback", cuda_kernels)
    if fb_counts["pq_decode"] or fb_counts["coarse_minima_f32_1p_sup"] < 1 \
            or fb_counts["refine_dots"] < 1:
        fail(f"phase 15: the fallback's launches {fb_counts}")
    # ids: the k nearest by the difference-form distance (the oracle's
    # top k+1 re-sorted by it); distances: the flat path's norm expansion
    # |q|^2 + |x|^2 - 2 q.x, within f32 rounding of |q|^2 + |x|^2 (these
    # rows cluster: d^2 is ~6% of the norms, so an rtol on d cannot hold)
    q_fb = queries[:P15_CHECK_QUERIES, None, :]

    def true_d(ids):
        x = db_t[torch.from_numpy(ids).to(dev)]
        return (torch.sqrt(((x - q_fb) ** 2).sum(-1)).cpu().numpy(),
                ((q_fb * q_fb).sum(-1) + (x * x).sum(-1)).cpu().numpy())

    ora_d, _ = true_d(ora_i[:P15_CHECK_QUERIES])
    order = np.argsort(ora_d, axis=1, kind="stable")
    fb_ids, fb_d = store_ids(fb, np)
    got_d, norms = true_d(fb_ids)
    fties, _ = check_exact_d(
        "phase 15 fallback", fb_ids, got_d,
        np.take_along_axis(ora_d, order, 1),
        np.take_along_axis(ora_i[:P15_CHECK_QUERIES], order, 1), K, np)
    fb_err = float((np.abs(fb_d.astype(np.float64) ** 2 - got_d ** 2)
                    / norms).max() / 2.0 ** -24)
    if fb_err > 4 * np.sqrt(D):
        fail(f"phase 15 fallback: a distance^2 is off by {fb_err:.1f} "
             f"f32 ulps of |q|^2 + |x|^2")

    # (7) refine over the native front end
    srv, thread = serve_thread(store, backend="native")
    try:
        port = srv.server.port
        for refine in (16, 128):
            want = [r.id for r in store.search(Vector(qs[3]), K,
                                               refine=refine)]
            st, hits = http_call(port, "POST", "/search", {
                "vector": qs[3].tolist(), "k": K, "refine": refine})
            st2, bhits = http_call(port, "POST", "/search/batch", {
                "queries": [{"vector": qs[3].tolist(), "k": K}],
                "refine": refine})
            st3, _ = http_call(port, "POST", "/search", {
                "vector": qs[3].tolist(), "k": K, "nprobe": 4})
            if (st, st2, st3) != (200, 200, 400) \
                    or [h["id"] for h in hits] != want \
                    or [h["id"] for h in bhits[0]] != want:
                fail(f"phase 15 http refine={refine}: {st} {st2} {st3} "
                     f"differ from the in-process answers")
    finally:
        stop_server(srv, thread)

    # the scan and the re-rank of one batch at each refine, by CUDA events
    splits = {}
    for refine in P15_REFINES:
        gc.collect()
        ms_scan, _, (sv, sl) = events_ms(
            lambda r=refine: index._scan_call(state, queries, r), torch)
        ms_rr, _, _ = events_ms(lambda: pq_ops.pq_rerank_topk(
            queries, rr_rows, sl, sv, state["valid"], E, K), torch)
        splits[refine] = (ms_scan, ms_rr)
        del sv, sl
    # the scan's steps at one chunk (r = 128), and the hoisted q.c GEMMs
    cc = state["codes"][:chunk]
    cb_bf, cnorm = state["codebook"], state["cnorm"]
    q_hi, q_lo = pq_ops._split_query(pq_ops._maybe_rotate(queries, rot))
    cents_bf = state["cents"].to(torch.bfloat16)
    steps = {}
    steps["K8"], dec = cuda_time(lambda: pq_ops.pq_decode_rows(cc, cb_bf),
                                 torch, iters=20)
    steps["norm gather"], _ = cuda_time(lambda: pq_ops._decode_block(
        cc, cb_bf, cnorm)[1], torch)
    cen_c = cents_bf[:cpc].float()
    steps["c.r row-wise"], _ = cuda_time(lambda: torch.bmm(
        dec.view(cpc, span, D).float(), cen_c[:, :, None]), torch)
    steps["score GEMMs"], dots = cuda_time(
        lambda: pq_ops._score_dots(q_hi, q_lo, dec), torch)
    qcc = torch.zeros((nq, cpc), device=dev)
    steps["q.c add"], _ = cuda_time(lambda: (
        dots.view(nq, cpc, span) + qcc[:, :, None]).view(nq, chunk), torch)
    steps["top-128"], _ = cuda_time(lambda: torch.topk(
        dots, 128, dim=1, largest=False), torch)
    ms_qc, _ = cuda_time(lambda: pq_ops._score_dots(q_hi, q_lo, cents_bf),
                         torch)
    del dec, dots, qcc
    cell = k8s_at_cell(rng, np, torch, pq_ops, cuda_kernels,
                       mods["DistanceMetric"].COSINE)

    # (6) a durable IVF-PQ engine at P15_DURABLE rows: the reopen imports
    # ivfpq_state.npz (no train) and answers bit for bit as its writer
    base = tempfile.mkdtemp(prefix="vdb_p15_")
    cfg = EngineConfig(checkpoint_interval=1 << 30, index_type="ivfpq",
                       device="cuda")
    dq = [Vector(q) for q in qs[:256]]
    cuda_kernels.reset_launches()
    try:
        t0 = time.perf_counter()
        with StorageEngine.open(base, cfg) as eng:
            for r0 in range(0, P15_DURABLE, 1 << 15):
                eng.insert_batch([BatchInsertItem(str(i), Vector(rows[i]))
                                  for i in range(r0, r0 + (1 << 15))])
            eng.store.index.train()
            before_d = [[(r.id, r.distance) for r in eng.search(
                v, K, refine=64)] for v in dq]
            eng.checkpoint()
        write_s = time.perf_counter() - t0
        trains = []
        orig = IvfPqIndex.train
        IvfPqIndex.train = lambda self: trains.append(1) or orig(self)
        try:
            t0 = time.perf_counter()
            with StorageEngine.open(base, cfg) as eng:
                reopen_s = time.perf_counter() - t0
                after_d = [[(r.id, r.distance) for r in eng.search(
                    v, K, refine=64)] for v in dq]
                trained = eng.store.index.is_trained
        finally:
            IvfPqIndex.train = orig
        state_kb = os.path.getsize(os.path.join(base,
                                                "ivfpq_state.npz")) / 1e3
    finally:
        shutil.rmtree(base, ignore_errors=True)
    durable_k8 = dict(cuda_kernels.routes["pq_decode"])
    if trains or not trained:
        fail(f"phase 15 durable: the reopen trained {len(trains)} times "
             f"(trained {trained})")
    if after_d != before_d:
        fail("phase 15 durable: the reopened engine answers differently "
             "than its writer")

    spill_share = spill_live / max(len(store), 1)
    say(f"phase 15 IVF-PQ N={n} ({len(dead)} deleted) x {D} "
        f"clustered_intrinsic rows (2048 centers, 0.25 z @ basis, 32-dim), "
        f"nlist {nlist}, m={index._m}, ksub={index.ksub}, OPQ, span {span}, "
        f"cpc {cpc} (chunk {chunk} rows, {nfull} full + {1 if tail else 0} "
        f"tail chunks), spill {spill_live} live of {s_rows} slots "
        f"({spill_share:.4f} of the rows), Q={nq} k={K} [{card}]: load "
        f"{load_s:.3f} s; train {train_s:.3f} s (k-means "
        f"{marks['kmeans']:.3f}, assignment {marks['assign']:.3f}, balance"
        f" + repack {marks['repack']:.3f}, spill centroids "
        f"{marks['spill_cids']:.3f}, OPQ {marks['opq']:.3f}, codebook "
        f"{marks['codebook']:.3f}); encode {encode_s:.3f} s; first search "
        f"(refine 64) {first_s * 1e3:.3f} ms; store batch by refine "
        f"{ {r: round(t * 1e3, 3) for r, t in store_s.items()} } ms; "
        f"recall@{K} {({r: round(v, 4) for r, v in recall.items()})}; "
        f"returned distances = their ids' f32 distances (max err "
        f"{derr:.3e}); Q={P15_CHECK_QUERIES} pool with K8 = plain decode's;"
        f" pool scores vs f64, in units of the limit {PQ_SCORE_LIMIT:.3g} "
        f"S: { {k: round(v, 4) for k, v in score_off.items()} }; mirror vs "
        f"host venues agree ({vties} tied positions); refine 2048 takes "
        f"the exact fallback (K4 {fb_k4}, K2 {fb_counts['refine_dots']}), "
        f"exact ids ({fties} ties), d^2 within {fb_err:.1f} ulps of "
        f"|q|^2 + |x|^2; refine 16 and 128 over the native front end"
        f" answer as the store, nprobe -> 400")
    say(f"phase 15 launch counts (the IVF-PQ store's searches): "
        f"{ {k: v for k, v in counts.items() if v} }; scans by route "
        f"{scan_routes} ({fused_a_scan} K8s launches a scan of {nq} "
        f"queries, K8 on that path 0; the chunk loop would take "
        f"{per_scan} K8 a scan); K8s's pool at Q={P15_CHECK_QUERIES} vs "
        f"the chunk loop's on the card: {pool_off:.4f} of the limit "
        f"({pool_ties} tied positions), the chunk loop's with K8 = with "
        f"the plain decode")
    say(f"phase 15 K8s at the cell's scan [{card}]: N={cell['n']} slots "
        f"(nlist {cell['nlist']}, span {cell['span']}, spill "
        f"{cell['spill']}), m=96, Q={cell['q']}, cosine: kernel "
        f"{cell['ms']:.4f} ms by CUDA events (euclidean "
        f"{cell['ms_euclidean']:.4f}, dot {cell['ms_dot']:.4f}) against "
        f"its bound {cell['bound'][0]:.4f} ms ({cell['bound'][1]}: "
        f"{cell['gflop']:.1f} GFLOP of bf16, {cell['mbytes']:.1f} MB of "
        f"codes + scores); top-{cell['r']} over its scores "
        f"{cell['topk_ms']:.4f} ms (scan_select, two launches; torch.topk "
        f"{cell['lib_topk_ms']:.4f} ms, the same values); the scan call "
        f"(route "
        f"{cell['route']}) {cell['scan_ms']:.4f} ms, "
        + (f"{cell['launches']:.0f} device ops a call ({cell['ops']})"
           if cell['launches'] is not None else
           "device ops not read (the profiler saw no device event)")
        + f"; the chunk loop with K8 "
        f"{cell['chunked_ms']:.4f} ms, with the plain decode "
        f"{cell['plain_ms']:.4f} ms; pools {cell['pool_off']:.4f} of "
        f"{SCAN_POOL_LIMIT:g} max|score| apart ({cell['pool_ties']} tied "
        f"positions)")
    say(f"phase 15 times [{card}]: one batch by CUDA events, scan + device "
        f"re-rank ms, by refine "
        f"{ {r: (round(a, 3), round(b, 3)) for r, (a, b) in splits.items()} };"
        f" per chunk ({chunk} rows, Q={nq}): "
        f"{ {k: round(v, 4) for k, v in steps.items()} } ms; the hoisted q.c"
        f" GEMMs (Q x {nlist}) {ms_qc:.3f} ms")
    say(f"phase 15 durable IVF-PQ engine N={P15_DURABLE} (reduced: the "
        f"reopen, not scale): insert + train + checkpoint {write_s:.3f} s "
        f"(ivfpq_state.npz {state_kb:.1f} KB), reopen {reopen_s:.3f} s with "
        f"the state imported (no train), {len(dq)} answers bit-equal to the "
        f"writer's; K8 by body {durable_k8}")
    out = {"launches": counts["pq_decode"], "routes": k8_routes,
           "durable": durable_k8,
           "fallback": {k: v for k, v in fb_counts.items() if v},
           "scan_launches": scan_routes["fused"], "scan_routes": scan_routes,
           "cell": cell}
    del store, index, state, rr_rows, db_t, queries, results, res_m, res_h
    del sv_k, sl_k, sv_c, sl_c, sv_p, sl_p, fb
    free(torch)
    return out


# ---------------------------------------------------------------------------
# phase 16: the mesh on the card
# ---------------------------------------------------------------------------

P16_ROWS = 1 << 20
P16_QUERIES = 4096
P16_SHARDS = 4
P16_MUTATIONS = 64         # deletes, and as many updates, in one shard
P16_DURABLE = 1 << 17      # the durable mesh engine's rows (reduced)
P16_TAIL = 4096            # its WAL tail: the last shard's free slots
P16_DURABLE_QUERIES = 1024
P16_PQ_POOL_QUERIES = 256
P16_KEYS = {"f32": ("coarse_minima_f32_1p_sup", "refine_dots"),
            "bf16": ("coarse_minima_1p_sup", "refine_dots_bf16"),
            "int8": ("coarse_minima_int8_1p_sup", "refine_dots_int8")}


def restore_rows(store, rows, np, ids=None):
    """Load ``rows`` as ids str(i) (i from ``ids``, default 0..n-1)
    through the store's snapshot-restore path
    (VectorStore.restore_snapshot_chunk: no per-row objects, rows taken as
    the stored values), in 65536-row chunks into reserved storage."""
    n = rows.shape[0]
    ids = np.arange(n) if ids is None else ids
    store.reserve(n, rows.shape[1])
    for r0 in range(0, n, 1 << 16):
        r1 = min(r0 + (1 << 16), n)
        store.restore_snapshot_chunk(ids[r0:r1],
                                     [str(i) for i in ids[r0:r1].tolist()],
                                     rows[r0:r1], {})


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def check_ties_only(name, ids, want_ids, ora_d2, np):
    """Ids equal ``want_ids`` except at the oracle's k-th / (k+1)-th ties
    or a swap of two ids; returns how many queries differ."""
    ora_d = np.sqrt(np.maximum(ora_d2, 0.0))
    return same_answers(name, ids, np.zeros(ids.shape, np.float32),
                        want_ids, np.zeros(ids.shape, np.float32), ora_d,
                        None, np)[0]


def mesh_store_part(kind, mesh, rows, dead, qs, card, mods, rng):
    """Phase 16, part 1, for one storage: the sharded store against the
    on-card oracle and an unsharded store of the same rows; its launches
    per batch, its forced fallback, and a one-shard mutation."""
    np, torch, flat = mods["np"], mods["torch"], mods["flat"]
    cuda_kernels, Vector = mods["cuda_kernels"], mods["Vector"]
    VectorStore, ck = mods["VectorStore"], mods["ck"]
    E = mods["DistanceMetric"].EUCLIDEAN
    dev = torch.device("cuda")
    n, nq = rows.shape[0], qs.shape[0]
    shards = mesh.shape["shard"]
    coarse_key, refine_key = P16_KEYS[kind]
    stored = {"f32": lambda r: r, "bf16": flat._quantize_bf16,
              "int8": flat._quantize_int8}[kind](rows)
    sharded = VectorStore.with_sharded_flat_index(E, mesh, storage=kind)
    single = VectorStore.with_flat_index(E, storage=kind, device="cuda")
    _, load_s = timed(lambda: restore_rows(sharded, stored, np))
    restore_rows(single, stored, np)
    for store in (sharded, single):
        for i in dead:
            store.delete(str(int(i)))
    index = sharded.index
    batch = [(Vector(q), K) for q in qs]
    _, first_s = timed(lambda: sharded.search_batch(batch))
    # the path's run: only the sharded store's searches in the window
    cuda_kernels.reset_launches()
    res, batch_s = None, []
    for _ in range(2):
        res, s = timed(lambda: sharded.search_batch(batch))
        batch_s.append(s)
    counts = {k: cuda_kernels.launches[k] for k in (coarse_key, refine_key)}
    bodies = {coarse_key: check_wgmma(f"phase 16 {kind}", coarse_key,
                                      cuda_kernels),
              **check_tile_major(f"phase 16 {kind}", cuda_kernels)}
    if counts != {coarse_key: 2 * shards, refine_key: 2 * shards}:
        fail(f"phase 16 {kind}: launches in two batches {counts}: each "
             f"batch must launch {coarse_key} and {refine_key} once a "
             f"shard ({shards})")
    single.search_batch(batch)              # its device build
    res1, single_s = None, []
    for _ in range(2):
        res1, s = timed(lambda: single.search_batch(batch))
        single_s.append(s)

    queries = torch.from_numpy(qs).to(dev)
    db_t = torch.from_numpy(stored).to(dev)
    sq = (db_t * db_t).sum(1)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    valid[torch.from_numpy(dead).to(dev)] = False
    ora_d2, ora_i = oracle_sq(queries, db_t, sq, valid, K, torch)
    ids, dists = store_ids(res, np)
    ties, derr = check_exact(f"phase 16 {kind} sharded", ids, dists, ora_d2,
                             ora_i, K, np)
    ids1, dists1 = store_ids(res1, np)
    check_exact(f"phase 16 {kind} unsharded", ids1, dists1, ora_d2, ora_i,
                K, np)
    differ = check_ties_only(f"phase 16 {kind} sharded vs unsharded", ids,
                             ids1, ora_d2, np)
    dd = float(np.abs(dists - dists1)[ids == ids1].max())

    # the tier-1 certification rate (outside the window: these launches
    # are not the path's)
    with index._lock:
        state = dict(index._sync_device())
    src = "int8" if kind == "int8" else ("bf16" if kind == "bf16" else "f32")
    block = index.capacity // shards
    fn = index._sharded_search_cache[("coarse", K, index.capacity, src)]
    extra = (state["scales"],) if kind == "int8" else ()
    cert = fn(qs, state["db"], state["sq_norms"], state["norms"],
              state["valid"], state["elo_max"], *extra)[2]
    rate = float(cert.float().mean())
    # the tier-1 pipeline's time by CUDA events (3 calls back to back):
    # the sharded one (4 coarse + 4 K2 launches, the merge) beside the
    # unsharded store's over the same rows
    dev_ms, _ = cuda_time(lambda: fn(
        qs, state["db"], state["sq_norms"], state["norms"], state["valid"],
        state["elo_max"], *extra), torch)
    with single.index._lock:
        st1 = dict(single.index._sync_device())
    dev1_ms, _ = cuda_time(lambda: ck.coarse_search_1p(
        queries, st1["db"], st1["sq_norms"], st1["norms"], st1["valid"],
        st1.get("hi"), st1["elo_max"], E, K, scales=st1.get("scales")),
        torch)
    del st1

    # forced fallback: an inflated residual bound certifies nothing, so
    # every query takes the sharded exact scan
    forced = dict(state)
    forced["elo_max"] = torch.tensor(1e9, device=dev)
    if bool(fn(qs[:256], forced["db"], forced["sq_norms"], forced["norms"],
               forced["valid"], forced["elo_max"], *extra)[2].any()):
        fail(f"phase 16 {kind}: an inflated elo_max still certified")
    fd, fi = index._sharded_search(qs[:256], forced, K)
    # slots: a row's slot is its id here (loaded in order, no update yet)
    fties, _ = check_exact(f"phase 16 {kind} forced fallback",
                           np.asarray(fi)[:, :K], np.asarray(fd)[:, :K],
                           ora_d2[:256], ora_i[:256], K, np)
    del state, forced, fn

    # one shard's mutation: 64 deletes and 64 updates of ids whose slots
    # lie in shard 1; no insert (the store is full: one more row would
    # grow every shard)
    lo = block + 17
    live = [i for i in range(lo, lo + 4 * P16_MUTATIONS)
            if i not in set(dead.tolist())][:2 * P16_MUTATIONS]
    gone, moved = live[:P16_MUTATIONS], live[P16_MUTATIONS:]
    new_rows = rng.standard_normal((len(moved), D), dtype=np.float32)
    new_stored = {"f32": lambda r: r, "bf16": flat._quantize_bf16,
                  "int8": flat._quantize_int8}[kind](new_rows)
    slots_before = [index.slot_of(sharded._id_to_internal[str(i)])
                    for i in moved]
    for i in gone:
        sharded.delete(str(i))
    for i, r in zip(moved, new_rows):
        sharded.insert(str(i), Vector(r))
    slots_after = [index.slot_of(sharded._id_to_internal[str(i)])
                   for i in moved]
    kept = sum(a == b for a, b in zip(slots_before, slots_after))
    if any(not (block <= s < 2 * block) for s in slots_after):
        fail(f"phase 16 {kind}: an update left shard 1: {slots_after}")
    cuda_kernels.reset_launches()
    res_m, mut_s = timed(lambda: sharded.search_batch(batch))
    pieces = list(index.mesh_pieces_put)
    mut_counts = {k: cuda_kernels.launches[k]
                  for k in (coarse_key, refine_key)}
    if pieces != [1]:
        fail(f"phase 16 {kind}: the mutated store's search re-put pieces "
             f"{pieces}, not [1]")
    slots_t = torch.tensor(slots_after, device=dev)
    db_t[slots_t] = torch.from_numpy(new_stored).to(dev)
    sq = (db_t * db_t).sum(1)
    valid[torch.tensor(gone, device=dev)] = False
    ora_d2m, ora_im = oracle_sq(queries, db_t, sq, valid, K, torch)
    ids_m, dists_m = store_ids(res_m, np)
    slot_of = np.vectorize(
        lambda i: index.slot_of(sharded._id_to_internal[str(i)]))
    mties, _ = check_exact(f"phase 16 {kind} after the mutation",
                           slot_of(ids_m), dists_m, ora_d2m, ora_im, K, np)
    say(f"phase 16 {kind} sharded store, {shards} shards of {block} "
        f"rows on one card, N={n} ({len(dead)} deleted) Q={nq} k={K} "
        f"[{card}]: load {load_s:.3f} s (restore path); first batch "
        f"(device build) {first_s * 1e3:.3f} ms; batch "
        f"{[round(s * 1e3, 3) for s in batch_s]} ms beside the unsharded "
        f"store's {[round(s * 1e3, 3) for s in single_s]} ms; the tier-1 "
        f"pipeline by CUDA events {dev_ms:.3f} ms (unsharded "
        f"{dev1_ms:.3f} ms); exact against "
        f"the oracle ({ties} boundary ties, max dist err {derr:.3e}); "
        f"equal to the unsharded store's ids but at {differ} tied queries, "
        f"distances within {dd:.3e}; launches in two batches {counts} by "
        f"body {bodies}; tier-1 certification rate {rate:.6f} "
        f"({int(cert.sum())}/{nq}); forced fallback Q=256 exact through "
        f"the sharded exact scan ({fties} ties); mutation: "
        f"{P16_MUTATIONS} deletes + {P16_MUTATIONS} updates in shard 1 "
        f"({kept} updates kept their slot, all in shard 1), the next batch "
        f"re-put pieces {pieces} in {mut_s * 1e3:.3f} ms with launches "
        f"{mut_counts}, exact ({mties} ties)")
    out = {"counts": counts, "rate": rate, "batch_s": batch_s,
           "single_s": single_s, "first_s": first_s, "load_s": load_s,
           "ids": ids, "dev_ms": dev_ms, "dev1_ms": dev1_ms}
    del sharded, single, index, db_t, queries, sq, valid, res, res1, res_m
    free(torch)
    return out


def mesh_distributed_part(mesh, rows, qs, card, mods):
    """Phase 16, part 2: DistributedFlatIndex over the same rows, on the
    1-D mesh and on a 2-D (2 row shards x 2 batch blocks) mesh."""
    np, torch, cuda_kernels = mods["np"], mods["torch"], mods["cuda_kernels"]
    from vectordb_tpu_torch.parallel import DistributedFlatIndex, make_mesh
    E = mods["DistanceMetric"].EUCLIDEAN
    dev = torch.device("cuda")
    queries = torch.from_numpy(qs).to(dev)
    db_t = torch.from_numpy(rows).to(dev)
    valid = torch.ones(rows.shape[0], dtype=torch.bool, device=dev)
    ora_d2, ora_i = oracle_sq(queries, db_t, (db_t * db_t).sum(1), valid, K,
                              torch)
    del db_t, valid
    mesh2 = make_mesh(P16_SHARDS, ("shard", "batch"), (2, 2),
                      devices=[mesh.devices.flat[0]] * P16_SHARDS)
    out = {}
    for name, m, kw in (("1-D", mesh, {}),
                        ("2-D", mesh2, {"batch_axis": "batch"})):
        index = DistributedFlatIndex(m, E, **kw)
        _, load_s = timed(lambda: index.load(rows))
        index.search_batch(qs[:256], K)
        cuda_kernels.reset_launches()
        res, s = timed(lambda: index.search_batch(qs, K))
        counts = {k: cuda_kernels.launches[k]
                  for k in P16_KEYS["f32"]}
        check_wgmma(f"phase 16 DistributedFlatIndex {name}",
                    P16_KEYS["f32"][0], cuda_kernels)
        check_tile_major(f"phase 16 DistributedFlatIndex {name}",
                         cuda_kernels)
        if set(counts.values()) != {P16_SHARDS}:
            fail(f"phase 16 DistributedFlatIndex {name}: launches {counts}"
                 f", want {P16_SHARDS} of each")
        ids = np.array([[r[0] for r in row] for row in res])
        dists = np.array([[r[1] for r in row] for row in res], np.float32)
        ties, derr = check_exact(f"phase 16 DistributedFlatIndex {name}",
                                 ids, dists, ora_d2, ora_i, K, np)
        out[name] = {"counts": counts, "s": s, "load_s": load_s,
                     "ties": ties, "derr": derr, "mesh": m.shape}
        del index, res
        free(torch)
    say(f"phase 16 DistributedFlatIndex N={rows.shape[0]} Q={len(qs)} "
        f"k={K} [{card}]: " + "; ".join(
            f"{name} mesh {r['mesh']}: load {r['load_s']:.3f} s, batch "
            f"{r['s'] * 1e3:.3f} ms, launches {r['counts']}, exact "
            f"({r['ties']} ties, max dist err {r['derr']:.3e})"
            for name, r in out.items()))
    return out


def mesh_pq_part(mesh, p8, card, mods):
    """Phase 16, part 3: PqFlatIndex(mesh=...) over phase 8's rows (its
    generator's state), with phase 8's trained codebook imported."""
    np, torch, cuda_kernels = mods["np"], mods["torch"], mods["cuda_kernels"]
    Vector, VectorStore = mods["Vector"], mods["VectorStore"]
    from vectordb_tpu_torch.index.pq import PqFlatIndex
    from vectordb_tpu_torch.ops import pq as pq_ops
    E = mods["DistanceMetric"].EUCLIDEAN
    dev = mesh.devices.flat[0]
    rng8 = np.random.Generator(np.random.PCG64())
    rng8.bit_generator.state = p8["rng_state"]
    n, nq = p8["rows"], p8["queries"]
    rows, qs = intrinsic_rows(rng8, n, nq, np)
    dead = rng8.choice(n, 1024, replace=False)
    store = VectorStore.with_index(PqFlatIndex(E, mesh=mesh))
    index = store.index
    _, load_s = timed(lambda: restore_rows(store, rows, np))
    for i in dead:
        store.delete(str(int(i)))
    if p8.get("trained") is not None:
        index.import_trained_state(p8["trained"])
        how = "phase 8's codebook imported"
    else:
        index.train()
        how = "trained here"
    batch = [(Vector(q), K) for q in qs]
    _, first_s = timed(lambda: store.search_batch(batch))  # the encode
    cuda_kernels.reset_launches()
    res, s = timed(lambda: store.search_batch(batch, refine=64))
    k8 = cuda_kernels.launches["pq_decode"]
    k8_routes = dict(cuda_kernels.routes["pq_decode"])
    chunk = index._scan_chunk()
    block = index.capacity // P16_SHARDS
    per_shard = [block // chunk] * P16_SHARDS
    if k8 != sum(per_shard) or k8_routes["tile_ring"] != k8:
        fail(f"phase 16 PQ: K8 launches {k8} by body {k8_routes}, want "
             f"{sum(per_shard)} tile_ring ({per_shard} chunks a shard)")
    queries = torch.from_numpy(qs).to(dev)
    db_t = torch.from_numpy(rows).to(dev)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    valid[torch.from_numpy(dead).to(dev)] = False
    ora_d2, ora_i = oracle_sq(queries, db_t, (db_t * db_t).sum(1), valid, K,
                              torch)
    ids, dists = store_ids(res, np)
    true = torch.sqrt(((db_t[torch.from_numpy(ids).to(dev)]
                        - queries[:, None, :]) ** 2).sum(-1)).cpu().numpy()
    derr = np.abs(dists - true)
    if not np.all(derr <= 2e-5 * true + 1e-6):
        fail(f"phase 16 PQ: a returned distance is off its id's f32 "
             f"distance by {derr.max():.3e}")
    recall = float(np.mean([len(set(a) & set(b)) / K
                            for a, b in zip(ids, ora_i[:, :K])]))
    if recall < 0.95:
        fail(f"phase 16 PQ: recall@{K} {recall:.4f} < 0.95 at refine 64")
    # the merged pool against the unsharded scan over the same codes
    q = queries[:P16_PQ_POOL_QUERIES]
    with index._lock:
        state = dict(index._scan_state())
    scan_ms, _ = cuda_time(lambda: index._scan_call(state, queries, 64),
                           torch, iters=1)
    sv, sl = index._scan_call(state, q, 64)
    codes = torch.cat([c.to(dev) for c in state["codes"]])
    vld = torch.cat([v.to(dev) for v in state["valid"]])
    rot = index._rot_dev_arr()
    sv1, sl1 = pq_ops.pq_scan_topr(q, codes, state["codebook"][dev],
                                   state["cnorm"][dev], vld, E, r=64,
                                   chunk=chunk, rot=rot)
    sv, sl, sv1, sl1 = (t.cpu().numpy() for t in (sv, sl, sv1, sl1))
    # the same scores, in order; the slots may differ only among equal
    # scores (a tie across the pool's boundary or within it)
    differ = sum(set(a.tolist()) != set(b.tolist())
                 for a, b in zip(sl, sl1))
    if not np.array_equal(sv, sv1):
        fail(f"phase 16 PQ: the merged pool's scores differ from the "
             f"unsharded pool's by up to {np.abs(sv - sv1).max():.3e}")
    say(f"phase 16 PQ mesh: PqFlatIndex(EUCLIDEAN, mesh=...) N={n} "
        f"({len(dead)} deleted) x {D} intrinsic-dim-32 rows (phase 8's "
        f"generator), {how}, Q={nq} k={K} [{card}]: load {load_s:.3f} s; "
        f"first batch "
        f"(the encode) {first_s * 1e3:.3f} ms; batch at refine 64 "
        f"{s * 1e3:.3f} ms, its sharded scan {scan_ms:.3f} ms by CUDA "
        f"events (the rest: the host re-rank, the mesh's venue); K8 "
        f"launches {k8} by body {k8_routes} "
        f"(chunks of {chunk} rows, by shard {per_shard}); recall@{K} "
        f"{recall:.4f}; returned distances = their ids' f32 distances (max "
        f"err {derr.max():.3e}); the merged pool at Q="
        f"{P16_PQ_POOL_QUERIES} equals the unsharded pool over the same "
        f"codes but at {differ} boundary ties")
    out = {"k8": k8, "recall": recall, "s": s}
    del store, index, state, db_t, queries, codes, vld
    free(torch)
    return out


def mesh_durable_part(mesh, card, mods, rng):
    """Phase 16, part 4: a durable mesh engine; its reopen hydrates
    progressively and the first search re-puts only the tail's shard."""
    import shutil
    import tempfile
    np, torch = mods["np"], mods["torch"]
    Vector, BatchInsertItem = mods["Vector"], mods["BatchInsertItem"]
    from vectordb_tpu_torch.persistence import EngineConfig, StorageEngine
    n, tail, nq = P16_DURABLE, P16_TAIL, P16_DURABLE_QUERIES
    rows = make_rows(rng, n, D, np)
    qs = rng.standard_normal((nq, D), dtype=np.float32)
    batch = [(Vector(q), K) for q in qs]
    base = tempfile.mkdtemp(prefix="vdb_p16_")
    cfg = EngineConfig(mesh=mesh)
    try:
        t0 = time.perf_counter()
        with StorageEngine.open(base, cfg) as eng:
            for r0 in range(0, n - tail, 1 << 15):
                r1 = min(r0 + (1 << 15), n - tail)
                eng.insert_batch([BatchInsertItem(str(i), Vector(rows[i]))
                                  for i in range(r0, r1)])
            load_s = time.perf_counter() - t0
            _, ckpt_s = timed(eng.checkpoint)
            eng.insert_batch([BatchInsertItem(str(i), Vector(rows[i]))
                              for i in range(n - tail, n)])
            block = eng.store.index.capacity // P16_SHARDS
            tail_shards = sorted({eng.store.index.slot_of(
                eng.store._id_to_internal[str(i)]) // block
                for i in range(n - tail, n)})
            want = store_ids(eng.search_batch(batch), np)
            cap = eng.store.index.capacity
        eng, open_s = timed(lambda: StorageEngine.open(base, cfg))
        with eng:
            index = eng.store.index
            installed = [k for k in eng.recovery_marks
                         if k.startswith("progressive")]
            dirty = len(index._dirty_slots)
            dirty_shards = sorted({s // block for s in index._dirty_slots})
            got, first_s = timed(lambda: eng.search_batch(batch))
            pieces = list(index.mesh_pieces_put)
            if len(eng) != n or index.capacity != cap:
                fail(f"phase 16 durable: {len(eng)} rows, capacity "
                     f"{index.capacity} after the reopen ({n}, {cap})")
        if installed != ["progressive hydration finished (installed=True)"]:
            fail(f"phase 16 durable: the reopen did not install the "
                 f"progressive hydration: {list(eng.recovery_marks)}")
        if not set(pieces) <= set(tail_shards) or pieces != dirty_shards:
            fail(f"phase 16 durable: the first search re-put pieces "
                 f"{pieces}; the tail wrote shards {tail_shards}, dirty "
                 f"shards {dirty_shards}")
        ids, dists = store_ids(got, np)
        if not (np.array_equal(ids, want[0])
                and np.array_equal(dists, want[1])):
            fail("phase 16 durable: the reopened engine's answers differ "
                 "from the writer's")
    finally:
        shutil.rmtree(base, ignore_errors=True)
    say(f"phase 16 durable mesh engine N={n} ({n - tail} in the snapshot, "
        f"{tail} in the WAL tail, shards of {block} rows) Q={nq} k={K} "
        f"[{card}]: load through the WAL {load_s:.3f} s, checkpoint "
        f"{ckpt_s:.3f} s; the tail wrote shard(s) {tail_shards}; reopen "
        f"{open_s:.3f} s (progressive hydration installed; "
        f"{dirty} dirty slots, in shards {dirty_shards}); first search "
        f"{first_s * 1e3:.3f} ms re-put pieces {pieces} (the JAX "
        f"package's hydrator leaves every applied slot dirty and would "
        f"re-put all {P16_SHARDS}); answers equal to the writer's")
    free(torch)
    return {"pieces": pieces, "open_s": open_s}


def mesh_phase(args, card, mods, p8):
    """Phase 16 (module docstring). ``p8``: phase 8's generator state,
    shape and trained state (``pq_phase``). Returns the launch counts of
    its windows by kernel key."""
    np, torch = mods["np"], mods["torch"]
    from vectordb_tpu_torch.parallel import dryrun_multichip, make_mesh
    t_phase = time.perf_counter()
    rng = np.random.default_rng([args.seed, 16])
    n, nq = P16_ROWS, P16_QUERIES
    mesh = make_mesh(P16_SHARDS, devices=["cuda:0"] * P16_SHARDS)
    rows = make_rows(rng, n, D, np)
    dead = rng.choice(n, 1024, replace=False)
    qs = rng.standard_normal((nq, D), dtype=np.float32)
    stores = {kind: mesh_store_part(kind, mesh, rows, dead, qs, card, mods,
                                    rng)
              for kind in ("f32", "bf16", "int8")}
    count = torch.cuda.device_count()
    if count > 1:
        cards = min(P16_SHARDS, count)
        real = make_mesh(cards, devices=[f"cuda:{i}" for i in range(cards)])
        r = mesh_store_part("f32", real, rows, dead, qs, card, mods, rng)
        if not np.array_equal(r["ids"], stores["f32"]["ids"]):
            fail("phase 16: the mesh over real cards answers otherwise")
        say(f"phase 16 multi-card mesh over {cards} cards: the f32 store "
            f"answers as on one card")
    else:
        say("phase 16 multi-card mesh: not run (1 card)")
    dist = mesh_distributed_part(mesh, rows, qs, card, mods)
    del rows
    free(torch)
    pq = mesh_pq_part(mesh, p8, card, mods)
    durable = mesh_durable_part(mesh, card, mods, rng)
    dry, dry_s = timed(lambda: dryrun_multichip(P16_SHARDS))
    say(f"phase 16 dryrun_multichip({P16_SHARDS}) on the card in "
        f"{dry_s:.3f} s: {dry}")
    say(f"phase 16 total {time.perf_counter() - t_phase:.3f} s  [{card}]")
    counts: dict = {}
    for r in list(stores.values()) + list(dist.values()):
        for key, v in r["counts"].items():
            counts[key] = counts.get(key, 0) + v
    counts["pq_decode"] = pq["k8"]
    return counts


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=1 << 20)
    ap.add_argument("--queries", type=int, default=4096)
    ap.add_argument("--seed", type=int, default=0)
    # phase 10's writer process (this script, run by itself on the card)
    ap.add_argument("--writer", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--storage", default="f32", help=argparse.SUPPRESS)
    # phase 11's load-generating clients (this script, run by itself)
    ap.add_argument("--http-client", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.http_client:
        client_main(args)

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
    if args.writer:
        writer_main(args)
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
    from vectordb_tpu_torch.utils import profiling
    table = profiling.spans()

    def span_s(name):
        return table.get(name, {}).get("total_s", 0.0)
    say(f"phase 1 build: {time.perf_counter() - t0:.3f} s "
        f"(nvcc {span_s('vdb/kernels.build'):.3f} s, one process per "
        f"source; load {span_s('vdb/kernels.load'):.3f} s) -> "
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
    decode_bodies(np.random.default_rng([args.seed, 4]), card, np, torch,
                  cuda_kernels, worst)
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
    k2_bodies = check_tile_major("phases 3-4", cuda_kernels)
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
        f"K3 by body {k3_bodies} ({k3_big} in the 2^20-row store's tier 2); "
        f"K2 by body {k2_bodies}")
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
    check_tile_major("phase 4 forced fallback", cuda_kernels)
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
    # K2: 10 launches a reading (the call, work list included)
    ms2, dots_k = cuda_time(lambda: cuda_kernels.refine_dots(
        tidx, queries, state["db"], mp), torch, iters=10)
    ms2p, dots_p = cuda_time(lambda: ck._refine_dots_plain(
        tidx, queries, state["db"], mp), torch)
    e2 = float((dots_k - dots_p).abs().max())
    b2 = refine_bound(tidx, D, 4, torch)
    share2 = refine_sharing(tidx, cuda_kernels)
    body2 = cuda_kernels.refine_body(state["db"], queries)
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
        f"m={mp} {ms2:.3f} ms (body {body2}; plain {ms2p:.3f}, bound "
        f"{b2[0]:.3f}; {share2[0]:.3f} pairs per distinct tile, "
        f"{share2[1]:.3f} per tile read); K3 "
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
                   b2, None, body=body2, pairs_per_tile=share2[0]),
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

    # -- phase 11: serving on the card, over phase 3's store while it is
    # still loaded (run here, between phases 6 and 7) --------------------
    p11 = serving_phase(store, rows, dead, qs, ora_d2, ora_i, card,
                        dict(np=np, torch=torch, cuda_kernels=cuda_kernels,
                             Vector=Vector))
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
                   got["bf16"]["refine"][2], None,
                   body=got["bf16"]["refine_body"],
                   pairs_per_tile=got["bf16"]["refine_share"][0]),
        kernel_row("K2 refine_dots_int8 (int8 codes x pow2 scales)",
                   "refine_dots.cu", 471,
                   got["int8"]["counts"]["refine_dots_int8"],
                   worst["refine_dots_int8"], *got["int8"]["refine"][:2],
                   got["int8"]["refine"][2], None,
                   body=got["int8"]["refine_body"],
                   pairs_per_tile=got["int8"]["refine_share"][0])]
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
        kernel_row("K6 coarse_minima_1p", "coarse_wgmma.cu", 185,
                   f32["legacy"]["coarse_minima_1p"],
                   worst["coarse_minima_1p"], f32["k6"][0], f32["k6"][1],
                   f32["k6"][3], f32["k6"][2], body=f32["k6_body"],
                   mma_sync_ms=f32["k6_mma_sync_ms"]),
        kernel_row("K7 coarse_minima_int8_1p_sup", "coarse_wgmma.cu", 329,
                   got["int8"]["counts"]["coarse_minima_int8_1p_sup"],
                   worst["coarse_minima_int8_1p_sup"],
                   got["int8"]["coarse"][0], got["int8"]["coarse"][1],
                   got["int8"]["coarse"][3], got["int8"]["coarse"][2],
                   body=got["int8"]["body"])]

    # -- phase 8: PQ-Flat at full width ----------------------------------
    # phase 16 regenerates phase 8's rows from this state
    p8 = {"rng_state": rng.bit_generator.state, "rows": args.rows,
          "queries": args.queries}
    k8 = pq_phase(args, rng, card, mods)
    p8["trained"] = k8.pop("trained")
    # -- phase 9: the two-phase exact scan (K9) ---------------------------
    k9 = k9_phase(rows, qs, rng, card, mods)
    # -- phase 10: durability on the card ---------------------------------
    p10 = durability_phase(args, rows, card, mods, rate)
    # -- phase 12: HNSW ----------------------------------------------------
    p12 = hnsw_phase(args, card, mods)
    free(torch)
    # -- phase 13: the HNSW device programs (H1) -------------------------
    p13 = hnsw_device_phase(args, card, mods, p12)
    del p12
    free(torch)
    # -- phase 14: IVF-Flat ------------------------------------------------
    p14 = ivf_phase(args, card, mods)
    free(torch)
    # -- phase 15: IVF-PQ ------------------------------------------------
    p15 = ivfpq_phase(args, card, mods)
    free(torch)
    # -- phase 16: the mesh on the card ----------------------------------
    p16 = mesh_phase(args, card, mods, p8)
    table += [
        kernel_row("K8 pq_decode", "pq_decode.cu", 286, k8["launches"],
                   worst["pq_decode"], k8["ms"], k8["plain_ms"], k8["bound"],
                   k8["library_ms"], src="vectordb_tpu/ops/pq.py",
                   body="tile_ring", kernel_ms=k8["kernel_ms"],
                   ivfpq_launches=p15["launches"],
                   ivfpq_routes=p15["routes"]),
        kernel_row("K8s ivfpq_scan", "ivfpq_scan.cu", 519,
                   p15["scan_launches"], None,
                   p15["cell"]["ms"], p15["cell"]["plain_ms"],
                   p15["cell"]["bound"], None, src="vectordb_tpu/ops/pq.py",
                   body="fused", select_ms=p15["cell"]["topk_ms"],
                   topk_library_ms=p15["cell"]["lib_topk_ms"],
                   scan_ms=p15["cell"]["scan_ms"],
                   chunked_ms=p15["cell"]["chunked_ms"],
                   scan_device_ops=p15["cell"]["launches"],
                   pool_off_of_limit=p15["cell"]["pool_off"],
                   routes=p15["scan_routes"]),
        kernel_row("K9 scan_min", "scan_min.cu", 43, k9["launches"],
                   max(worst["scan_min"], k9["err"]), k9["ms"],
                   k9["plain_ms"], k9["bound"], k9["library_ms"],
                   src="vectordb_tpu/ops/flat_kernel.py")]
    h1 = p13["h1"]
    main_ef = P13_EFS[1]
    table.append(kernel_row(
        "H1 hnsw_search", "hnsw_search.cu", 75, p13["launches"], p13["err"],
        h1[main_ef]["ms"], h1[main_ef]["plain_ms"], h1[main_ef]["bound"],
        None, src="vectordb_tpu/ops/hnsw_device.py",
        shapes=[{"N": P13_ROWS, "Q": P13_QUERIES, "ef": ef, "ms": r["ms"],
                 "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
                 "bound_by": r["bound"][1], "rows_gathered": r["rows"],
                 "hops": r["hops"]} for ef, r in h1.items()]))
    # phase 10's windows (the durable stores' reopens and searches), by
    # the launch key each row's name carries
    for row in table:
        key = row["name"].split()[1]
        if key in p10:
            row["recovery_launches"] = p10[key]
        if key in p11:
            # phase 11's windows: every served search's K1 and K2
            row["serving_launches"] = p11[key]
        if p13["build"].get(key):
            # phase 13's window: the HNSW device build's searches
            row["hnsw_build_launches"] = p13["build"][key]
        ivf = sum(w.get(key, 0) for w in p14.values())
        if ivf and key != "hnsw_search":
            # phase 14's windows: IVF's exact truth and probed searches
            row["ivf_launches"] = ivf
        if p15["fallback"].get(key):
            # phase 15's fallback window: IVF-PQ's exact path (K4, K2)
            row["ivfpq_fallback_launches"] = p15["fallback"][key]
        if p16.get(key):
            # phase 16's windows: the mesh's stores, DistributedFlatIndex
            # (1-D and 2-D), the PQ mesh (4 coarse + 4 K2 a flat batch)
            row["mesh_launches"] = p16[key]
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
