#!/usr/bin/env python3
"""Drive the PyTorch port's exact flat-search path once on one CUDA card.

    python3 chip_smoke.py [--rows N] [--queries Q] [--seed S]

Phases (each prints one line; any failure exits non-zero, nothing is
caught and passed over):
  1. card (nvidia-smi name and power limit), versions, kernel build time;
  2. each hand-written kernel against its plain PyTorch version on the
     same CUDA tensors (d=768, N=2^16, Q=256, all three metrics, 10% dead
     rows), max error beside its limit (see ``limits``), and a control
     per kernel that must break the limit;
  3. the slice at full size through the public entry points:
     VectorStore.with_flat_index(EUCLIDEAN, device="cuda"), 2^20 x 768
     seeded rows through insert_batch, a Q=4096, k=10 search_batch exact
     and fast, checked against an on-card f32 chunked-matmul oracle;
  4. a 20k-row store (tier 2, kernel K3) and a forced fallback (inflated
     elo_max: tier 1 certifies nothing), both exact against the oracle;
  5. the port's HTTP server on 127.0.0.1:0: batch insert, search, batch
     search, health, metrics;
  6. each kernel against its plain version again at the main path's
     shapes (agreement within the same limits, and time by CUDA events),
     and the JSON kernel table (max_abs_err: the worst of phases 2 and 6).
The launch counters are zeroed just before the main path's run (the
store searches of phases 3 and 4, once both stores are loaded) and read
right after it, before any direct call, the fallback check or the HTTP
phase; every kernel of the path must have launched in that run. The
last line is the JSON contract line {"ok": true, "device": {...}}.
It exits non-zero without a card, and when the package is not beside it.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import urllib.request

ROOT = os.path.dirname(os.path.abspath(__file__))
D = 768
K = 10
OUT_DIR = os.path.join(ROOT, "chiprun_out")


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
    ora_d = np.sqrt(np.maximum(ora_d2, 0.0))
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


def k1_control(qThi, qrow, hi, col, inv_col, mode, ck, torch):
    """Plain K1 tile minima with every dot rounded to bf16: what a K1
    whose accumulator or output passed through bf16 would return."""
    dots = (hi.float() @ qThi.float()).to(torch.bfloat16).float()
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
        from vectordb_tpu_torch.ops import coarse_kernel as ck
        from vectordb_tpu_torch.ops import cuda_kernels, topk
        from vectordb_tpu_torch.server.app import (AppState,
                                                   start_server_background)
    except ImportError as e:
        fail(f"the vectordb_tpu_torch package is not beside this script "
             f"({e})")
    os.makedirs(OUT_DIR, exist_ok=True)
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
        f"(nvcc {info['seconds']:.3f} s) -> {os.path.relpath(info['path'], ROOT)}")
    with open(os.path.join(OUT_DIR, "kernel_build.log"), "w") as f:
        f.write(info["log"])
    rng = np.random.default_rng(args.seed)
    mode_of = {DistanceMetric.EUCLIDEAN: "euclidean",
               DistanceMetric.DOT_PRODUCT: "dot",
               DistanceMetric.COSINE: "cosine"}

    # -- phase 2: kernels against their plain versions ------------------
    n2, q2, m2 = 1 << 16, 256, 32
    worst = {"coarse_minima_1p_sup": 0.0, "coarse_minima": 0.0,
             "refine_dots": 0.0}
    for metric, mode in mode_of.items():
        db_np = make_rows(rng, n2, D, np)
        valid_np = rng.random(n2) >= 0.1
        q_np = rng.standard_normal((q2, D), dtype=np.float32)
        db = torch.from_numpy(db_np).to(dev)
        sq = (db * db).sum(1)
        valid = torch.from_numpy(valid_np).to(dev)
        queries = torch.from_numpy(q_np).to(dev)
        hi, lo = ck.split_hi_lo(db)
        qThi, qlo, qsq, qn, qrow, col, inv_col = ck._query_terms(
            queries, sq, torch.sqrt(sq), valid, mode)
        qTlo = qlo.to(torch.bfloat16)
        lim, lim2 = limits(mode, float(torch.sqrt(sq.max())),
                           float(qn.max()))

        t_k, s_k = cuda_kernels.coarse_minima_1p_sup(qThi, qrow, hi, col,
                                                     inv_col, mode)
        t_p, s_p = ck._minima_1p_sup_plain(qThi, qrow, hi, col, inv_col,
                                           mode)
        e1 = max(live_err(t_k, t_p), live_err(s_k, s_p))
        c1 = live_err(k1_control(qThi, qrow, hi, col, inv_col, mode, ck,
                                 torch), t_p)
        k3_out, k3_plain, k3 = {}, {}, {}
        for passes in (3, 1):
            k3_out[passes] = cuda_kernels.coarse_minima(
                qThi, qTlo, qrow, hi, lo, col, inv_col, passes, mode).T
            k3_plain[passes] = ck._coarse_minima_plain(
                qThi, qTlo, qrow, hi, lo, col, inv_col, passes, mode)
            k3[passes] = live_err(k3_out[passes], k3_plain[passes])
        # control: the 1-pass kernel held to the 3-pass plain version
        c3 = live_err(k3_out[1], k3_plain[3])
        tidx = torch.from_numpy(rng.integers(0, n2 // 16, (q2, m2))).to(dev)
        dots_p = ck._refine_dots_plain(tidx, queries, db, m2)
        e2 = float((cuda_kernels.refine_dots(tidx, queries, db, m2)
                    - dots_p).abs().max())
        c2 = float((ck._refine_dots_plain(tidx, to_tf32(queries, torch),
                                          to_tf32(db, torch), m2)
                    - dots_p).abs().max())
        torch.cuda.synchronize()
        say(f"phase 2 {metric.value}: K1 max_abs_err {e1:.3e} (control, "
            f"dots rounded to bf16: {c1:.3e}), K3 3-pass {k3[3]:.3e} "
            f"(control, 1-pass kernel: {c3:.3e}), K3 1-pass {k3[1]:.3e}; "
            f"coarse limit {lim:.3e}; K2 {e2:.3e} (control, TF32 operands: "
            f"{c2:.3e}), limit {lim2:.3e}  [{card}]")
        if not (e1 <= lim and k3[1] <= lim and k3[3] <= lim
                and e2 <= lim2):
            fail(f"kernel disagrees with its plain version ({metric.value})")
        if not (c1 > lim and c3 > lim and c2 > lim2):
            fail(f"a control passed its limit ({metric.value}): the limits "
                 f"cannot tell a sound kernel from a broken one")
        worst["coarse_minima_1p_sup"] = max(worst["coarse_minima_1p_sup"],
                                            e1)
        worst["coarse_minima"] = max(worst["coarse_minima"], k3[1], k3[3])
        worst["refine_dots"] = max(worst["refine_dots"], e2)
        del k3_out, k3_plain, dots_p
        del db, hi, lo, t_k, s_k, t_p, s_p

    # -- phase 3: the slice at full size through the entry points -------
    n, nq = args.rows, args.queries
    if n != 1 << 20 or nq != 4096:
        say(f"NOTE: reduced run: rows {n}, queries {nq} (full size is "
            f"1048576 x 768, Q=4096)")
    store = VectorStore.with_flat_index(DistanceMetric.EUCLIDEAN,
                                        device="cuda")
    t0 = time.perf_counter()
    rows = make_rows(rng, n, D, np)
    step = 1 << 16
    for r0 in range(0, n, step):
        store.insert_batch([BatchInsertItem(str(i), Vector(rows[i]))
                            for i in range(r0, min(r0 + step, n))])
    dead = rng.choice(n, n // 1024, replace=False)
    for i in dead:
        store.delete(str(int(i)))
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
    say(f"launch counts (main path: the store searches of phases 3 and 4): "
        f"{counts}")
    if min(counts.values()) < 1:
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
    fties, _ = check_exact("forced fallback", fi[:, :K], fd[:, :K],
                           ora_d2[:256], ora_i[:256], K, np)
    say(f"phase 4 small store 20000 x {D} (tier 2) Q=1024 exact "
        f"({sties} ties) in {small_s * 1e3:.3f} ms, K3 launches {k3_small};"
        f" forced fallback Q=256 certified 0/256 in tier 1, exact after "
        f"fallback ({fties} ties)  [{card}]")

    # -- phase 5: HTTP -------------------------------------------------
    hstore = VectorStore.with_flat_index(DistanceMetric.EUCLIDEAN,
                                         device="cuda")
    server, thread = start_server_background("127.0.0.1:0",
                                             AppState(hstore))
    port = server.server_address[1]

    def call(method, path, body=None):
        data = None if body is None else json.dumps(body).encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}{path}", data=data, method=method,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())

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
    mp2, mp = ck._exact1p_pool(K, n // 16)
    tidx, _ = ck._select_tiles_1p(tile_tq, sup_tq, nq, n // 16, mp2, mp)
    del tile_tq, sup_tq
    ms2, dots_k = cuda_time(lambda: cuda_kernels.refine_dots(
        tidx, queries, state["db"], mp), torch)
    ms2p, dots_p = cuda_time(lambda: ck._refine_dots_plain(
        tidx, queries, state["db"], mp), torch)
    e2 = float((dots_k - dots_p).abs().max())
    sq1024 = queries[:1024]
    sThi, slo, _, sqn, sqrow, scol, sinv = ck._query_terms(
        sq1024, sstate["sq_norms"], sstate["norms"], sstate["valid"], mode)
    sTlo = slo.to(torch.bfloat16)
    slim, _ = limits(mode, float(torch.sqrt(sstate["sq_norms"].max())),
                     float(sqn.max()))
    ms3, min_k = cuda_time(lambda: cuda_kernels.coarse_minima(
        sThi, sTlo, sqrow, sstate["hi"], sstate["lo"], scol, sinv, 3, mode),
        torch)
    ms3p, min_p = cuda_time(lambda: ck._coarse_minima_plain(
        sThi, sTlo, sqrow, sstate["hi"], sstate["lo"], scol, sinv, 3, mode),
        torch)
    e3 = live_err(min_k.T, min_p)
    c3 = live_err(cuda_kernels.coarse_minima(
        sThi, sTlo, sqrow, sstate["hi"], sstate["lo"], scol, sinv, 1,
        mode).T, min_p)
    say(f"phase 6 agreement at the main path's shapes: K1 {e1:.3e} (limit "
        f"{lim:.3e}); K2 {e2:.3e} (limit {lim2:.3e}); K3 3-pass {e3:.3e} "
        f"(limit {slim:.3e}; control, 1-pass kernel: {c3:.3e})  [{card}]")
    if not (e1 <= lim and e2 <= lim2 and e3 <= slim):
        fail("kernel disagrees with its plain version at the main path's "
             "shapes")
    if not c3 > slim:
        fail("the 1-pass control passed the K3 limit at the main path's "
             "shapes")
    worst["coarse_minima_1p_sup"] = max(worst["coarse_minima_1p_sup"], e1)
    worst["refine_dots"] = max(worst["refine_dots"], e2)
    worst["coarse_minima"] = max(worst["coarse_minima"], e3)
    _, _, cert = ck.coarse_search_1p(queries, state["db"],
                                     state["sq_norms"], state["norms"],
                                     state["valid"], state["hi"],
                                     state["elo_max"],
                                     DistanceMetric.EUCLIDEAN, K)
    rate = float(cert.float().mean())
    say(f"phase 6 times [{card}]: K1 N={n} Q={nq} {ms1:.3f} ms (plain "
        f"{ms1p:.3f}); K2 Q={nq} m={mp} {ms2:.3f} ms (plain {ms2p:.3f}); "
        f"K3 3-pass N={sstate['db'].shape[0]} Q=1024 {ms3:.3f} ms (plain "
        f"{ms3p:.3f}); tier-1 certification rate {rate:.6f} "
        f"({int(cert.sum())}/{nq})")
    if "jax" in sys.modules:
        fail("jax was imported")

    src = "vectordb_tpu/ops/coarse_kernel.py"
    table = {"kernels": [
        {"name": "K1 coarse_minima_1p_sup", "route": "cuda",
         "source": "vectordb_tpu_torch/csrc/coarse_minima.cu",
         "replaces": f"{src}:261", "launches": counts["coarse_minima_1p_sup"],
         "max_abs_err": worst["coarse_minima_1p_sup"], "ms": ms1,
         "plain_ms": ms1p},
        {"name": "K2 refine_dots", "route": "cuda",
         "source": "vectordb_tpu_torch/csrc/refine_dots.cu",
         "replaces": f"{src}:471", "launches": counts["refine_dots"],
         "max_abs_err": worst["refine_dots"], "ms": ms2, "plain_ms": ms2p},
        {"name": "K3 coarse_minima", "route": "cuda",
         "source": "vectordb_tpu_torch/csrc/coarse_minima.cu",
         "replaces": f"{src}:96", "launches": counts["coarse_minima"],
         "max_abs_err": worst["coarse_minima"], "ms": ms3,
         "plain_ms": ms3p},
    ]}
    say(json.dumps(table))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
