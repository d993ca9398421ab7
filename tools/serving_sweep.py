#!/usr/bin/env python3
"""Read the native front end's depth and merge windows on the card.

    python3 tools/serving_sweep.py [--rows N] [--queries Q] [--seed S]
                                   [--depths 1,2,3] [--clients 64,256,512]
                                   [--reps 2]

Loads a seeded N x 768 f32 flat store on the card (``chip_smoke.py``
phase 3's rows), then serves it with ``serve(..., backend="native")`` at
each VDB_HTTP_DEPTH, each client count and the merge windows on (the
``native_http`` module's constants) and off (every window 0), in turns,
each for ``chip_smoke.P11_SECONDS`` under closed-loop clients in child
processes (``chip_smoke.py --http-client``), the whole sweep ``--reps``
times over; every 8th answer is held to an on-card f32 oracle. One line
per setting: requests/s, p50 and p99 latency, mean requests per drained
batch; the card's name and power limit first; the readings also go to
serving_sweep.json in ``chip_smoke.OUT_DIR``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=1 << 20)
    ap.add_argument("--queries", type=int, default=4096)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--depths", default="1,2,3")
    ap.add_argument("--clients", default="64,256,512")
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        cs.fail("this script needs a card")
    from vectordb_tpu_torch import (BatchInsertItem, DistanceMetric, Vector,
                                    VectorStore)
    from vectordb_tpu_torch.server import native_http
    card = cs.card_line()
    cs.say(f"card: {card}")
    rng = np.random.default_rng(args.seed)
    rows = cs.make_rows(rng, args.rows, cs.D, np)
    dead = rng.choice(args.rows, args.rows // 1024, replace=False)
    store = VectorStore.with_flat_index(DistanceMetric.EUCLIDEAN,
                                        device="cuda")
    t0 = time.perf_counter()
    cs.load_store(store, rows, dead, BatchInsertItem, Vector)
    qs = rng.standard_normal((args.queries, cs.D), dtype=np.float32)
    store.search_batch([(Vector(q), cs.K) for q in qs[:64]])
    with store.index._lock:
        state = dict(store.index._sync_device())
    ora_d2, ora_i = cs.oracle_sq(torch.from_numpy(qs).cuda(), state["db"],
                                 state["sq_norms"], state["valid"], cs.K,
                                 torch)
    del state
    cs.say(f"store {args.rows} x {cs.D} f32 loaded in "
           f"{time.perf_counter() - t0:.3f} s (host)")
    on = {k: getattr(native_http, k) for k in
          ("STRAGGLER_MAX", "PIPELINED_MIN", "PIPELINED_MAX")}
    off = dict.fromkeys(on, 0.0)
    import tempfile
    tmp = tempfile.mkdtemp(prefix="vdb_sweep_")
    qfile = os.path.join(tmp, "queries.npy")
    np.save(qfile, qs)
    readings = []
    try:
        settings = [(c, d, w) for _ in range(args.reps)
                    for c in [int(x) for x in args.clients.split(",")]
                    for d in [int(x) for x in args.depths.split(",")]
                    for w in ("on", "off")]
        for clients, depth, name in settings:
            for k, v in (on if name == "on" else off).items():
                setattr(native_http, k, v)
            os.environ["VDB_HTTP_DEPTH"] = str(depth)
            st, thread = cs.serve_thread(store, backend="native")
            try:
                rps, p50, p99, samples = cs.load_run(
                    st.server.port, clients, qfile, tmp, len(readings) * 131)
                drains = list(st.server.drain_sizes)
            finally:
                cs.stop_server(st, thread)
            ties, _ = cs.check_samples(
                f"depth {depth} clients {clients} windows {name}", samples,
                ora_d2, ora_i, np)
            r = {"depth": depth, "clients": clients, "windows": name,
                 "rps": rps, "p50_ms": p50, "p99_ms": p99,
                 "mean_drain": float(np.mean(drains)),
                 "sampled": len(samples), "ties": ties}
            readings.append(r)
            cs.say(f"depth {depth} clients {clients} windows {name}: "
                   f"{rps:.1f} req/s, p50 {p50:.3f} ms, p99 {p99:.3f} ms, "
                   f"mean drained batch {r['mean_drain']:.2f} "
                   f"({len(samples)} sampled answers exact)  [{card}]")
    finally:
        for k, v in on.items():
            setattr(native_http, k, v)
        os.environ.pop("VDB_HTTP_DEPTH", None)
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    with open(os.path.join(cs.OUT_DIR, "serving_sweep.json"), "w") as f:
        json.dump({"card": card, "rows": args.rows, "readings": readings},
                  f, indent=1)


if __name__ == "__main__":
    main()
