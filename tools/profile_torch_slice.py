#!/usr/bin/env python3
"""Profile the PyTorch port's exact and fast search batches on one CUDA card.

    python3 tools/profile_torch_slice.py [--rows N] [--queries Q] [--runs R]
                                         [--seed S]

Builds the slice that chip_smoke.py drives (VectorStore.with_flat_index(
EUCLIDEAN, device="cuda"), N x 768 seeded N(0,1) rows through insert_batch,
N/1024 of them deleted), runs one warm-up batch (it builds the device
state), and prints, each line with the card's nvidia-smi name and power
limit:
  1. the host-clock ms of R exact search_batch calls (Q queries, k=10) with
     the garbage collector on, then of R more after gc.freeze();
  2. one exact and one fast batch under torch.profiler (gc still frozen):
     the wall ms of the call, the device-busy ms (the union of the time
     intervals of the kernels, copies and memsets), the idle share
     1 - busy / wall, the CPU spans with the most self time, and the
     device kernels with the most time.
The traces are written to chiprun_out/profile_{exact,fast}.json. It exits
non-zero without a card, or when the profiler records no device event.
"""

from __future__ import annotations

import argparse
import gc
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_DIR = os.path.join(ROOT, "chiprun_out")
K = 10


def device_events(events, torch):
    """Kernels, copies and memsets on the card: device events other than
    the device-side copies of record_function spans."""
    return [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def busy_ms(events) -> float:
    """Union of the [start, end] intervals of ``events``, in ms."""
    iv = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in iv:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3


def profile_batch(store, batch, name, card, torch) -> None:
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        store.search_batch(batch)
        wall = (time.perf_counter() - t0) * 1e3
    prof.export_chrome_trace(os.path.join(OUT_DIR, f"profile_{name}.json"))
    events = device_events(prof.events(), torch)
    busy = busy_ms(events)
    if busy == 0.0:
        sys.exit(f"FAIL: the profiler recorded no device event ({name})")
    print(f"{name} batch: wall {wall} ms, device busy {busy} ms, idle share "
          f"{1.0 - busy / wall}  [{card}]", flush=True)
    cpu = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total,
                 reverse=True)[:8]
    print(f"{name} top CPU self time (ms): "
          + "; ".join(f"{e.key} {e.self_cpu_time_total / 1e3}" for e in cpu),
          flush=True)
    dev: dict = {}
    for e in events:
        dev[e.name] = (dev.get(e.name, 0.0)
                       + (e.time_range.end - e.time_range.start) / 1e3)
    top = sorted(dev.items(), key=lambda kv: kv[1], reverse=True)[:8]
    print(f"{name} top device time (ms): "
          + "; ".join(f"{k[:60]} {v}" for k, v in top), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=1 << 20)
    ap.add_argument("--queries", type=int, default=4096)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("FAIL: torch.cuda.is_available() is False")
    sys.path.insert(0, ROOT)
    from chip_smoke import card_line, make_rows
    from vectordb_tpu_torch import (BatchInsertItem, DistanceMetric, Vector,
                                    VectorStore)
    os.makedirs(OUT_DIR, exist_ok=True)
    card = card_line()
    d, n = 768, args.rows
    rng = np.random.default_rng(args.seed)
    store = VectorStore.with_flat_index(DistanceMetric.EUCLIDEAN,
                                        device="cuda")
    rows = make_rows(rng, n, d, np)
    for r0 in range(0, n, 1 << 16):
        store.insert_batch([BatchInsertItem(str(i), Vector(rows[i]))
                            for i in range(r0, min(r0 + (1 << 16), n))])
    for i in rng.choice(n, n // 1024, replace=False):
        store.delete(str(int(i)))
    qs = rng.standard_normal((args.queries, d), dtype=np.float32)
    batch = [(Vector(q), K) for q in qs]
    store.search_batch(batch)            # builds the device state
    print(f"slice: {len(store)} live rows x {d}, Q={args.queries}, k={K}",
          flush=True)

    for label in ("gc on", "gc.freeze()"):
        if label == "gc.freeze()":
            gc.freeze()
        ms = []
        for _ in range(args.runs):
            t0 = time.perf_counter()
            store.search_batch(batch)
            ms.append((time.perf_counter() - t0) * 1e3)
        print(f"exact batch ms, {label}: {ms}  [{card}]", flush=True)

    profile_batch(store, batch, "exact", card, torch)
    store.index.search_mode = "fast"
    store.search_batch(batch)
    profile_batch(store, batch, "fast", card, torch)


if __name__ == "__main__":
    main()
