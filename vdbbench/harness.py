"""One run of one cell: set-up, the measured window, the check, the
metrics. ``__main__`` adds the look for a card and the printing; tests call
``run`` on the CPU with tiny cells."""

from __future__ import annotations

import gc
import sys
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from . import compare
from .data import inputs
from .manifest import Cell, load_module
from .stores import batches
from .trace import Trace, from_profiler

FORBIDDEN = ("jax", "jaxlib", "flax", "vectordb_tpu")
# The traced run's window: its first seconds only. A whole window of a
# launch-heavy cell holds millions of profiler events; the per-layer
# metrics are per call, and ``window_s`` reports the traced length.
TRACE_SECONDS = 10.0


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (``vectordb_tpu_torch`` is not ``vectordb_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


@dataclass
class Record:
    """What the metric readers see of one run."""
    cell: Cell
    window: object                 # drivers.<driver>.Window
    setup_s: float
    numbers: dict                  # compare.numbers
    trace: Optional[Trace]


def _cpu_clock() -> tuple:
    """(this process's CPU seconds, the host's /proc/stat cpu jiffies by
    field), for the window's notes."""
    try:
        with open("/proc/stat") as f:
            jiffies = [int(x) for x in f.readline().split()[1:]]
    except (OSError, ValueError):
        jiffies = []
    return time.process_time(), jiffies


def window_notes(win, before: tuple, after: tuple) -> dict:
    """Diagnostics of the window's steadiness, for standard error: the
    rate in each quarter of the calls, latency quantiles in ms, the calls
    slower than twice the median, this process's CPU time over the
    window's wall time, and the machine's share of CPU time stolen by
    its host (/proc/stat)."""
    lat = win.latencies
    quarters = np.array_split(lat, 4)
    per_call = win.queries / max(win.calls, 1)
    q = np.percentile(lat, [5, 50, 95, 100]) * 1e3
    return {"quarter_qps": [per_call * len(x) / x.sum() for x in quarters
                            if len(x)],
            "ms_p5_p50_p95_max": q.tolist(),
            "slow_calls": int((lat > 2 * np.median(lat)).sum()),
            "cpu_over_wall": (after[0] - before[0]) / (win.end - win.start),
            "steal_share": _steal(before[1], after[1])}


def _steal(j0: list, j1: list):
    if len(j0) < 8 or len(j1) < 8:
        return None
    d = [b - a for a, b in zip(j0, j1)]
    return d[7] / sum(d) if sum(d) else None


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: str,
        t_start: float) -> dict:
    """One run (see the module docstring); ``t_start`` is the
    ``time.perf_counter`` reading at which set-up began. Returns the
    result's fields."""
    dev = torch.device(device)
    conf, traf = cell.config, cell.traffic
    n, metric = int(conf["rows"]), conf["metric"]
    per_call, k = int(traf["queries_per_call"]), int(traf["k"])
    pool_calls, keep = int(traf["pool_calls"]), int(traf["kept_calls"])

    # -- set-up: data on the card, one copy to the host, the store --------
    marks = {"imports": time.perf_counter() - t_start}

    def mark(name: str) -> None:
        marks[name] = time.perf_counter() - t_start - sum(marks.values())

    rows, queries = inputs(conf, pool_calls * per_call, seed, dev)
    rows_h, queries_h = rows.cpu().numpy(), queries.cpu().numpy()
    del rows, queries
    mark("data")
    maker = load_module("stores", conf["store"]["kind"])
    store = maker.build(conf, rows_h, [str(i) for i in range(n)], device)
    pool = batches(queries_h, per_call, k)
    search = store.search_batch
    mark("load")
    for i in range(int(traf["warmup_calls"])):
        search(pool[i % pool_calls])
        _sync(dev)
        if i == 0:
            mark("first_call")
    mark("warmup_rest")
    gc.collect()
    mark("gc")
    setup_s = time.perf_counter() - t_start

    # -- the window ---------------------------------------------------------
    # The deployment's search threads (``search_threads``: torch's
    # intra-op pool) hold in the window only; set-up runs with the
    # process's default.
    driver = load_module("drivers", traf["driver"])
    prof = None
    threads = torch.get_num_threads()
    torch.set_num_threads(int(conf.get("search_threads", threads)))
    clock0 = _cpu_clock()
    try:
        if trace:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if dev.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            with torch.profiler.profile(activities=acts) as prof:
                win = driver.run(search, pool, min(seconds, TRACE_SECONDS),
                                 keep)
        else:
            win = driver.run(search, pool, seconds, keep)
        _sync(dev)
        clock1 = _cpu_clock()
    finally:
        torch.set_num_threads(threads)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)

    # -- after the window: free the program, read the trace, check --------
    del search, store, pool
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    tr = None
    if prof is not None:
        tr, kinds = from_profiler(prof, driver.CALL_RANGE)
        del prof
    ids, dists, violations = compare.parse_answers(win.kept, per_call, k, n)
    reference = load_module("references", conf["reference"])
    rows_t = torch.from_numpy(rows_h).to(dev)
    q_t = torch.from_numpy(queries_h[:keep * per_call]).to(dev)
    nums = compare.numbers(ids, dists, violations, q_t, rows_t, metric, k,
                           reference)
    del rows_t, q_t
    correct, checks = compare.judge(nums, cell.limits)
    correct &= win.failed == 0

    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    rec = Record(cell, win, setup_s, nums, tr)
    metrics = {}
    for m in cell.metrics("per_layer" if trace else "end_to_end"):
        value = load_module("metrics", m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device_info = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                   "kind": name, "count": cell.chips,
                   "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": win.calls,
           "failed": win.failed, "metrics": metrics, "device": device_info}
    if tr is not None:
        device_info["busy_s"] = tr.busy_s
        device_info["window_s"] = tr.window_s
        out["breakdown"] = tr.breakdown()
        out["_trace_notes"] = {"ops": len(tr.ops),
                               "unlinked_ops": tr.unlinked_ops,
                               "calls": tr.calls, "events": kinds}
    out["_errors"] = win.errors
    out["_setup"] = marks
    out["_window"] = window_notes(win, clock0, clock1)
    out["checks"] = checks
    return out
