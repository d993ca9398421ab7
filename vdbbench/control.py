"""The readings that a cell's limits are set from; not run by the
benchmark's own runs.

``python3 -m vdbbench.control --workload <name> --seeds 1,2,3 [--program]``

For each seed it makes the cell's rows and query pool as a run does, and
reads the comparison's numbers (``compare.numbers``) for the queries of
the calls that a run keeps:

  * ``control``: the plain reference in the program's place, computed in
    TF32 (the precision below the configuration's float32 with TF32 off);
    it has to come out as not correct;
  * ``program`` (with ``--program``): the store built and warmed up as a
    run builds it, and ``search_batch`` called on the kept calls' batches,
    the window's own entry at its own sizes;
  * ``fault:<name>`` (with ``--program``): the program's answers with one
    of ``FAULTS`` planted where they are produced.

One JSON line a seed and side, on standard output.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from . import compare
from .data import inputs
from .manifest import Cell, load_manifest, load_module
from .stores import batches


def stale(res, state):
    """A state that never moves on: every call answers as the first."""
    return state.setdefault("first", res)


def half(res, state):
    """Half of the batch left out: its queries answered by the rest."""
    n = len(res) // 2
    return res[:n] + res[:len(res) - n]


def altered(res, state):
    """One answer altered where it is produced: the first result's id
    names another row (the next one)."""
    first = res[0][0]
    rows = state.get("rows", 1 << 62)
    res = list(res)
    res[0] = [type(first)(id=str((int(first.id) + 1) % rows),
                          distance=first.distance)] + list(res[0][1:])
    return res


FAULTS = {"stale": stale, "half": half, "altered": altered}


def _program_answers(cell: Cell, rows_h, queries_h, device: str):
    conf, traf = cell.config, cell.traffic
    per_call, k = int(traf["queries_per_call"]), int(traf["k"])
    maker = load_module("stores", conf["store"]["kind"])
    store = maker.build(conf, rows_h, [str(i) for i in range(len(rows_h))],
                          device)
    pool = batches(queries_h, per_call, k)
    for i in range(int(traf["warmup_calls"])):
        store.search_batch(pool[i % len(pool)])
    kept = [store.search_batch(pool[i])
            for i in range(int(traf["kept_calls"]))]
    del store, pool
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    return kept


def readings(cell: Cell, seed: int, device: str, program: bool) -> dict:
    """{side: numbers} for one seed (module docstring)."""
    dev = torch.device(device)
    conf, traf = cell.config, cell.traffic
    n, metric = int(conf["rows"]), conf["metric"]
    per_call, k = int(traf["queries_per_call"]), int(traf["k"])
    keep = int(traf["kept_calls"])
    rows, queries = inputs(conf, int(traf["pool_calls"]) * per_call, seed,
                           dev)
    rows_h, queries_h = rows.cpu().numpy(), queries.cpu().numpy()
    del rows, queries
    reference = load_module("references", conf["reference"])
    out = {}
    if program:
        kept = _program_answers(cell, rows_h, queries_h, device)
        ids, dists, bad = compare.parse_answers(kept, per_call, k, n)
        rows_t = torch.from_numpy(rows_h).to(dev)
        q_t = torch.from_numpy(queries_h[:keep * per_call]).to(dev)
        out["program"] = compare.numbers(ids, dists, bad, q_t, rows_t,
                                         metric, k, reference)
        for name, fault in FAULTS.items():
            state = {"rows": n}
            broken = [fault(call, state) for call in kept]
            ids, dists, bad = compare.parse_answers(broken, per_call, k, n)
            out[f"fault:{name}"] = compare.numbers(
                ids, dists, bad, q_t, rows_t, metric, k, reference)
    else:
        rows_t = torch.from_numpy(rows_h).to(dev)
        q_t = torch.from_numpy(queries_h[:keep * per_call]).to(dev)
    want = min(k, n)
    cd, ci = reference.topk(q_t, rows_t, metric, want, "tf32")
    out["control"] = compare.numbers(
        ci.cpu().numpy(), cd.double().cpu().numpy(), 0, q_t, rows_t, metric,
        k, reference)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m vdbbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--program", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("vdbbench.control: no CUDA card", file=sys.stderr)
        return 3
    cell = Cell(args.workload, load_manifest())
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        got = readings(cell, seed, "cuda", args.program)
        for side, nums in got.items():
            correct, _ = compare.judge(nums, cell.limits)
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "side": side, "correct": correct, **nums,
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
