"""The comparison that decides ``correct``.

The answers judged are what the timed path returned: for each kept call,
one list of (string id, distance) a query. The reference is handed the
same rows and queries that the program was, and works out on its own,
in float64, each query's exact top-k and the distance of every row that
the program named. Three numbers come of it:

  * ``violations``: queries whose answer is malformed: not
    min(k, rows) results, an id that names no row, an id twice, or
    distances that fall;
  * ``dist_gap``: the largest gap between a returned distance and the
    float64 distance of the row it names;
  * ``recall``: the mean share of the true top-k among the returned ids.

A cell's file of limits says which of them it compares, and how
(``max`` or ``min``).
"""

from __future__ import annotations

import math

import numpy as np
import torch


def parse_answers(kept: list, per_call: int, k: int, n_rows: int):
    """Kept calls' answers -> (ids (Q, k) int64, -1 where absent; dists
    (Q, k) float64, +inf where absent; violations). ``kept`` holds one
    list of per-query result lists a call (None for a call that
    failed: its ``per_call`` queries count as violations), each result
    with ``.id`` (str(row)) and ``.distance``."""
    want = min(k, n_rows)
    rows_ids, rows_d = [], []
    violations = 0
    for call in kept:
        if call is None:
            call = [[]] * per_call
        for res in call:
            ids = np.full(k, -1, dtype=np.int64)
            dists = np.full(k, math.inf)
            bad = len(res) != want
            for j, r in enumerate(res[:k]):
                sid = r.id
                if sid.isdigit() and int(sid) < n_rows \
                        and str(int(sid)) == sid:
                    ids[j] = int(sid)
                else:
                    bad = True
                dists[j] = float(r.distance)
            got = ids[:len(res)]
            if (np.unique(got).size != got.size
                    or np.any(np.diff(dists[:len(res)]) < 0)):
                bad = True
            violations += bad
            rows_ids.append(ids)
            rows_d.append(dists)
    return np.stack(rows_ids), np.stack(rows_d), violations


def numbers(ids: np.ndarray, dists: np.ndarray, violations: int,
            queries: torch.Tensor, rows: torch.Tensor, metric: str, k: int,
            reference) -> dict:
    """The three numbers (module docstring). ``queries`` (Q, d) and
    ``rows`` (N, d) are float32 tensors on one device; ``reference`` is
    the module of the configuration's plain reference."""
    dev = rows.device
    want = min(k, rows.shape[0])
    _, ref_i = reference.topk(queries, rows, metric, want, "f64")
    idx = torch.from_numpy(ids[:, :want]).to(dev)
    true = reference.distances_of(queries, rows, idx, metric)
    got = torch.from_numpy(dists[:, :want]).to(dev)
    present = idx >= 0
    gap = torch.where(present, (got - true).abs(),
                      torch.zeros_like(true))
    finite = torch.isfinite(gap)
    dist_gap = (float(gap[finite].max()) if bool(finite.any()) else 0.0)
    if not bool(finite.all()):
        dist_gap = math.inf
    hits = (idx[:, :, None] == ref_i[:, None, :]).any(dim=2) & present
    recall = float(hits.double().sum(dim=1).mean() / want) if want else 1.0
    return {"violations": int(violations), "dist_gap": dist_gap,
            "recall": recall}


def judge(values: dict, limits: dict):
    """(correct, checks): each limited number with its limit, in the
    order of ``limits``."""
    checks = {}
    correct = True
    for name, lim in limits.items():
        v = values[name]
        if "max" in lim:
            ok = v <= lim["max"]
            checks[name] = {"value": v, "limit": lim["max"], "is": "max"}
        else:
            ok = v >= lim["min"]
            checks[name] = {"value": v, "limit": lim["min"], "is": "min"}
        correct &= bool(ok)
    return correct, checks
