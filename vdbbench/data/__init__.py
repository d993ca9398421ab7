"""Generators of rows and queries, one module a kind, found by the
``generator`` key of a configuration's ``data``."""

from __future__ import annotations

import torch


def inputs(conf: dict, nq: int, seed: int, device):
    """(rows (n, d), queries (nq, d)): float32 tensors on ``device``.

    The corpus and its query set are one fixed dataset, made by the
    configuration's generator from the data's own ``seed``, as a public
    benchmark's dataset is fixed. The run's ``seed`` draws the order in
    which the queries are sent, and so which calls are kept and checked:
    every seed makes the same work, of the same difficulty."""
    from ..manifest import load_module
    data = conf["data"]
    gen = load_module("data", data["generator"])
    rows, queries = gen.make(int(data["seed"]), int(conf["rows"]),
                             int(conf["dim"]), nq, data, device)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    order = torch.randperm(nq, generator=g, device=device)
    return rows, queries[order]
