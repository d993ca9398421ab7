"""IVF-PQ: ``VectorStore.with_index(IvfPqIndex(metric, ...))``; keys of
the configuration's ``store.params`` pass to ``IvfPqIndex`` as they are
(none: the port's own defaults). The index trains at its first search,
which the harness's warm-up makes."""

from __future__ import annotations

from . import load


def build(config: dict, rows, ids, device):
    from vectordb_tpu_torch import DistanceMetric, IvfPqIndex, VectorStore
    params = dict(config["store"].get("params", {}))
    store = VectorStore.with_index(
        IvfPqIndex(DistanceMetric(config["metric"]), device=device,
                   **params))
    load(store, rows, ids, int(config["load_chunk"]))
    return store
