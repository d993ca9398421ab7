"""Exact flat: ``VectorStore.with_flat_index(metric, ...)``; keys of the
configuration's ``store.params`` pass to ``with_flat_index`` as they are
(none: the port's defaults, exact mode and f32 rows with bf16 hi/lo
mirrors on the card). The device state is built at the first search,
which the harness's warm-up makes."""

from __future__ import annotations

from . import load


def build(config: dict, rows, ids, device):
    from vectordb_tpu_torch import DistanceMetric, VectorStore
    params = dict(config["store"].get("params", {}))
    store = VectorStore.with_flat_index(DistanceMetric(config["metric"]),
                                        device=device, **params)
    load(store, rows, ids, int(config["load_chunk"]))
    return store
