"""The columnar hit hand-off from index to store on the CPU.

The flat and IVF-PQ collects hand the store HitColumns ((Q, w) internal
ids, distances, per-query counts); the store maps a whole call with one
gather from its id column. Each case holds that column path to the tuple
path it replaces, hit for hit: the index handle's ``collect()`` rows
mapped one at a time by ``VectorStore._map_results``. The slot mapping
itself is held to an element-by-element reading, and the counter
``store.columnar_queries`` to the queries that took the column path."""

import numpy as np
import pytest
import torch

from vectordb_tpu_torch import (DistanceMetric, HnswIndex, HnswParams,
                                IvfPqIndex, PqFlatIndex, Vector,
                                VectorStore)
from vectordb_tpu_torch.index.flat import FlatIndex, _slots_to_ids
from vectordb_tpu_torch.ops import topk as ttopk
from vectordb_tpu_torch.parallel import make_mesh
from vectordb_tpu_torch.store import BatchInsertItem
from vectordb_tpu_torch.utils import profiling

torch.set_num_threads(1)
EUC = DistanceMetric.EUCLIDEAN
N, D, NQ, K = 600, 16, 12, 10


@pytest.fixture(autouse=True)
def _ladder(monkeypatch):
    monkeypatch.setattr(ttopk, "_EXACT1P_MIN_N", 512)
    profiling.reset_spans()
    yield
    profiling.reset_spans()


def _rows(n=N, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((16, D)).astype(np.float32)
    return (centers[rng.integers(0, 16, n)]
            + 0.2 * rng.standard_normal((n, D)).astype(np.float32))


def _ivfpq():
    return IvfPqIndex(EUC, nlist=8, m=4, ksub=16, refine=32,
                      rerank="device", device="cpu")


def _fill(store, rows):
    store.insert_batch([BatchInsertItem(f"r{i}", Vector(r))
                        for i, r in enumerate(rows)])


def _flat_store(rows):
    store = VectorStore.with_flat_index(EUC, device="cpu")
    _fill(store, rows)
    return store


def _ivfpq_store(rows):
    store = VectorStore.with_index(_ivfpq())
    _fill(store, rows)
    store.index.train()
    return store


def _restored_store(rows):
    # the engine's recovery path: ids by one vectorized chunk at a time
    store = VectorStore.with_flat_index(EUC, device="cpu")
    store.reserve(len(rows), D)
    for lo in range(0, len(rows), 256):
        hi = min(lo + 256, len(rows))
        store.restore_snapshot_chunk(np.arange(lo, hi) * 3 + 1,
                                     [f"s{i}" for i in range(lo, hi)],
                                     rows[lo:hi], {})
    return store


def _adopted_store(rows):
    # an index filled out of band, then the store's maps rebuilt around it
    index = FlatIndex(EUC, device="cpu")
    iids = [5 * i + 2 for i in range(len(rows))]
    index.add_batch([(iid, Vector(r)) for iid, r in zip(iids, rows)])
    store = VectorStore(index)
    store.adopt_index_state({iid: f"a{iid}" for iid in iids}, {},
                            next_id=iids[-1] + 1, dimension=D)
    return store


def _mesh_store(rows):
    store = VectorStore.with_sharded_flat_index(
        EUC, make_mesh(4, devices=["cpu"] * 4))
    _fill(store, rows)
    return store


def _delete_hits(store, queries):
    # remove every top hit of the first queries: their rows are in the
    # device snapshot, so only the frozen column can still name them
    for q, _ in queries[:4]:
        for r in store.search(q, 2):
            if store.get(r.id) is not None:
                store.delete(r.id)


def _upsert_hits(store, queries):
    for q, _ in queries[:4]:
        for r in store.search(q, 2):
            store.insert(r.id, Vector(np.full(D, 50.0, np.float32)))


def _empty(store, queries):
    for sid in store.list_ids():
        store.delete(sid)


# name -> (store maker, per-query k, mutation before submit, mutation
# between submit and collect)
CASES = {
    "flat": (_flat_store, [K] * NQ, None, None),
    "flat-mixed-k": (_flat_store, [1, 3, 10, 25, 7, 1, 64, 2, 10, 5, 40,
                                    9], None, None),
    "flat-k-past-rows": (_flat_store, [N + 50, 3] * (NQ // 2), None, None),
    "flat-delete-in-flight": (_flat_store, [K] * NQ, None, _delete_hits),
    "flat-upsert-in-flight": (_flat_store, [K] * NQ, None, _upsert_hits),
    "flat-empty": (_flat_store, [K] * NQ, _empty, None),
    "flat-restored": (_restored_store, [4, 20, 10] * (NQ // 3), None,
                      _delete_hits),
    "flat-adopted": (_adopted_store, [K] * NQ, None, _upsert_hits),
    "flat-mesh": (_mesh_store, [2, 10, 30] * (NQ // 3), None, None),
    "ivfpq": (_ivfpq_store, [K] * NQ, None, None),
    "ivfpq-mixed-k": (_ivfpq_store, [1, 3, 10, 25, 7, 1, 30, 2, 10, 5, 30,
                                      9], None, None),
    "ivfpq-delete-in-flight": (_ivfpq_store, [K] * NQ, None, _delete_hits),
    "ivfpq-upsert-in-flight": (_ivfpq_store, [K] * NQ, None, _upsert_hits),
    "ivfpq-empty": (_ivfpq_store, [K] * NQ, _empty, None),
}


def _spy(store, monkeypatch):
    """Record the index handle each submit returns and the id column each
    column-path collect maps through."""
    seen = {}
    submit = store.index.search_batch_submit
    map_columns = store._map_columns

    def spy_submit(queries, k):
        seen["handle"] = submit(queries, k)
        return seen["handle"]

    def spy_map(hits, ks, id_map=None):
        seen["id_map"] = id_map
        return map_columns(hits, ks, id_map)

    monkeypatch.setattr(store.index, "search_batch_submit", spy_submit)
    monkeypatch.setattr(store, "_map_columns", spy_map)
    return seen


def _slot_case(seed):
    rng = np.random.default_rng(seed)
    q, w, cap = 8, 12, 64
    dists = np.sort(rng.standard_normal((q, w)).astype(np.float32), axis=1)
    cut = rng.integers(0, w + 1, q)
    dists[np.arange(w) >= cut[:, None]] = np.inf
    idx = rng.integers(-1, cap, (q, w))
    idx[np.isinf(dists)] = 1 << 40          # out of range: must not be read
    id_of_slot = rng.integers(-1, 1 << 20, cap)
    return dists, idx, id_of_slot


def _slots_to_ids_by_element(dists, idx, id_of_slot, k_req, nq):
    out = []
    for qi in range(nq):
        row = []
        for j in range(dists.shape[1]):
            if np.isinf(dists[qi, j]) or len(row) == k_req:
                break
            row.append((int(id_of_slot[int(idx[qi, j])]), float(dists[qi, j])))
        out.append(row)
    return out


def _check_slot_mapping(seed):
    # the collect's mapping against one read element by element: each
    # row stops at k_req or at its first infinite distance (a masked or
    # invalid slot, whose index is never read), ids and dists as Python
    # int and float; then the store's column path over the same hits
    # against its tuple path, with ids past the column and unnamed ones
    dists, idx, id_of_slot = _slot_case(seed)
    store = _flat_store(_rows(40))
    store.delete("r3")
    q = dists.shape[0]
    for k_req, nq in ((K, q), (dists.shape[1], q), (3, q - 2), (0, q)):
        hits = _slots_to_ids(dists, idx, id_of_slot, k_req, nq)
        rows = hits.rows()
        assert rows == _slots_to_ids_by_element(dists, idx, id_of_slot,
                                                k_req, nq)
        assert all(type(i) is int and type(d) is float
                   for row in rows for i, d in row)
        hits.ids = hits.ids % 80 - 2        # -2..77: 39 named of 64
        ks = [k_req, 2] * (nq // 2)
        assert store._map_columns(hits, ks) == [
            store._map_results(r[:k]) for r, k in zip(hits.rows(), ks)]


@pytest.mark.parametrize("case", [f"slots-seed{s}" for s in range(4)]
                         + list(CASES) + ["flat-masked-tail",
                                          "pq-repair-in-flight"])
def test_column_path_matches_tuple_path(case, monkeypatch):
    if case.startswith("slots-seed"):
        _check_slot_mapping(int(case[len("slots-seed"):]))
        return
    if case == "flat-masked-tail":
        # a slot mask leaves fewer eligible rows than k: +inf tails
        store = _flat_store(_rows())
        mask = np.zeros(store.index.capacity, bool)
        mask[::97] = True
        qs = _rows(NQ, seed=1)
        ks = [K, 3, 4] * (NQ // 3)
        handle = store.index.search_batch_submit(qs, K, slot_mask=mask)
        hits = handle.collect_columns()
        assert (hits.counts == int(mask[:N].sum())).all()
        assert store._map_columns(hits, ks) == [
            store._map_results(r[:k]) for r, k in zip(handle.collect(), ks)]
        return
    if case == "pq-repair-in-flight":
        # a slot mutated between the scan and the id mapping: the query is
        # re-answered by the host re-rank and its row written into the
        # columns
        rows = _rows(3000)
        store = VectorStore.with_index(PqFlatIndex(
            EUC, m=4, ksub=16, refine=32, rerank="device", device="cpu"))
        _fill(store, rows)
        store.index.train()
        index = store.index
        orig = index._collect_device_rerank

        def hooked(*args):
            store.insert("r5", Vector(rows[5] + 50.0))
            return orig(*args)

        monkeypatch.setattr(index, "_collect_device_rerank", hooked)
        seen = _spy(store, monkeypatch)
        # k = refine: the repaired row is one short of the device's
        queries = [(Vector(rows[5]), 32), (Vector(rows[7]), K)]
        got = store.search_batch(queries)
        want = [store._map_results(r[:k], seen["id_map"])
                for r, (_, k) in zip(seen["handle"].collect(), queries)]
        assert got == want and "id_map" in seen
        assert [len(r) for r in got] == [31, K]
        assert all(r.id != "r5" or r.distance > 1.0 for r in got[0])
        return
    make, ks, before, between = CASES[case]
    store = make(_rows())
    queries = [(Vector(q), k) for q, k in zip(_rows(NQ, seed=1), ks)]
    if before is not None:
        before(store, queries)
    seen = _spy(store, monkeypatch)
    handle = store.search_batch_submit(queries)
    if between is not None:
        between(store, queries)
    got = handle.collect()
    if "handle" not in seen:                  # an empty store answers []
        assert before is _empty and got == [[] for _ in queries]
        return
    assert "id_map" in seen                   # the column path ran
    if between is not None:
        assert seen["id_map"] is not None     # a frozen column
    want = [store._map_results(raw[:k], seen["id_map"])
            for raw, k in zip(seen["handle"].collect(), ks)]
    assert got == want
    if between is None:
        assert [len(r) for r in got] == [min(k, len(store)) for k in ks]
    assert all(type(r.id) is str and type(r.distance) is float
               for row in got for r in row)
    assert profiling.counters()["store.columnar_queries"] == NQ


def _hnsw_store(rows):
    store = VectorStore.with_index(HnswIndex(EUC, HnswParams(seed=3)))
    _fill(store, rows)
    return store


@pytest.mark.parametrize("case", ["flat", "ivfpq", "hnsw", "hnsw-ef"])
def test_columnar_queries_counts_column_path(case):
    # every query of a flat or IVF-PQ call; none where the index hands
    # rows (HNSW's eager path) or a knob takes the tuned path
    make = {"flat": _flat_store, "ivfpq": _ivfpq_store}.get(case,
                                                            _hnsw_store)
    knob = {"ef": 40} if case == "hnsw-ef" else {}
    counted = case in ("flat", "ivfpq")
    store = make(_rows(300))
    queries = [(Vector(q), K) for q in _rows(NQ, seed=2)]
    profiling.reset_spans()
    for _ in range(2):
        got = store.search_batch(queries, **knob)
        assert [len(r) for r in got] == [K] * NQ
    assert profiling.counters().get("store.columnar_queries", 0) == (
        2 * NQ if counted else 0)
