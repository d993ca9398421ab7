"""The hand-off of search hits from index to store on the CPU.

Every batched index search hands the store HitColumns ((Q, w) internal
ids, distances, per-query counts), each query's row cut by
``HitColumns.cut``; the store maps a whole call with one gather from its
id column (``VectorStore._map_columns``). Each case holds the store's
answers to an element-by-element mapping written here: the index
handle's rows, each cut at its k, mapped one hit at a time through the
id column. The producers' cuts are held to element-by-element readings
of their rules: the flat slot mapping stops at +inf, the host, gathered
and IVF-probed ones at the first non-finite distance."""

import gc
from dataclasses import dataclass

import numpy as np
import pytest
import torch

from vectordb_tpu_torch import (DistanceMetric, HnswIndex, HnswParams,
                                IvfFlatIndex, IvfPqIndex, PqFlatIndex,
                                Vector, VectorStore)
from vectordb_tpu_torch.index import pq as tpqi
from vectordb_tpu_torch.index.flat import FlatIndex, _slots_to_ids
from vectordb_tpu_torch.ops import pq as tpq
from vectordb_tpu_torch.ops import topk as ttopk
from vectordb_tpu_torch.parallel import make_mesh
from vectordb_tpu_torch.store import BatchInsertItem, SearchResult

torch.set_num_threads(1)
EUC = DistanceMetric.EUCLIDEAN
N, D, NQ, K = 600, 16, 12, 10


@pytest.fixture(autouse=True)
def _ladder(monkeypatch):
    monkeypatch.setattr(ttopk, "_EXACT1P_MIN_N", 512)


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
    """Record the index handle the first submit returns (the batch's: a
    mutation between submit and collect may run single searches) and the
    id column and query count of each mapping."""
    seen = {"mapped": []}
    submit = store.index.search_batch_submit
    map_columns = store._map_columns

    def spy_submit(queries, k):
        handle = submit(queries, k)
        seen.setdefault("handle", handle)
        return handle

    def spy_map(hits, ks=None, id_map=None):
        seen["id_map"] = id_map
        seen["mapped"].append(len(hits.counts))
        return map_columns(hits, ks, id_map)

    monkeypatch.setattr(store.index, "search_batch_submit", spy_submit)
    monkeypatch.setattr(store, "_map_columns", spy_map)
    return seen


def _map_by_element(store, rows, ks, id_map=None):
    """Each query's first k [(internal_id, dist)] hits mapped one at a
    time through the id column (``id_map``: a frozen copy of it); ids
    with no string id drop."""
    col = store._ids if id_map is None else id_map
    out = []
    for row, k in zip(rows, ks):
        hits = []
        for iid, dist in row[:k]:
            sid = col[iid] if 0 <= iid < len(col) else None
            if sid is not None:
                hits.append(SearchResult(sid, dist))
        out.append(hits)
    return out


def _slot_case(seed):
    rng = np.random.default_rng(seed)
    q, w, cap = 8, 12, 64
    dists = np.sort(rng.standard_normal((q, w)).astype(np.float32), axis=1)
    cut = rng.integers(0, w + 1, q)
    dists[np.arange(w) >= cut[:, None]] = np.inf
    dists[0, 1] = np.nan                    # kept: only +inf ends a row
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


def _same_rows(got, want):
    # NaN distances compare by position, everything else exactly
    assert [[i for i, _ in r] for r in got] == [[i for i, _ in r]
                                                for r in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal([d for _, d in g], [d for _, d in w])
    assert all(type(i) is int and type(d) is float
               for row in got for i, d in row)


def _same_results(got, want):
    # ids exactly, each id's distance by position (NaN equals NaN)
    assert [[r.id for r in row] for row in got] == [[r.id for r in row]
                                                    for row in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal([r.distance for r in g],
                                      [r.distance for r in w])
    assert all(type(r.id) is str and type(r.distance) is float
               for row in got for r in row)


def _check_slot_mapping(seed):
    # the collect's mapping against one read element by element: each
    # row stops at k_req or at its first infinite distance (a masked or
    # invalid slot, whose index is never read), ids and dists as Python
    # int and float; then the store's mapping of the same hits against
    # one hit at a time, with ids past the column and unnamed ones
    dists, idx, id_of_slot = _slot_case(seed)
    store = _flat_store(_rows(40))
    store.delete("r3")
    q = dists.shape[0]
    for k_req, nq in ((K, q), (dists.shape[1], q), (3, q - 2), (0, q)):
        hits = _slots_to_ids(dists, idx, id_of_slot, k_req, nq)
        _same_rows(hits.rows(), _slots_to_ids_by_element(
            dists, idx, id_of_slot, k_req, nq))
        hits.ids = hits.ids % 80 - 2        # -2..77: 39 named of 64
        ks = [k_req, 2] * (nq // 2)
        _same_results(store._map_columns(hits, ks),
                      _map_by_element(store, hits.rows(), ks))


def _cut_by_element(dists, ids_at, k_req):
    """A producer's rows read one element at a time: each stops at
    ``k_req`` or at its first non-finite distance; ``ids_at(qi, j)`` is
    read only for the hits kept."""
    out = []
    for qi in range(dists.shape[0]):
        row = []
        for j in range(dists.shape[1]):
            dv = float(dists[qi, j])
            if not np.isfinite(dv) or len(row) >= k_req:
                break
            row.append((int(ids_at(qi, j)), dv))
        out.append(row)
    return out


def _ranked_case(seed, q, w):
    """(q, w) ascending distances with +inf tails and a NaN inside some
    rows."""
    rng = np.random.default_rng(seed)
    dists = np.sort(rng.random((q, w)).astype(np.float32), axis=1)
    cut = rng.integers(0, w + 1, q)
    dists[np.arange(w) >= cut[:, None]] = np.inf
    nan_at = rng.integers(0, w, q)
    rows = np.nonzero(rng.random(q) < 0.4)[0]
    dists[rows, nan_at[rows]] = np.nan
    return rng, dists


def _pq_index(rows, rerank):
    index = PqFlatIndex(EUC, m=4, ksub=16, refine=32, rerank=rerank,
                        device="cpu")
    index.add_batch([(3 * i + 1, Vector(r)) for i, r in enumerate(rows)])
    return index


def _check_host_producer(seed):
    # venue "host": the candidates' exact distances, dead ones (a
    # non-finite scan score, a NaN row) at +inf or NaN, ranked and cut
    index = _pq_index(_rows(), "host")
    rng = np.random.default_rng(seed)
    q, r, k_req = 9, 24, K
    index._vectors[7] = np.nan
    queries = _rows(q, seed=seed + 1)
    slots = rng.integers(0, N, (q, r))
    slots[:, 0] = 7
    scores = rng.random((q, r)).astype(np.float32)
    scores[rng.random((q, r)) < rng.random((q, 1))] = np.inf
    scores[rng.random((q, r)) < 0.1] = np.nan
    got = index._rerank(queries, scores, slots, k_req, index._tick,
                        index.slot_layout_version)
    cand = index._vectors[slots]
    diff = cand - queries[:, None, :]
    dist = np.sqrt(np.einsum("qrd,qrd->qr", diff, diff, optimize=True))
    dist = np.where(np.isfinite(scores), dist, np.inf).astype(np.float32)
    order = np.argsort(dist, axis=1, kind="stable")[:, :k_req]
    ids = index._id_of_slot[slots]
    want = _cut_by_element(np.take_along_axis(dist, order, axis=1),
                           lambda qi, j: ids[qi, order[qi, j]], k_req)
    _same_rows(got.rows(), want)
    assert (got.counts < k_req).any()


def _check_gathered_producer(seed, monkeypatch):
    # venue "gathered": the device's (Q, k) distances and positions into
    # each query's candidate list, collected block by block
    index = _pq_index(_rows(), "device")
    q, r, k_req = 11, 16, K
    rng, dv = _ranked_case(seed, q, k_req)
    pos = rng.integers(0, r, (q, k_req))
    slots = rng.integers(0, N, (q, r))
    queries = _rows(q, seed=seed + 1)
    queries[:, 0] = np.arange(q)            # the fake reads its block

    def fake(qb, rows, ok, metric, k):
        a = int(qb[0, 0])
        b = a + qb.shape[0]
        return torch.from_numpy(dv[a:b]), torch.from_numpy(pos[a:b])

    monkeypatch.setattr(tpq, "pq_rerank_gathered", fake)
    monkeypatch.setattr(tpqi, "_RERANK_QBLOCK", 3)
    got = index._rerank_gathered(queries, np.zeros((q, r), np.float32),
                                 slots, k_req, index._tick,
                                 index.slot_layout_version)
    ids = index._id_of_slot[slots]
    want = _cut_by_element(dv, lambda qi, j: ids[qi, pos[qi, j]], k_req)
    _same_rows(got.rows(), want)
    assert (got.counts < k_req).any()


def _check_ivf_producer(seed, monkeypatch):
    # the IVF probed search: (Q, w) slots and distances from the device,
    # read through the id snapshot up to each row's first non-finite
    # distance; a query left short of k re-runs through the exact scan
    index = IvfFlatIndex(EUC, nlist=4, auto_train_min=1 << 20,
                         device="cpu")
    index.add_batch([(2 * i + 5, Vector(r)) for i, r in
                     enumerate(_rows())])
    q, w, k = 10, 12, 6
    rng, dists = _ranked_case(seed, q, w)
    idx = rng.integers(0, index.capacity, (q, w))
    idx[~np.isfinite(dists)] = 1 << 40      # out of range: must not be read
    id_of_slot = index._id_of_slot.copy()
    monkeypatch.setattr(index, "_probed_slots",
                        lambda *a: (idx, dists, id_of_slot, k))
    queries = _rows(q, seed=seed + 1)
    got = index._probed_search(queries, k, None, None, None).rows()
    want = _cut_by_element(dists, lambda qi, j: id_of_slot[idx[qi, j]], k)
    short = [qi for qi, row in enumerate(want) if len(row) < k]
    assert short and len(short) < q
    for qi, row in zip(short, FlatIndex.search_batch(index, queries[short],
                                                     k)):
        want[qi] = row
    _same_rows(got, want)


PRODUCERS = {"host": _check_host_producer,
             "gathered": _check_gathered_producer,
             "ivf-probed": _check_ivf_producer}


@pytest.mark.parametrize(
    "case", [f"slots-seed{s}" for s in range(4)]
    + [f"{p}-seed{s}" for p in PRODUCERS for s in range(2)]
    + list(CASES) + ["flat-masked-tail", "pq-repair-in-flight"])
def test_store_matches_element_mapping(case, monkeypatch):
    if case.startswith("slots-seed"):
        _check_slot_mapping(int(case[len("slots-seed"):]))
        return
    producer, _, seed = case.rpartition("-seed")
    if producer in PRODUCERS:
        check = PRODUCERS[producer]
        if producer == "host":
            check(int(seed))
        else:
            check(int(seed), monkeypatch)
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
        assert store._map_columns(hits, ks) == _map_by_element(
            store, handle.collect(), ks)
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
        want = _map_by_element(store, seen["handle"].collect(),
                               [k for _, k in queries], seen["id_map"])
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
    assert seen["mapped"][-1] == NQ           # one mapping of the call
    if between is not None:
        assert seen["id_map"] is not None     # a frozen column
    assert got == _map_by_element(store, seen["handle"].collect(), ks,
                                  seen["id_map"])
    if between is None:
        assert [len(r) for r in got] == [min(k, len(store)) for k in ks]
    assert all(type(r.id) is str and type(r.distance) is float
               for row in got for r in row)


def _hnsw_store(rows):
    store = VectorStore.with_index(HnswIndex(EUC, HnswParams(seed=3)))
    _fill(store, rows)
    return store


@pytest.mark.parametrize("case", ["flat", "ivfpq", "hnsw", "hnsw-ef"])
def test_every_family_maps_through_columns(case, monkeypatch):
    # a batch of any index family, knob or none, is one HitColumns
    # mapping of all its queries, and answers as its queries one by one
    make = {"flat": _flat_store, "ivfpq": _ivfpq_store}.get(case,
                                                            _hnsw_store)
    knob = {"ef": 40} if case == "hnsw-ef" else {}
    store = make(_rows(300))
    queries = [(Vector(q), K) for q in _rows(NQ, seed=2)]
    single = [store.search(q, k, **knob) for q, k in queries]
    seen = _spy(store, monkeypatch)
    for _ in range(2):
        got = store.search_batch(queries, **knob)
        assert [len(r) for r in got] == [K] * NQ
        assert [[r.id for r in row] for row in got] == [
            [r.id for r in row] for row in single]
        for g, s in zip(got, single):
            np.testing.assert_allclose([r.distance for r in g],
                                       [r.distance for r in s], rtol=1e-6)
    assert seen["mapped"] == [NQ, NQ]


@dataclass
class _DataclassHit:
    """The dataclass ``SearchResult`` the native type replaced."""
    id: str
    distance: float


def _dataclass_mapping(store, hits, ks=None, id_map=None):
    """``VectorStore._map_columns`` as it was with the dataclass hit."""
    col = store._ids if id_map is None else id_map
    ids = hits.ids
    known = (ids >= 0) & (ids < len(col))
    sids = np.empty(ids.shape, dtype=object)
    sids[known] = col[ids[known]]
    counts = hits.counts.tolist()
    out = []
    for s, d, n, k in zip(sids.tolist(), hits.dists.tolist(), counts,
                          counts if ks is None else ks):
        s = s[:min(n, k)]
        if None in s:
            out.append([_DataclassHit(i, x) for i, x in zip(s, d)
                        if i is not None])
        else:
            out.append(list(map(_DataclassHit, s, d)))
    return out


@pytest.mark.parametrize("case", ["flat", "ivfpq"])
def test_batch_hits_are_untracked_and_as_the_dataclass_mapped(
        case, monkeypatch):
    # the benchmark's call shape, 64 queries at k = 100: every hit is a
    # native SearchResult the collector does not track, field for field
    # what the dataclass mapping built from the same HitColumns
    store = {"flat": _flat_store, "ivfpq": _ivfpq_store}[case](_rows())
    seen = []
    map_columns = store._map_columns

    def spy_map(hits, ks=None, id_map=None):
        seen.append(_dataclass_mapping(store, hits, ks, id_map))
        return map_columns(hits, ks, id_map)

    monkeypatch.setattr(store, "_map_columns", spy_map)
    got = store.search_batch([(Vector(q), 100)
                              for q in _rows(64, seed=3)])
    assert len(seen) == 1 and [len(r) for r in got] == [100] * 64
    for g, w in zip(got, seen[0]):
        assert type(g) is list
        assert [(type(r), type(r.id), type(r.distance)) for r in g] == [
            (SearchResult, str, float)] * len(w)
        assert [(r.id, r.distance.hex()) for r in g] == [
            (r.id, r.distance.hex()) for r in w]
    assert not any(gc.is_tracked(r) for row in got for r in row)
