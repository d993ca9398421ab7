"""HNSW in the port, on the CPU: the graph (both backends), the index, the
store's filters and radius search over it, and the engine's
``index_type="hnsw"`` with its graph checkpoint.

Mirrors tests/test_hnsw_backends.py (8 cases), the HNSW cases of
tests/test_recall.py, tests/test_radius.py, tests/test_filters.py,
tests/test_persistence.py (``test_engine_hnsw_index_type``,
``TestHnswGraphPersistence``), tests/test_durable_serving.py and
tests/test_review_regressions.py. Every graph is seeded, and a seeded
port graph builds on one thread, so each case is deterministic. Where the
JAX package's gate is a recall floor, the port's answers are also held to
the JAX package's on the same graph: the JAX side builds its native graph
on one thread (``insert_batch(n_threads=1)``), since its default batch
build links nodes on up to 8 threads and changes from run to run.
"""

import io

import numpy as np
import pytest
import torch

import vectordb_tpu as J
from vectordb_tpu.index.hnsw import HnswIndex as JHnsw
from vectordb_tpu.index.hnsw_graph import HnswParams as JParams
from vectordb_tpu.persistence import EngineConfig as JEngineConfig
from vectordb_tpu.persistence import StorageEngine as JStorageEngine

from vectordb_tpu_torch import (BatchInsertItem, DistanceMetric, FlatIndex,
                                HnswIndex, HnswParams, Metadata,
                                MetadataFilter, Vector, VectorStore)
from vectordb_tpu_torch.convert import hnsw_store_from_reference
from vectordb_tpu_torch.errors import (DimensionMismatchError,
                                       InvalidVectorError)
from vectordb_tpu_torch.index.hnsw_graph import HnswGraph
from vectordb_tpu_torch.index.hnsw_native import (NativeHnswGraph,
                                                  native_available)
from vectordb_tpu_torch.persistence import (EngineConfig, StorageEngine,
                                            native_lib)
from vectordb_tpu_torch.server.app import AppState
from vectordb_tpu_torch.server.routes import Api

torch.set_num_threads(1)
EUC = DistanceMetric.EUCLIDEAN
METRICS = list(DistanceMetric)


@pytest.fixture(params=["python", "native"])
def backend(request):
    """The graph backend of HnswIndex; the native one is built, never
    skipped."""
    if request.param == "native":
        assert native_available()
    return request.param


@pytest.fixture(params=["native", "python"])
def core(request, monkeypatch):
    """The persistence backend (the native core, or the pure-Python one
    under VDB_TPU_NO_NATIVE, which also gives the Python graph)."""
    if request.param == "python":
        monkeypatch.setenv("VDB_TPU_NO_NATIVE", "1")
    else:
        monkeypatch.delenv("VDB_TPU_NO_NATIVE", raising=False)
        assert native_lib.get_native() is not None
    return request.param


def make_index(backend, metric=EUC, seed=11):
    return HnswIndex(metric, HnswParams(seed=seed), backend=backend)


def jmetric(metric):
    return J.DistanceMetric(metric.value)


def build_pair(backend, metric, data, seed):
    """(JAX index, port index) built from the same rows and seed, each on
    one thread."""
    jidx = JHnsw(jmetric(metric), JParams(seed=seed), backend=backend)
    tidx = HnswIndex(metric, HnswParams(seed=seed), backend=backend)
    n = data.shape[0]
    if backend == "native" and n >= 64:
        jidx.graph.insert_batch([(i, data[i]) for i in range(n)],
                                n_threads=1)
    else:
        jidx.build_batch([(i, J.Vector(data[i])) for i in range(n)])
    tidx.build_batch([(i, Vector(data[i])) for i in range(n)])
    return jidx, tidx


def assert_same_tables(a, b):
    assert set(a) == set(b)
    for key in a:
        np.testing.assert_array_equal(np.asarray(a[key]), np.asarray(b[key]),
                                      err_msg=key)


def assert_same_answers(jres, tres):
    assert [i for i, _ in tres] == [i for i, _ in jres]
    np.testing.assert_allclose([d for _, d in tres], [d for _, d in jres],
                               rtol=2e-5, atol=1e-6)


def recall(got, truth, k):
    return len({i for i, _ in got} & {i for i, _ in truth}) / k


# -- tests/test_hnsw_backends.py --------------------------------------------

def test_backend_selection(monkeypatch):
    idx = HnswIndex(EUC, HnswParams(seed=1), backend="python")
    assert isinstance(idx.graph, HnswGraph)
    assert isinstance(HnswIndex(EUC, HnswParams(seed=1)).graph,
                      NativeHnswGraph)
    with pytest.raises(ValueError):
        HnswIndex(EUC, backend="gpu")
    monkeypatch.setenv("VDB_TPU_NO_NATIVE", "1")
    assert isinstance(HnswIndex(EUC, HnswParams(seed=1)).graph, HnswGraph)
    with pytest.raises(RuntimeError, match="native"):
        HnswIndex(EUC, backend="native")


@pytest.mark.parametrize("metric", METRICS)
def test_recall_gate_both_backends(backend, metric, rng):
    n, d, k, ef = 600, 32, 10, 100
    data = rng.random((n, d)).astype(np.float32) + 0.05
    jidx, tidx = build_pair(backend, metric, data, 11)
    assert_same_tables(jidx.graph.export_padded_tables(),
                       tidx.graph.export_padded_tables())
    flat = FlatIndex(metric, device="cpu")
    flat.add_batch([(i, data[i]) for i in range(n)])
    queries = rng.random((15, d)).astype(np.float32) + 0.05
    truth = flat.search_batch(queries, k)
    total = 0.0
    for qi in range(15):
        got = tidx.search_with_ef(Vector(queries[qi]), k, ef)
        assert_same_answers(jidx.search_with_ef(J.Vector(queries[qi]), k,
                                                ef), got)
        total += recall(got, truth[qi], k)
    assert total / 15 >= 0.9


def test_crud_semantics_parity(backend):
    idx = make_index(backend)
    idx.add(0, Vector([0.0, 0.0]))
    idx.add(1, Vector([1.0, 0.0]))
    idx.add(2, Vector([0.0, 1.0]))
    assert len(idx) == 3 and idx.get_vector(1) == Vector([1.0, 0.0])
    idx.add(1, Vector([5.0, 5.0]))
    assert len(idx) == 3 and idx.get_vector(1) == Vector([5.0, 5.0])
    idx.remove(0)
    idx.remove(99)
    assert len(idx) == 2 and idx.get_vector(0) is None
    res = idx.search(Vector([0.0, 0.0]), 5)
    assert {i for i, _ in res} == {1, 2}
    assert [d for _, d in res] == sorted(d for _, d in res)


def test_cosine_zero_vector_error_parity(backend):
    idx = make_index(backend, DistanceMetric.COSINE)
    idx.add(0, Vector([1.0, 0.0]))
    with pytest.raises(InvalidVectorError):
        idx.add(1, Vector([0.0, 0.0]))
    with pytest.raises(InvalidVectorError):
        idx.search(Vector([0.0, 0.0]), 1)


def test_remove_entry_point_parity(backend, rng):
    data = rng.random((40, 8)).astype(np.float32)
    idx = make_index(backend, seed=5)
    for i in range(40):
        idx.add(i, Vector(data[i]))
    entry_id = idx.graph.id_of(idx.graph._entry)
    idx.remove(entry_id)
    assert len(idx) == 39
    res = idx.search(Vector(data[(entry_id + 1) % 40]), 5)
    assert res and all(i != entry_id for i, _ in res)


def test_device_tables_export_parity(backend, rng):
    """Both backends export the JAX package's tables for the same seed and
    rows (the device traversal's input); the traversal itself waits for
    ROADMAP queue 1 item 10b and says so."""
    data = rng.random((200, 16)).astype(np.float32)
    jidx, tidx = build_pair(backend, EUC, data, 7)
    assert_same_tables(jidx.graph.export_padded_tables(),
                       tidx.graph.export_padded_tables())
    with pytest.raises(NotImplementedError, match="item 10b"):
        tidx.search_batch_device(data[:5], 3, 60)
    with pytest.raises(NotImplementedError, match="item 10b"):
        tidx.device_searcher()


def test_store_upsert_filter_flow_parity(backend, rng):
    store = VectorStore.with_index(make_index(backend, seed=13))
    data = rng.random((60, 8)).astype(np.float32)
    for i in range(60):
        store.insert_with_metadata(f"v{i}", Vector(data[i]),
                                   Metadata({"par": str(i % 2)}))
    store.insert("v0", Vector(data[1]))
    assert len(store) == 60
    hits = store.search_with_filter(Vector(data[8]), 5,
                                    MetadataFilter.eq("par", "0"))
    assert hits and all(int(h.id[1:]) % 2 == 0 for h in hits)


def test_dimension_enforced_parity(backend):
    idx = make_index(backend)
    idx.add(0, Vector([1.0, 2.0]))
    with pytest.raises(DimensionMismatchError):
        idx.add(1, Vector([1.0]))
    with pytest.raises(DimensionMismatchError):
        idx.search(Vector([1.0, 2.0, 3.0]), 1)


# -- the device paths of item 10b --------------------------------------------

def test_device_bulk_build_raises_naming_item_10b():
    with pytest.raises(NotImplementedError, match="item 10b"):
        HnswIndex(EUC, HnswParams(seed=1), bulk_build="device")
    with pytest.raises(ValueError):
        HnswIndex(EUC, bulk_build="tpu")
    # "auto" and "host" take the host build at any size
    idx = HnswIndex(EUC, HnswParams(seed=1), bulk_build="auto")
    idx.build_batch([(i, Vector([float(i), 1.0])) for i in range(100)])
    assert len(idx) == 100


# -- determinism and parity with the JAX package -----------------------------

@pytest.mark.parametrize("metric", METRICS)
def test_same_seed_same_tables_and_answers(backend, metric, rng):
    data = rng.standard_normal((300, 24)).astype(np.float32) + 0.5
    jidx, tidx = build_pair(backend, metric, data, 21)
    assert_same_tables(jidx.graph.export_padded_tables(),
                       tidx.graph.export_padded_tables())
    for q in rng.standard_normal((12, 24)).astype(np.float32) + 0.5:
        for ef in (None, 16, 128):
            jres = (jidx.search(J.Vector(q), 7) if ef is None
                    else jidx.search_with_ef(J.Vector(q), 7, ef))
            tres = (tidx.search(Vector(q), 7) if ef is None
                    else tidx.search_with_ef(Vector(q), 7, ef))
            assert_same_answers(jres, tres)


def test_seeded_native_build_is_reproducible(rng):
    """A seeded native graph builds on one thread: two builds of the same
    rows give the same tables; the same batches through two stores give
    the same graph and answers."""
    data = rng.standard_normal((400, 16)).astype(np.float32)
    a = HnswIndex(EUC, HnswParams(seed=3))
    b = HnswIndex(EUC, HnswParams(seed=3))
    for idx in (a, b):
        for c0 in range(0, 400, 100):
            idx.build_batch([(i, Vector(data[i])) for i in range(c0,
                                                                 c0 + 100)])
    assert_same_tables(a.graph.export_padded_tables(),
                       b.graph.export_padded_tables())
    for q in data[:10]:
        assert a.search(Vector(q), 5) == b.search(Vector(q), 5)


def test_unseeded_native_build_uses_threads(monkeypatch):
    """An unseeded graph keeps the JAX package's parallel batch build."""
    seen = []
    graph = NativeHnswGraph(EUC, HnswParams())
    lib = graph._native

    class Spy:
        def __getattr__(self, name):
            return getattr(lib, name)

        def vdb_hnsw_insert_batch(self, *args):
            seen.append(args[4])
            return lib.vdb_hnsw_insert_batch(*args)

    graph._native = Spy()
    graph.insert_batch([(i, np.array([float(i), 1.0], np.float32))
                        for i in range(80)])
    seeded = NativeHnswGraph(EUC, HnswParams(seed=0))
    seeded._native = Spy()
    seeded.insert_batch([(i, np.array([float(i), 1.0], np.float32))
                         for i in range(80)])
    import os
    assert seen == [min(8, os.cpu_count() or 1), 1]


@pytest.mark.parametrize("py_backend", ["python", "native"])
def test_hnsw_store_from_reference(py_backend, rng):
    """A JAX HnswIndex store carried across by its exported tables and id
    map answers as the JAX store does."""
    data = rng.standard_normal((150, 12)).astype(np.float32)
    jstore = J.VectorStore.with_index(
        JHnsw(J.DistanceMetric.EUCLIDEAN, JParams(seed=4),
              backend=py_backend))
    for i in range(150):
        jstore.insert_with_metadata(f"v{i}", J.Vector(data[i]),
                                    J.Metadata({"par": str(i % 2)}))
    jstore.delete("v3")
    id_map = jstore.internal_to_string_ids()
    meta = {iid: jstore.get_metadata(sid).fields()
            for iid, sid in id_map.items()}
    tstore = hnsw_store_from_reference(
        jstore.index.graph.export_padded_tables(), id_map, EUC,
        HnswParams(seed=4), backend=py_backend, metadata=meta)
    assert sorted(tstore.list_ids()) == sorted(jstore.list_ids())
    flt = MetadataFilter.eq("par", "1")
    for q in rng.standard_normal((8, 12)).astype(np.float32):
        jr = jstore.search(J.Vector(q), 5)
        tr = tstore.search(Vector(q), 5)
        assert [r.id for r in tr] == [r.id for r in jr]
        np.testing.assert_allclose([r.distance for r in tr],
                                   [r.distance for r in jr], rtol=2e-5)
        jf = jstore.search_with_filter(J.Vector(q), 4,
                                       J.MetadataFilter.eq("par", "1"))
        tf = tstore.search_with_filter(Vector(q), 4, flt)
        assert [r.id for r in tf] == [r.id for r in jf]


# -- tests/test_recall.py ----------------------------------------------------

def run_recall(n, d, k, ef, num_queries, seed=7):
    """(port recall against the exact flat scan, the JAX package's recall
    on the same graph); the answers are held equal on the way."""
    rng = np.random.default_rng(seed)
    data = rng.random((n, d)).astype(np.float32)
    jidx, tidx = build_pair("native", EUC, data, seed)
    flat = FlatIndex(EUC, device="cpu")
    flat.add_batch([(i, data[i]) for i in range(n)])
    queries = rng.random((num_queries, d)).astype(np.float32)
    truth = flat.search_batch(queries, k)
    total = jtotal = 0.0
    for qi in range(num_queries):
        got = tidx.search_with_ef(Vector(queries[qi]), k, ef)
        jgot = jidx.search_with_ef(J.Vector(queries[qi]), k, ef)
        assert_same_answers(jgot, got)
        total += recall(got, truth[qi], k)
        jtotal += recall(jgot, truth[qi], k)
    return total / num_queries, jtotal / num_queries


def test_recall_small():
    port, ref = run_recall(n=100, d=32, k=10, ef=100, num_queries=20)
    assert port == ref and port >= 0.90


def test_recall_medium():
    port, ref = run_recall(n=1000, d=64, k=10, ef=100, num_queries=20)
    assert port == ref and port >= 0.90


def test_hnsw_self_search():
    data = np.random.default_rng(3).random((100, 16)).astype(np.float32)
    hnsw = HnswIndex(EUC, HnswParams(seed=3))
    hnsw.build_batch([(i, Vector(data[i])) for i in range(100)])
    hits = sum(int(hnsw.search_with_ef(Vector(data[i]), 1, 50)[0][0] == i)
               for i in range(100))
    assert hits >= 99


def test_hnsw_remove_entry_point():
    data = np.random.default_rng(5).random((50, 8)).astype(np.float32)
    hnsw = HnswIndex(EUC, HnswParams(seed=5))
    for i in range(50):
        hnsw.add(i, Vector(data[i]))
    entry_id = hnsw.graph.id_of(hnsw.graph._entry)
    hnsw.remove(entry_id)
    assert len(hnsw) == 49
    res = hnsw.search(Vector(data[(entry_id + 1) % 50]), 5)
    assert res and all(iid != entry_id for iid, _ in res)


def test_hnsw_ef_improves_recall():
    lo, jlo = run_recall(n=500, d=32, k=10, ef=10, num_queries=10, seed=11)
    hi, jhi = run_recall(n=500, d=32, k=10, ef=200, num_queries=10, seed=11)
    assert (lo, hi) == (jlo, jhi)
    assert hi >= lo and hi >= 0.95


@pytest.mark.parametrize("metric", [DistanceMetric.COSINE,
                                    DistanceMetric.DOT_PRODUCT])
def test_hnsw_other_metrics(metric):
    rng = np.random.default_rng(13)
    data = rng.random((200, 16)).astype(np.float32) + 0.1
    jidx, tidx = build_pair("native", metric, data, 13)
    flat = FlatIndex(metric, device="cpu")
    flat.add_batch([(i, data[i]) for i in range(200)])
    queries = rng.random((10, 16)).astype(np.float32) + 0.1
    truth = flat.search_batch(queries, 10)
    total = 0.0
    for qi in range(10):
        got = tidx.search_with_ef(Vector(queries[qi]), 10, 100)
        assert_same_answers(jidx.search_with_ef(J.Vector(queries[qi]), 10,
                                                100), got)
        total += recall(got, truth[qi], 10)
    assert total / 10 >= 0.85


# -- tests/test_radius.py ----------------------------------------------------

def test_hnsw_matches_flat_ground_truth():
    data = np.random.default_rng(3).standard_normal((300, 16)).astype(
        np.float32)
    flat = VectorStore.with_flat_index(EUC, device="cpu")
    hnsw = VectorStore(HnswIndex(EUC, HnswParams(seed=3)))
    items = [BatchInsertItem(id=f"v{i}", vector=Vector(data[i]))
             for i in range(300)]
    flat.insert_batch(items)
    hnsw.insert_batch(items)
    q = Vector(data[17] + 0.01)
    truth = {h.id: h.distance for h in flat.search_radius(q, 2.0, limit=300)}
    hits = hnsw.search_radius(q, 2.0, limit=300)
    assert [h.distance for h in hits] == sorted(h.distance for h in hits)
    for h in hits:
        assert h.id in truth
        assert h.distance == pytest.approx(truth[h.id], abs=1e-5)
    assert len(hits) == len(truth)


def test_hnsw_ef_widens_to_limit():
    idx = HnswIndex(EUC, HnswParams(seed=5))
    data = np.random.default_rng(5).standard_normal((200, 8)).astype(
        np.float32)
    for i in range(200):
        idx.add(i, Vector(data[i]))
    assert len(idx.search_radius(Vector(data[0]), 1e9, 120)) == 120


# -- tests/test_filters.py ---------------------------------------------------

def meta(**kw):
    return Metadata({k: str(v) for k, v in kw.items()})


def test_hnsw_filtered_fallback(rng):
    store = VectorStore.with_index(HnswIndex(EUC, HnswParams(seed=3)))
    data = rng.standard_normal((60, 8)).astype(np.float32)
    for i in range(60):
        store.insert_with_metadata(f"v{i}", Vector(data[i]), meta(par=i % 2))
    results = store.search_with_filter(Vector(data[8]), 5,
                                       MetadataFilter.eq("par", "0"))
    assert results and all(int(r.id[1:]) % 2 == 0 for r in results)
    assert results[0].id == "v8"


def test_hnsw_masked_traversal_exact(rng, backend):
    idx = HnswIndex(EUC, HnswParams(seed=3), backend=backend)
    store = VectorStore.with_index(idx)
    data = rng.standard_normal((300, 8)).astype(np.float32)
    for i in range(300):
        store.insert_with_metadata(f"v{i}", Vector(data[i]), meta(par=i % 3))
    q = data[9]
    elig = [i for i in range(300) if i % 3 == 0]
    d2 = np.sum((data[elig] - q) ** 2, axis=1)
    want = [f"v{elig[j]}" for j in np.argsort(d2)[:5]]
    got = store.search_with_filter(Vector(q), 5,
                                   MetadataFilter.eq("par", "0"))
    assert [r.id for r in got] == want
    mask = np.zeros(idx.capacity, dtype=bool)
    for i in elig:
        mask[idx.slot_of(store._id_to_internal[f"v{i}"])] = True
    res = idx.search_masked(Vector(q), 5, mask)
    assert res is not None and len(res) == 5


def test_hnsw_masked_selective_filter(rng):
    store = VectorStore.with_index(HnswIndex(EUC, HnswParams(seed=7)))
    data = rng.standard_normal((400, 8)).astype(np.float32)
    rare = {17, 123, 210, 333, 390}
    for i in range(400):
        store.insert_with_metadata(
            f"v{i}", Vector(data[i]),
            meta(tag="rare" if i in rare else "common"))
    got = store.search_with_filter(Vector(data[17] + np.float32(0.01)), 5,
                                   MetadataFilter.eq("tag", "rare"))
    assert {r.id for r in got} == {f"v{i}" for i in rare}


def test_ef_with_filter_on_hnsw(rng):
    store = VectorStore(HnswIndex(EUC, HnswParams(seed=7)))
    data = rng.standard_normal((300, 8)).astype(np.float32)
    for i in range(300):
        store.insert_with_metadata(f"v{i}", Vector(data[i]), meta(par=i % 2))
    got = store.search_with_filter(Vector(data[4]), 5,
                                   MetadataFilter.eq("par", "0"), ef=256)
    assert got and all(int(r.id[1:]) % 2 == 0 for r in got)
    assert got[0].id == "v4"


def test_ef_with_selective_filter_returns_k(rng):
    store = VectorStore(HnswIndex(EUC, HnswParams(seed=7)))
    data = rng.standard_normal((600, 8)).astype(np.float32)
    for i in range(600):
        store.insert_with_metadata(f"v{i}", Vector(data[i]),
                                   meta(par=i % 30))
    flt = MetadataFilter.eq("par", "0")
    for ef in (16, 64):
        got = store.search_with_filter(Vector(data[30]), 10, flt, ef=ef)
        assert len(got) == 10, (ef, len(got))
        assert all(int(r.id[1:]) % 30 == 0 for r in got)
        assert got[0].id == "v30"


# -- the engine (tests/test_persistence.py, tests/test_durable_serving.py) --

def cfg(**kw):
    return EngineConfig(index_type="hnsw", device="cpu", **kw)


def test_engine_hnsw_index_type(core, tmp_path):
    config = cfg(hnsw_params=HnswParams(seed=3))
    with StorageEngine.open(tmp_path, config) as eng:
        for i in range(50):
            eng.insert(f"v{i}", Vector([float(i), float(i % 7)]))
        assert isinstance(eng.store.index, HnswIndex)
        assert eng.search(Vector([25.0, 4.0]), 1)[0].id == "v25"
    with StorageEngine.open(tmp_path, config) as eng:
        assert len(eng) == 50 and isinstance(eng.store.index, HnswIndex)
        assert eng.search(Vector([25.0, 4.0]), 1)[0].id == "v25"


def test_engine_hnsw_default_params(tmp_path):
    with StorageEngine.open(tmp_path, cfg()) as eng:
        eng.insert("a", Vector([1.0, 2.0]))
        assert eng.store.index.params == HnswParams()


class TestHnswGraphPersistence:
    def _build(self, tmp_path, n=120, d=16, seed=9):
        data = np.random.default_rng(seed).random((n, d)).astype(np.float32)
        config = cfg(hnsw_params=HnswParams(seed=seed))
        with StorageEngine.open(tmp_path, config) as eng:
            for i in range(n):
                eng.insert_with_metadata(f"v{i}", Vector(data[i]),
                                         Metadata({"par": str(i % 2)}))
            eng.checkpoint()
        return config, data

    def test_graph_file_written_and_imported(self, core, tmp_path,
                                             monkeypatch):
        config, data = self._build(tmp_path)
        assert (tmp_path / "hnsw_graph.npz").exists()
        called = {"rebuild": False}
        orig = StorageEngine._apply_snapshot

        def spy(self, snap):
            called["rebuild"] = True
            return orig(self, snap)

        monkeypatch.setattr(StorageEngine, "_apply_snapshot", spy)
        with StorageEngine.open(tmp_path, config) as eng:
            assert not called["rebuild"]
            assert len(eng) == 120
            assert eng.search(Vector(data[37]), 1)[0].id == "v37"
            assert eng.get_metadata("v37").get("par") == "1"
            got = eng.store.search_with_filter(
                Vector(data[10]), 5, MetadataFilter.eq("par", "0"))
            assert got and all(int(h.id[1:]) % 2 == 0 for h in got)

    def test_writes_after_import_replay(self, core, tmp_path):
        config, data = self._build(tmp_path)
        with StorageEngine.open(tmp_path, config) as eng:
            eng.insert("extra", Vector(data[0] * 0.5))
            eng.delete("v0")
        with StorageEngine.open(tmp_path, config) as eng:
            assert len(eng) == 120
            assert eng.get("extra") is not None and eng.get("v0") is None
            eng.insert("extra", Vector(data[1]))
            assert len(eng) == 120

    def test_param_mismatch_falls_back_to_rebuild(self, core, tmp_path):
        config, data = self._build(tmp_path)
        other = cfg(hnsw_params=HnswParams(m=8, seed=1))
        with StorageEngine.open(tmp_path, other) as eng:
            assert len(eng) == 120
            assert eng.search(Vector(data[5]), 1)[0].id == "v5"

    def test_corrupt_graph_file_falls_back(self, core, tmp_path):
        config, data = self._build(tmp_path)
        (tmp_path / "hnsw_graph.npz").write_bytes(b"not-a-npz")
        with StorageEngine.open(tmp_path, config) as eng:
            assert len(eng) == 120
            assert eng.search(Vector(data[5]), 1)[0].id == "v5"

    def test_import_search_quality_matches_rebuild(self, core, tmp_path):
        config, data = self._build(tmp_path, n=300, d=24)
        with StorageEngine.open(tmp_path, config) as eng:
            hits = sum(int(eng.search(Vector(data[i]), 1)[0].id == f"v{i}")
                       for i in range(0, 300, 10))
            assert hits >= 29

    def test_reopen_answers_equal_the_writers(self, core, tmp_path):
        """The imported graph is the writer's: the same queries answer
        the same, at every ef."""
        config, data = self._build(tmp_path, n=200, d=16, seed=4)
        queries = np.random.default_rng(1).random((10, 16)).astype(
            np.float32)
        with StorageEngine.open(tmp_path, config) as eng:
            before = [eng.search(Vector(q), 5, ef=ef) for q in queries
                      for ef in (8, 64)]
            tables = eng.store.index.graph.export_padded_tables()
            eng.checkpoint()
        with StorageEngine.open(tmp_path, config) as eng:
            assert_same_tables(tables,
                               eng.store.index.graph.export_padded_tables())
            assert before == [eng.search(Vector(q), 5, ef=ef)
                              for q in queries for ef in (8, 64)]


def test_hnsw_engine_behind_api(tmp_path):
    def make_api():
        engine = StorageEngine.open(tmp_path, cfg())
        return Api(AppState(engine)), engine

    api, engine = make_api()
    for i in range(32):
        assert api.handle("POST", "/vectors", {
            "id": f"v{i}", "vector": [float(i), float(i % 3)]})[0] == 201
    status, hits = api.handle("POST", "/search", {"vector": [5.0, 2.0],
                                                  "k": 3})
    assert status == 200 and hits[0]["id"] == "v5"
    engine.close()
    api2, engine2 = make_api()
    status, hits2 = api2.handle("POST", "/search", {"vector": [5.0, 2.0],
                                                    "k": 3})
    assert status == 200 and hits2 == hits
    engine2.close()


# -- the graph file is the JAX package's -------------------------------------

def _write_both(tmp_path, data, seed=6, metric=EUC):
    """The same inserts through a JAX and a port HNSW engine, each
    checkpointed; returns the two directories."""
    jd, td = tmp_path / "jax", tmp_path / "port"
    jcfg = JEngineConfig(metric=jmetric(metric), index_type="hnsw",
                         hnsw_params=JParams(seed=seed))
    tcfg = cfg(metric=metric, hnsw_params=HnswParams(seed=seed))
    with JStorageEngine.open(jd, jcfg) as jeng, \
            StorageEngine.open(td, tcfg) as teng:
        for i in range(data.shape[0]):
            meta_j = J.Metadata({"par": str(i % 2)})
            jeng.insert_with_metadata(f"v{i}", J.Vector(data[i]), meta_j)
            teng.insert_with_metadata(f"v{i}", Vector(data[i]),
                                      Metadata({"par": str(i % 2)}))
        jeng.delete("v5")
        teng.delete("v5")
        jeng.checkpoint()
        teng.checkpoint()
    return jd, td, jcfg, tcfg


@pytest.mark.parametrize("metric", METRICS)
def test_graph_files_byte_identical(core, tmp_path, metric):
    data = np.random.default_rng(2).random((90, 12)).astype(np.float32) + 0.1
    jd, td, _, _ = _write_both(tmp_path, data, metric=metric)
    for name in ("hnsw_graph.npz", "snapshot.bin"):
        assert (jd / name).read_bytes() == (td / name).read_bytes(), name


def test_each_package_opens_the_others_graph(core, tmp_path, monkeypatch):
    """Each package imports the other's hnsw_graph.npz (no rebuild) and
    answers as its writer did."""
    data = np.random.default_rng(8).random((150, 12)).astype(np.float32)
    jd, td, jcfg, tcfg = _write_both(tmp_path, data)
    queries = np.random.default_rng(9).random((6, 12)).astype(np.float32)
    rebuilt = []
    orig_t = StorageEngine._apply_snapshot
    orig_j = JStorageEngine._apply_snapshot
    monkeypatch.setattr(StorageEngine, "_apply_snapshot",
                        lambda self, s: rebuilt.append("port")
                        or orig_t(self, s))
    monkeypatch.setattr(JStorageEngine, "_apply_snapshot",
                        lambda self, s: rebuilt.append("jax")
                        or orig_j(self, s))
    with StorageEngine.open(jd, tcfg) as teng, \
            JStorageEngine.open(td, jcfg) as jeng:
        assert sorted(teng.list_ids()) == sorted(jeng.list_ids())
        for q in queries:
            tr = teng.search(Vector(q), 5, ef=32)
            jr = jeng.search(J.Vector(q), 5, ef=32)
            assert [r.id for r in tr] == [r.id for r in jr]
            np.testing.assert_allclose([r.distance for r in tr],
                                       [r.distance for r in jr], rtol=2e-5)
        assert teng.get_metadata("v7").get("par") == "1"
    assert rebuilt == []


# -- tests/test_review_regressions.py: HNSW ----------------------------------

def test_native_hnsw_cosine_zero_counter():
    idx = HnswIndex(DistanceMetric.COSINE, HnswParams(seed=1),
                    backend="native")
    idx.add(0, Vector([0.0, 0.0]))
    with pytest.raises(InvalidVectorError):
        idx.add(1, Vector([1.0, 0.0]))
    idx.remove(0)
    idx.add(1, Vector([1.0, 0.0]))
    idx.add(2, Vector([0.5, 0.5]))
    assert [i for i, _ in idx.search(Vector([1.0, 0.1]), 1)] == [1]


def test_stale_graph_not_imported_after_snapshot_changes(tmp_path):
    config = cfg(hnsw_params=HnswParams(seed=2))
    data = np.random.default_rng(0).random((40, 8)).astype(np.float32)
    with StorageEngine.open(tmp_path, config) as eng:
        for i in range(40):
            eng.insert(f"v{i}", Vector(data[i]))
        eng.checkpoint()
    stale_graph = (tmp_path / "hnsw_graph.npz").read_bytes()
    with StorageEngine.open(tmp_path, config) as eng:
        for i in range(40):
            eng.insert(f"v{i}", Vector(-data[i]))
        eng.checkpoint()
    (tmp_path / "hnsw_graph.npz").write_bytes(stale_graph)
    with StorageEngine.open(tmp_path, config) as eng:
        hits = eng.search(Vector(-data[3]), 1)
        assert hits[0].id == "v3"
        assert hits[0].distance == pytest.approx(0.0, abs=1e-4)


def test_cosine_batch_insert_with_existing_zero_raises():
    idx = HnswIndex(DistanceMetric.COSINE, HnswParams(seed=1),
                    backend="native")
    idx.add(0, Vector([0.0, 0.0]))
    rng = np.random.default_rng(1)
    items = [(i + 1, Vector(rng.random(2).astype(np.float32) + 0.1))
             for i in range(80)]
    with pytest.raises(InvalidVectorError):
        idx.build_batch(items)


def test_checkpoint_on_empty_hnsw_engine(tmp_path, monkeypatch):
    monkeypatch.setenv("VDB_TPU_NO_NATIVE", "1")
    config = cfg(hnsw_params=HnswParams(seed=1))
    with StorageEngine.open(tmp_path, config) as eng:
        eng.checkpoint()
        assert len(eng) == 0
    with StorageEngine.open(tmp_path, config) as eng:
        assert len(eng) == 0


def test_plausible_but_corrupt_graph_tables_fall_back(tmp_path):
    config = cfg(hnsw_params=HnswParams(seed=3))
    data = np.random.default_rng(0).random((30, 8)).astype(np.float32)
    with StorageEngine.open(tmp_path, config) as eng:
        for i in range(30):
            eng.insert(f"v{i}", Vector(data[i]))
        eng.checkpoint()
    with np.load(tmp_path / "hnsw_graph.npz") as z:
        tables = {key: z[key] for key in z.files}
    tables["neighbors"] = tables["neighbors"].copy()
    tables["neighbors"][tables["neighbors"] >= 0] = 10 ** 6
    buf = io.BytesIO()
    np.savez(buf, **tables)
    (tmp_path / "hnsw_graph.npz").write_bytes(buf.getvalue())
    with StorageEngine.open(tmp_path, config) as eng:
        assert len(eng) == 30
        assert eng.search(Vector(data[7]), 1)[0].id == "v7"
