"""The HNSW device programs of the port, on the CPU: the bulk build
(index/hnsw_build_device.py, over the flat index's certified search) and
the batched traversal (ops/hnsw_device.py, plain H1 on a CPU tensor).

Mirrors tests/test_hnsw_build_device.py (13 cases), tests/test_hnsw_device.py
(6 and its metric cases), tests/test_integration.py
``test_store_with_device_hnsw_batch`` and tests/test_filters.py
``test_device_traversal_mask``, and holds the port to the JAX package on
the same numpy inputs:
  * the device-built tables (neighbors, levels, entry, max level) bit for
    bit, for all three metrics, same seed and block (a neighbor pair
    within f32 rounding of each other may come out in either order, see
    ``_assert_same_neighbors``; the other cases are tie-free and equal);
  * the traversal's ids exactly and its distances at rtol 1e-5 on the
    same imported tables, with and without a slot mask.
The JAX side runs as its own tests run it (XLA on the CPU; its flat
search in Pallas interpret mode where its tier ladder reaches the coarse
kernels, with ``_EXACT1P_MIN_N`` lowered on both sides).
"""

import numpy as np
import pytest
import torch

from vectordb_tpu import DistanceMetric as JM
from vectordb_tpu import FlatIndex as JFlat
from vectordb_tpu.index.hnsw import HnswIndex as JHnsw
from vectordb_tpu.index.hnsw_build_device import \
    build_device_tables as jbuild
from vectordb_tpu.index.hnsw_graph import HnswParams as JParams
from vectordb_tpu.ops import topk as jtopk
from vectordb_tpu.ops.hnsw_device import DeviceHnswSearcher as JSearcher

from vectordb_tpu_torch import (DistanceMetric, FlatIndex, HnswIndex,
                                HnswParams, Vector, VectorStore)
from vectordb_tpu_torch.errors import InvalidVectorError
from vectordb_tpu_torch.index import hnsw_build_device as hbd
from vectordb_tpu_torch.index.hnsw_build_device import (
    _apply_back_edges, build_device_tables, build_graph_device,
    sample_levels)
from vectordb_tpu_torch.index.hnsw_graph import HnswGraph
from vectordb_tpu_torch.index.hnsw_native import NativeHnswGraph
from vectordb_tpu_torch.ops import topk as ttopk
from vectordb_tpu_torch.ops.hnsw_device import (DeviceHnswSearcher,
                                                hnsw_search_device)

torch.set_num_threads(1)
EUC = DistanceMetric.EUCLIDEAN
METRICS = list(DistanceMetric)


@pytest.fixture(autouse=True)
def _tiers(monkeypatch):
    monkeypatch.setenv("VDB_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setattr(jtopk, "_EXACT1P_MIN_N", 512)
    monkeypatch.setattr(ttopk, "_EXACT1P_MIN_N", 512)


def _build(n=800, d=32, metric=EUC, seed=3, block=256, m=16):
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((n, d)).astype(np.float32)
    params = HnswParams(m=m, seed=seed)
    graph = build_graph_device(list(enumerate(data)), metric, params,
                               block=block, device="cpu")
    return data, params, graph


def _recall(graph, data, queries, k=10, ef=100, metric=EUC):
    flat = FlatIndex(metric, device="cpu")
    flat.add_batch(list(enumerate(data)))
    truth = flat.search_batch(queries, k)
    total = 0.0
    for qi in range(queries.shape[0]):
        got = {i for i, _ in graph.search_knn(queries[qi], k, ef=ef)}
        total += len(got & {i for i, _ in truth[qi]}) / k
    return total / queries.shape[0]


# -- tests/test_hnsw_build_device.py ------------------------------------------

def test_recall_gate_euclidean():
    rng = np.random.default_rng(7)
    n, d = 1000, 64
    data = rng.random((n, d)).astype(np.float32)
    graph = build_graph_device(list(enumerate(data)), EUC,
                               HnswParams(seed=7), block=256, device="cpu")
    queries = rng.random((20, d)).astype(np.float32)
    assert _recall(graph, data, queries) >= 0.90


@pytest.mark.parametrize("metric", [DistanceMetric.COSINE,
                                    DistanceMetric.DOT_PRODUCT])
def test_recall_other_metrics(metric):
    data, _, graph = _build(n=600, d=32, metric=metric, block=200)
    rng = np.random.default_rng(11)
    queries = rng.standard_normal((15, 32)).astype(np.float32)
    assert _recall(graph, data, queries, metric=metric) >= 0.85


def test_matches_sequential_recall():
    rng = np.random.default_rng(5)
    n, d, k = 1200, 48, 10
    data = rng.standard_normal((n, d)).astype(np.float32)
    queries = rng.standard_normal((30, d)).astype(np.float32)
    params = HnswParams(m=16, seed=5)
    g_dev = build_graph_device(list(enumerate(data)), EUC, params,
                               block=300, device="cpu")
    g_host = NativeHnswGraph(EUC, params)
    g_host.insert_batch([(i, data[i]) for i in range(n)])
    assert _recall(g_dev, data, queries, k=k) >= \
        _recall(g_host, data, queries, k=k) - 0.05


def test_table_invariants():
    data, params, graph = _build(n=700, block=128)
    t = graph.export_padded_tables()
    n = data.shape[0]
    nbr, levels = t["neighbors"], t["levels"]
    assert t["valid"][:n].all()
    assert int(levels.max()) == t["max_level"]
    assert t["entry"] == int(np.argmax(levels == levels.max()))
    for layer in range(t["max_level"] + 1):
        cap_l = params.max_degree(layer)
        lists = nbr[:n, layer, :]
        live = lists >= 0
        assert not live[:, cap_l:].any()
        for slot in range(0, n, 97):
            row = lists[slot][live[slot]]
            if levels[slot] < layer:
                assert row.size == 0
                continue
            assert slot not in row
            assert np.unique(row).size == row.size
            assert (levels[row] >= layer).all()
            assert (row < n).all()


def test_apply_back_edges_keep_closest_semantics():
    rng = np.random.default_rng(0)
    n_tgt, cap_l = 40, 8
    nbr = np.full((n_tgt, cap_l + 4), -1, np.int32)
    aux = np.full((n_tgt, cap_l + 4), np.inf, np.float32)
    ref = {t: [] for t in range(n_tgt)}
    next_src = 1000
    for _ in range(6):
        e = rng.integers(20, 300)
        tgt = rng.integers(0, n_tgt, e).astype(np.int64)
        src = np.arange(next_src, next_src + e, dtype=np.int64)
        next_src += e
        dist = rng.random(e).astype(np.float32)
        _apply_back_edges(nbr, aux, tgt, src, dist, cap_l)
        for t, s, dv in zip(tgt, src, dist):
            ref[int(t)].append((float(dv), int(s)))
            ref[int(t)] = sorted(ref[int(t)])[:cap_l]
    for t in range(n_tgt):
        got = {int(s) for s in nbr[t, :cap_l] if s >= 0}
        assert got == {s for _, s in ref[t]}
        live = nbr[t, :cap_l] >= 0
        by_id = {s: d for d, s in ref[t]}
        for s, d in zip(nbr[t, :cap_l][live], aux[t, :cap_l][live]):
            assert abs(by_id[int(s)] - float(d)) < 1e-6


def test_cosine_zero_vector_raises():
    rng = np.random.default_rng(0)
    data = rng.standard_normal((300, 16)).astype(np.float32)
    data[17] = 0.0
    with pytest.raises(InvalidVectorError):
        build_graph_device(list(enumerate(data)), DistanceMetric.COSINE,
                           HnswParams(seed=0), block=100, device="cpu")


def test_mutations_after_device_build():
    data, params, graph = _build(n=400, d=24, block=100)
    rng = np.random.default_rng(9)
    extra = rng.standard_normal(24).astype(np.float32)
    graph.insert(10_000, extra)
    assert [i for i, _ in graph.search_knn(extra, 5, ef=64)][0] == 10_000
    graph.remove(10_000)
    assert 10_000 not in [i for i, _ in graph.search_knn(extra, 5, ef=64)]
    t = graph.export_padded_tables()
    graph.remove(int(t["id_of_slot"][t["entry"]]))
    assert len(graph.search_knn(data[3], 5, ef=64)) == 5


def test_level_sampling_distribution():
    params = HnswParams(m=16, seed=1)
    lv = sample_levels(200_000, params)
    assert lv.min() == 0 and lv.max() < params.max_layers
    assert abs(float((lv >= 1).mean()) - 1.0 / 16) < 0.01


def test_hnsw_index_bulk_build_device():
    rng = np.random.default_rng(21)
    n, d = 600, 32
    data = rng.standard_normal((n, d)).astype(np.float32)
    idx = HnswIndex(EUC, HnswParams(seed=2), bulk_build="device",
                    device="cpu")
    idx.build_batch(list(enumerate(data)))
    assert len(idx) == n
    assert [i for i, _ in idx.search_with_ef(data[42], 10, 100)][0] == 42
    with pytest.raises(RuntimeError):
        idx.build_batch([(n + 1, data[0])])


def test_hnsw_index_bulk_build_device_duplicate_ids():
    rng = np.random.default_rng(22)
    data = rng.standard_normal((300, 16)).astype(np.float32)
    idx = HnswIndex(EUC, HnswParams(seed=2), bulk_build="device",
                    device="cpu")
    with pytest.raises(ValueError):
        idx.build_batch(list(enumerate(data)) + [(0, data[1])])


def test_small_batch_falls_back_to_host(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("the auto path took the device build")

    monkeypatch.setattr(hbd, "build_device_tables", boom)
    rng = np.random.default_rng(23)
    data = rng.standard_normal((100, 16)).astype(np.float32)
    idx = HnswIndex(EUC, HnswParams(seed=2))
    idx.build_batch(list(enumerate(data)))
    assert len(idx) == 100


def test_forced_device_build_honored_below_min(monkeypatch):
    calls = []
    real = hbd.build_device_tables

    def spy(*args, **kwargs):
        calls.append(kwargs.get("device"))
        return real(*args, **kwargs)

    monkeypatch.setattr(hbd, "build_device_tables", spy)
    rng = np.random.default_rng(24)
    data = rng.standard_normal((60, 16)).astype(np.float32)
    idx = HnswIndex(EUC, HnswParams(seed=2), bulk_build="device",
                    device="cpu")
    idx.build_batch(list(enumerate(data)))
    assert calls == ["cpu"], "forced device mode fell back to the host"
    assert len(idx) == 60
    assert [i for i, _ in idx.search_with_ef(data[17], 5, 64)][0] == 17


def test_tables_import_into_python_graph():
    rng = np.random.default_rng(31)
    n, d = 500, 24
    data = rng.standard_normal((n, d)).astype(np.float32)
    params = HnswParams(m=16, seed=4)
    tables = build_device_tables(np.arange(n, dtype=np.int64), data, EUC,
                                 params, block=128, device="cpu")
    g = HnswGraph(EUC, params)
    g.import_padded_tables(tables)
    assert len(g) == n
    assert [i for i, _ in g.search_knn(data[7], 5, ef=64)][0] == 7


def test_auto_build_needs_a_card(monkeypatch):
    """"auto" takes the device build for a large fresh batch only when the
    index's device is a card (the JAX package's "a TPU backend is
    present"); the threshold is the JAX package's."""
    assert HnswIndex._AUTO_DEVICE_BUILD_MIN == JHnsw._AUTO_DEVICE_BUILD_MIN
    assert hbd.MIN_DEVICE_BUILD == 256 and hbd._DEFAULT_BLOCK == 4096
    items = [(i, None) for i in range(HnswIndex._AUTO_DEVICE_BUILD_MIN)]
    assert HnswIndex(EUC, device="cuda")._device_buildable(items)
    assert not HnswIndex(EUC, device="cpu")._device_buildable(items)
    assert not HnswIndex(EUC, device="cuda")._device_buildable(items[:-1])


def test_build_timing_lines(monkeypatch, capsys):
    monkeypatch.setenv("VDB_TPU_BUILD_TIMING", "1")
    _build(n=300, d=8, block=64)
    out = capsys.readouterr().out
    assert "[build-timing] setup" in out
    assert "[build-timing] layer 0:" in out and "cum wait" in out


# -- the port's tables against the JAX package's ------------------------------

def _f64_dist(metric, x, y):
    x, y = x.astype(np.float64), y.astype(np.float64)
    if metric is DistanceMetric.EUCLIDEAN:
        return float(np.linalg.norm(x - y))
    if metric is DistanceMetric.DOT_PRODUCT:
        return float(-x @ y)
    return float(1.0 - x @ y / np.linalg.norm(x) / np.linalg.norm(y))


def _assert_same_neighbors(got, want, data, metric):
    """Neighbor tables equal entry for entry, except where two candidates
    of a row lie within f32 rounding of each other (their f64 distances
    to the row differ by less than 2^-20 relative): the two packages sum
    the refine's dots in different orders, so such a pair may come out in
    either order. Any other difference fails."""
    bad = np.argwhere(got != want)
    for r, layer in {(int(r), int(l)) for r, l, _ in bad}:
        g, w = got[r, layer], want[r, layer]
        assert sorted(g.tolist()) == sorted(w.tolist()), (r, layer)
        for c in np.nonzero(g != w)[0]:
            dg = _f64_dist(metric, data[r], data[g[c]])
            dw = _f64_dist(metric, data[r], data[w[c]])
            assert abs(dg - dw) <= 2.0 ** -20 * max(abs(dg), abs(dw)), (
                r, layer, c, dg, dw)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("n, block", [(700, 128), (520, 200)])
def test_device_tables_equal_the_jax_packages(metric, n, block):
    rng = np.random.default_rng(3)
    data = rng.standard_normal((n, 32)).astype(np.float32)
    ids = np.arange(100, 100 + n, dtype=np.int64)
    want = jbuild(ids, data, JM(metric.value), JParams(m=16, seed=3),
                  block=block)
    got = build_device_tables(ids, data, metric, HnswParams(m=16, seed=3),
                              block=block, device="cpu")
    assert set(got) == set(want)
    for key in ("levels", "id_of_slot", "valid", "vectors"):
        np.testing.assert_array_equal(got[key], np.asarray(want[key]),
                                      err_msg=key)
    _assert_same_neighbors(got["neighbors"], np.asarray(want["neighbors"]),
                           data, metric)
    assert (got["entry"], got["max_level"]) == (want["entry"],
                                                want["max_level"])
    np.testing.assert_array_equal(got["norms"], np.asarray(want["norms"]))


def test_levels_equal_the_jax_packages():
    from vectordb_tpu.index.hnsw_build_device import sample_levels as jlv
    for seed in (0, 5, 99):
        np.testing.assert_array_equal(
            sample_levels(5000, HnswParams(seed=seed)),
            jlv(5000, JParams(seed=seed)))


# -- tests/test_hnsw_device.py ------------------------------------------------

def build(n, d, metric=EUC, seed=9):
    rng = np.random.default_rng(seed)
    data = rng.random((n, d)).astype(np.float32)
    hnsw = HnswIndex(metric, HnswParams(seed=seed), device="cpu")
    hnsw.build_batch([(i, Vector(data[i])) for i in range(n)])
    return data, hnsw


def test_device_search_recall_vs_flat():
    n, d, k, ef = 1000, 32, 10, 100
    data, hnsw = build(n, d)
    flat = FlatIndex(EUC, device="cpu")
    flat.add_batch([(i, data[i]) for i in range(n)])
    searcher = DeviceHnswSearcher(hnsw.graph, EUC, device="cpu")
    queries = np.random.default_rng(1).random((20, d)).astype(np.float32)
    device_res = searcher.search_batch(queries, k, ef)
    flat_res = flat.search_batch(queries, k)
    total = sum(len({i for i, _ in a} & {i for i, _ in b}) / k
                for a, b in zip(device_res, flat_res))
    assert total / 20 >= 0.90


def test_device_matches_host_hnsw_closely():
    n, d, k, ef = 500, 16, 10, 80
    data, hnsw = build(n, d, seed=21)
    searcher = DeviceHnswSearcher(hnsw.graph, EUC, device="cpu")
    queries = np.random.default_rng(2).random((10, d)).astype(np.float32)
    device_res = searcher.search_batch(queries, k, ef)
    overlap = 0.0
    for qi in range(10):
        host = {i for i, _ in hnsw.search_with_ef(Vector(queries[qi]), k,
                                                  ef)}
        overlap += len(host & {i for i, _ in device_res[qi]}) / k
    assert overlap / 10 >= 0.9


def test_device_search_self_query():
    data, hnsw = build(300, 8, seed=33)
    searcher = DeviceHnswSearcher(hnsw.graph, EUC, device="cpu")
    res = searcher.search_batch(data[:8], 1, 50)
    assert sum(int(res[i] and res[i][0][0] == i) for i in range(8)) >= 7


def test_device_search_distances_sorted_and_finite():
    data, hnsw = build(200, 8, seed=5)
    searcher = DeviceHnswSearcher(hnsw.graph, EUC, device="cpu")
    for row in searcher.search_batch(data[:4], 5, 60):
        assert len(row) == 5
        dists = [dv for _, dv in row]
        assert dists == sorted(dists) and all(np.isfinite(dists))


@pytest.mark.parametrize("metric", [DistanceMetric.COSINE,
                                    DistanceMetric.DOT_PRODUCT])
def test_device_search_other_metrics(metric):
    n, d, k = 300, 16, 5
    data = np.random.default_rng(17).random((n, d)).astype(np.float32) + 0.1
    hnsw = HnswIndex(metric, HnswParams(seed=17), device="cpu")
    hnsw.build_batch([(i, Vector(data[i])) for i in range(n)])
    res = DeviceHnswSearcher(hnsw.graph, metric,
                             device="cpu").search_batch(data[:5], k, 100)
    flat = FlatIndex(metric, device="cpu")
    flat.add_batch([(i, data[i]) for i in range(n)])
    flat_res = flat.search_batch(data[:5], k)
    total = sum(len({i for i, _ in a} & {i for i, _ in b}) / k
                for a, b in zip(res, flat_res))
    assert total / 5 >= 0.8


def test_device_search_after_deletes():
    data, hnsw = build(200, 8, seed=41)
    for i in range(0, 50):
        hnsw.remove(i)
    searcher = DeviceHnswSearcher(hnsw.graph, EUC, device="cpu")
    for row in searcher.search_batch(data[:4], 5, 60):
        assert all(iid >= 50 for iid, _ in row)


def test_store_with_device_hnsw_batch(rng):
    """tests/test_integration.py: store -> HNSW -> device traversal."""
    data = rng.random((300, 16)).astype(np.float32)
    idx = HnswIndex(EUC, HnswParams(seed=8), device="cpu")
    store = VectorStore.with_index(idx)
    for i in range(300):
        store.insert(f"v{i}", Vector(data[i]))
    res = idx.search_batch_device(data[:4], 3, ef=60)
    id_map = store.internal_to_string_ids()
    for qi in range(4):
        assert id_map[res[qi][0][0]] == f"v{qi}"
    # the searcher is cached on the graph version, rebuilt after a write
    first = idx.device_searcher()
    assert idx.device_searcher() is first
    store.insert("extra", Vector(data[5] + 1.0))
    assert idx.device_searcher() is not first


def test_device_traversal_mask(rng):
    """tests/test_filters.py: a masked device search returns only
    eligible rows."""
    idx = HnswIndex(EUC, HnswParams(seed=5), device="cpu")
    data = rng.standard_normal((200, 16)).astype(np.float32)
    idx.build_batch([(i, Vector(data[i])) for i in range(200)])
    mask = np.zeros(idx.capacity, dtype=bool)
    elig_ids = set(range(0, 200, 4))
    for i in elig_ids:
        mask[idx.slot_of(i)] = True
    res = idx.search_batch_device(data[:8] + np.float32(0.01), 5, ef=64,
                                  slot_mask=mask)
    for row in res:
        assert row and all(i in elig_ids for i, _ in row)
    assert res[0][0][0] == 0


def test_empty_graph_answers_nothing():
    idx = HnswIndex(EUC, HnswParams(seed=1), device="cpu")
    idx.add(0, Vector([1.0, 2.0]))
    idx.remove(0)
    out = hnsw_search_device(
        torch.zeros((4, 2)), torch.zeros(4), torch.full((4, 2, 4), -1,
                                                         dtype=torch.int32),
        torch.zeros(4, dtype=torch.bool), torch.zeros(4, dtype=torch.long),
        -1, 0, torch.zeros((3, 2)), "euclidean", 2, 8, 2)
    assert bool(torch.isinf(out[0]).all()) and bool((out[1] == -1).all())


# -- the port's traversal against the JAX package's ---------------------------

def _jax_graph(metric, n, d, seed, removed=()):
    rng = np.random.default_rng(seed)
    data = rng.random((n, d)).astype(np.float32) + 0.05
    j = JHnsw(JM(metric.value), JParams(seed=seed))
    j.graph.insert_batch([(i, data[i]) for i in range(n)], n_threads=1)
    for i in removed:
        j.remove(i)
    t = j.graph.export_padded_tables()
    g = NativeHnswGraph(metric, HnswParams(seed=seed))
    g.import_padded_tables(t)
    return j, g, rng


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("masked", [False, True])
def test_traversal_equals_the_jax_packages(metric, masked):
    j, g, rng = _jax_graph(metric, 700, 24, 9, removed=range(0, 60, 7))
    queries = rng.random((24, 24)).astype(np.float32)
    mask = (rng.random(g.capacity) < 0.4) if masked else None
    for ef, k in ((10, 10), (40, 5), (120, 10)):
        want = JSearcher(j.graph, JM(metric.value)).search_batch(
            queries, k, ef, slot_mask=mask)
        got = DeviceHnswSearcher(g, metric, device="cpu").search_batch(
            queries, k, ef, slot_mask=mask)
        for w, t in zip(want, got):
            assert [i for i, _ in t] == [i for i, _ in w]
            np.testing.assert_allclose([dv for _, dv in t],
                                       [dv for _, dv in w], rtol=1e-5,
                                       atol=1e-6)


def test_traversal_with_duplicate_edges_equals_the_jax_packages():
    """The first-occurrence guard: a repeated id in one adjacency row is
    scored and marked visited once, in both packages."""
    import jax.numpy as jnp

    from vectordb_tpu.ops.hnsw_device import hnsw_search_device as jsearch
    j, g, rng = _jax_graph(EUC, 400, 16, 4)
    t = j.graph.export_padded_tables()
    nb = t["neighbors"].copy()
    rows = np.nonzero((nb[:, 0, 0] >= 0) & (nb[:, 0, 1] >= 0))[0]
    nb[rows, 0, 2] = nb[rows, 0, 0]
    queries = rng.random((12, 16)).astype(np.float32)
    wd, wi = jsearch(jnp.asarray(t["vectors"]), jnp.asarray(t["norms"]),
                     jnp.asarray(nb), jnp.asarray(t["valid"]),
                     jnp.asarray(t["id_of_slot"].astype(np.int32)),
                     jnp.asarray(t["entry"], dtype=jnp.int32),
                     jnp.asarray(t["max_level"], dtype=jnp.int32),
                     jnp.asarray(queries), "euclidean", 8, 30, 16)
    gd, gi = hnsw_search_device(
        torch.from_numpy(t["vectors"]), torch.from_numpy(t["norms"]),
        torch.from_numpy(nb), torch.from_numpy(t["valid"]),
        torch.from_numpy(t["id_of_slot"]), t["entry"], t["max_level"],
        torch.from_numpy(queries), "euclidean", 8, 30, 16)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=1e-5)


def test_device_built_graph_answers_as_the_jax_packages():
    """The slice as a whole: the same rows through both packages' device
    builds and device traversals."""
    rng = np.random.default_rng(12)
    data = rng.standard_normal((900, 32)).astype(np.float32)
    queries = rng.standard_normal((16, 32)).astype(np.float32)
    j = JHnsw(JM.EUCLIDEAN, JParams(seed=12), bulk_build="device")
    j.build_batch(list(enumerate(data)))
    t = HnswIndex(EUC, HnswParams(seed=12), bulk_build="device",
                  device="cpu")
    t.build_batch(list(enumerate(data)))
    want = j.search_batch_device(queries, 10, ef=64)
    got = t.search_batch_device(queries, 10, ef=64)
    for w, g in zip(want, got):
        assert [i for i, _ in g] == [i for i, _ in w]
        np.testing.assert_allclose([dv for _, dv in g], [dv for _, dv in w],
                                   rtol=1e-5)
    jf = JFlat(JM.EUCLIDEAN)
    jf.add_batch(list(enumerate(data)))
    truth = jf.search_batch(queries, 10)
    rec = np.mean([len({i for i, _ in a} & {i for i, _ in b}) / 10
                   for a, b in zip(got, truth)])
    assert rec >= 0.9
