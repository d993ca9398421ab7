"""The port's mesh against the JAX package's, on the CPU.

Mirrors tests/test_distributed.py case by case. The JAX side runs on
conftest.py's 8-device virtual CPU mesh (``make_mesh(8)``), its coarse
kernels in Pallas interpret mode, as its own tests run them; the port runs
on ``make_mesh(8, devices=["cpu"] * 8)`` (a mesh repeating one device),
its kernels as their plain versions. Each case feeds the same numpy inputs
to both and asks for the same ids on tie-free data, distances at rtol
2e-5 and the same certified flags, beside the JAX test's own checks.
Both packages take the per-shard coarse route here: the port has it on
every device, the JAX package in interpret mode.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import vectordb_tpu as J
from vectordb_tpu import parallel as jpar
from vectordb_tpu.distance import pairwise_distances as jdist
from vectordb_tpu.index.pq import PqFlatIndex as JPq
from vectordb_tpu.parallel import distributed as jdist_mod
from vectordb_tpu.persistence import EngineConfig as JEngineConfig
from vectordb_tpu.persistence import StorageEngine as JEngine

import vectordb_tpu_torch as T
from vectordb_tpu_torch import parallel as tpar
from vectordb_tpu_torch.index.pq import PqFlatIndex
from vectordb_tpu_torch.ops import coarse_kernel as tck
from vectordb_tpu_torch.parallel import distributed as tdist_mod
from vectordb_tpu_torch.persistence import EngineConfig, StorageEngine

torch.set_num_threads(1)
METRICS = ["euclidean", "dot_product", "cosine"]


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("VDB_TPU_PALLAS_INTERPRET", "1")


@pytest.fixture(scope="module")
def meshes():
    return jpar.make_mesh(8), tpar.make_mesh(8, devices=["cpu"] * 8)


@pytest.fixture(scope="module")
def meshes2d():
    return (jpar.make_mesh(8, axis_names=("shard", "batch"), shape=(4, 2)),
            tpar.make_mesh(8, axis_names=("shard", "batch"), shape=(4, 2),
                           devices=["cpu"] * 8))


def _rng(seed):
    return np.random.default_rng(seed)


def _oracle(q, db, metric):
    return jdist(np, q, db, J.DistanceMetric(metric))


def _same(jres, tres, rtol=2e-5, atol=2e-5):
    """(id, dist) rows: equal ids, distances at ``rtol``."""
    assert [[i for i, _ in row] for row in tres] == \
        [[i for i, _ in row] for row in jres]
    np.testing.assert_allclose([d for row in tres for _, d in row],
                               [d for row in jres for _, d in row],
                               rtol=rtol, atol=atol)


def _same_hits(jres, tres, rtol=2e-5, atol=2e-5):
    """SearchResult rows: equal ids, distances at ``rtol``."""
    _same([[(h.id, h.distance) for h in row] for row in jres],
          [[(h.id, h.distance) for h in row] for row in tres], rtol, atol)


def _dist_pair(meshes, metric="euclidean", **kw):
    jm, tm = meshes
    return (jpar.DistributedFlatIndex(jm, J.DistanceMetric(metric), **kw),
            tpar.DistributedFlatIndex(tm, T.DistanceMetric(metric), **kw))


def _spy(monkeypatch, module, name, record):
    real = getattr(module, name)

    def spy(*a, **kw):
        record.append(kw)
        return real(*a, **kw)

    monkeypatch.setattr(module, name, spy)


# ---------------------------------------------------------------------------
# the mesh and shard_rows
# ---------------------------------------------------------------------------

def test_make_mesh_shapes():
    cpu8 = ["cpu"] * 8
    m = tpar.make_mesh(8, devices=cpu8)
    assert m.shape == jpar.make_mesh(8).shape == {"shard": 8}
    m2 = tpar.make_mesh(8, axis_names=("a", "b"), shape=(2, 4), devices=cpu8)
    assert m2.shape == {"a": 2, "b": 4}
    assert m2.shape == jpar.make_mesh(8, axis_names=("a", "b"),
                                      shape=(2, 4)).shape
    assert m2.devices.shape == (2, 4) and len(list(m2.devices.flat)) == 8
    with pytest.raises(ValueError):
        tpar.make_mesh(9, devices=cpu8)
    with pytest.raises(ValueError):
        jpar.make_mesh(9)
    with pytest.raises(ValueError):
        tpar.make_mesh(8, shape=(3,), devices=cpu8)
    with pytest.raises(ValueError):
        tpar.make_mesh(8, axis_names=("a",), shape=(2, 4), devices=cpu8)
    if not torch.cuda.is_available():
        # the default pool is the visible CUDA devices: none here
        with pytest.raises(ValueError, match="only 0 present"):
            tpar.make_mesh(1)


def test_shard_rows_pads_and_shards(meshes):
    jm, tm = meshes
    arr = np.arange(10 * 4, dtype=np.float32).reshape(10, 4)
    flags = np.ones(10, dtype=bool)
    padded, darr, dflags = tpar.shard_rows(tm, "shard", arr, flags)
    jpadded, jarr, jflags = jpar.shard_rows(jm, "shard", arr, flags)
    assert padded == jpadded == 16
    assert len(darr) == 8 and all(t.shape == (2, 4) for t in darr)
    np.testing.assert_array_equal(torch.cat(darr).numpy(), np.asarray(jarr))
    np.testing.assert_array_equal(torch.cat(dflags).numpy(),
                                  np.asarray(jflags))
    assert not torch.cat(dflags)[10:].any()     # bool pads False
    padded, blocks = tpar.shard_rows(tm, "shard", arr, block_multiple=1024)
    assert padded == jpar.shard_rows(jm, "shard", arr,
                                     block_multiple=1024)[0] == 8192


# ---------------------------------------------------------------------------
# DistributedFlatIndex
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("metric", METRICS)
def test_distributed_matches_oracle(meshes, metric):
    rng = _rng(1)
    n, d, q, k = 1000, 32, 5, 10
    db = rng.standard_normal((n, d)).astype(np.float32) + 2.0
    queries = rng.standard_normal((q, d)).astype(np.float32) + 2.0
    jix, tix = _dist_pair(meshes, metric)
    jix.load(db)
    tix.load(db)
    tres = tix.search_batch(queries, k)
    _same(jix.search_batch(queries, k), tres)
    oracle = _oracle(queries, db, metric)
    for qi in range(q):
        np.testing.assert_allclose([r[1] for r in tres[qi]],
                                   np.sort(oracle[qi])[:k], rtol=1e-4,
                                   atol=1e-4)
        assert [r[0] for r in tres[qi]] == list(
            np.argsort(oracle[qi], kind="stable")[:k])


def test_distributed_matches_single_chip_flat(meshes):
    """Sharded result == single-device FlatIndex result (both packages)."""
    rng = _rng(2)
    n, d, k = 512, 16, 7
    db = rng.standard_normal((n, d)).astype(np.float32)
    queries = rng.standard_normal((3, d)).astype(np.float32)
    flat = T.FlatIndex(T.DistanceMetric.EUCLIDEAN, device="cpu")
    flat.add_batch([(i, db[i]) for i in range(n)])
    single = flat.search_batch(queries, k)
    jix, tix = _dist_pair(meshes)
    jix.load(db)
    tix.load(db)
    multi = tix.search_batch(queries, k)
    _same(single, multi, rtol=1e-5, atol=1e-5)
    _same(jix.search_batch(queries, k), multi)


def test_k_larger_than_shard_block(meshes):
    """k greater than the rows a shard holds still returns n results."""
    rng = _rng(3)
    n, d = 16, 8    # 2 live rows per shard
    db = rng.standard_normal((n, d)).astype(np.float32)
    jix, tix = _dist_pair(meshes)
    jix.load(db)
    tix.load(db)
    tres = tix.search_batch(db[:1], 12)
    assert len(tres[0]) == 12 and tres[0][0][0] == 0
    jres = jix.search_batch(db[:1], 12)
    assert [i for i, _ in tres[0]] == [i for i, _ in jres[0]]
    # self-distance: both sides carry ~1e-3 of |q|^2+|x|^2-2qx noise
    np.testing.assert_allclose([x for _, x in tres[0][1:]],
                               [x for _, x in jres[0][1:]], rtol=2e-5)


def test_2d_mesh_query_batch_sharding(meshes2d):
    """Rows sharded over 'shard', the query batch over 'batch'."""
    rng = _rng(4)
    n, d, k = 256, 16, 5
    db = rng.standard_normal((n, d)).astype(np.float32)
    queries = db[:6]  # self queries
    jix, tix = _dist_pair(meshes2d, row_axis="shard", batch_axis="batch")
    jix.load(db)
    tix.load(db)
    tres = tix.search_batch(queries, k)
    jres = jix.search_batch(queries, k)
    for qi in range(6):
        assert tres[qi][0][0] == qi
        assert tres[qi][0][1] == pytest.approx(0.0, abs=5e-3)
        assert [i for i, _ in tres[qi]] == [i for i, _ in jres[qi]]
        np.testing.assert_allclose([x for _, x in tres[qi][1:]],
                                   [x for _, x in jres[qi][1:]], rtol=2e-5)


def test_collectives_actually_sharded(meshes):
    """The loaded rows live as one block per shard, one per device slot
    of the mesh, with the JAX package's block rows."""
    rng = _rng(5)
    db = rng.standard_normal((800, 16)).astype(np.float32)
    jix, tix = _dist_pair(meshes)
    jix.load(db)
    tix.load(db)
    blocks = tix._device[0]
    assert len(blocks) == 8
    assert [t.device for t in blocks] == list(meshes[1].devices.flat)
    jshapes = {s.data.shape for s in jix._device[0].addressable_shards}
    assert {tuple(t.shape) for t in blocks} == jshapes == {(1024, 16)}
    np.testing.assert_array_equal(torch.cat(blocks).numpy(),
                                  np.asarray(jix._device[0]))


# ---------------------------------------------------------------------------
# ShardedHnswIndex
# ---------------------------------------------------------------------------

def _hnsw_pair(n_shards, seed, data):
    from vectordb_tpu.parallel import ShardedHnswIndex as JSharded
    j = JSharded(n_shards, J.DistanceMetric.EUCLIDEAN,
                 J.HnswParams(seed=seed))
    t = tpar.ShardedHnswIndex(n_shards, T.DistanceMetric.EUCLIDEAN,
                              T.HnswParams(seed=seed))
    j.build_batch([(i, J.Vector(data[i])) for i in range(len(data))])
    t.build_batch([(i, T.Vector(data[i])) for i in range(len(data))])
    return j, t


def test_sharded_hnsw_recall():
    rng = _rng(6)
    n, d, k = 1000, 32, 10
    data = rng.random((n, d)).astype(np.float32)
    j, t = _hnsw_pair(4, 2, data)
    assert len(t) == len(j) == n
    flat = T.FlatIndex(T.DistanceMetric.EUCLIDEAN, device="cpu")
    flat.add_batch([(i, data[i]) for i in range(n)])
    queries = rng.random((15, d)).astype(np.float32)
    flat_res = flat.search_batch(queries, k)
    total = jtotal = 0.0
    for qi in range(15):
        got = t.search(T.Vector(queries[qi]), k, ef=100)
        jgot = j.search(J.Vector(queries[qi]), k, ef=100)
        expect = {iid for iid, _ in flat_res[qi]}
        total += len({i for i, _ in got} & expect) / k
        jtotal += len({i for i, _ in jgot} & expect) / k
        # the same seeds build the same graphs: the same answers
        _same([jgot], [got], rtol=1e-5, atol=1e-5)
    assert total / 15 >= 0.90 and jtotal / 15 >= 0.90


def test_sharded_hnsw_remove():
    data = _rng(7).random((40, 8)).astype(np.float32)
    j, t = _hnsw_pair(4, 4, data)
    t.remove(13)
    j.remove(13)
    assert len(t) == 39
    res = t.search(T.Vector(data[13]), 3)
    assert all(iid != 13 for iid, _ in res)
    _same([j.search(J.Vector(data[13]), 3)], [res], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        [len(r) for r in t.search_batch(data[:5], 3)], [3] * 5)


# ---------------------------------------------------------------------------
# the sharded store (FlatIndex(mesh=...))
# ---------------------------------------------------------------------------

def _store_pair(meshes, metric="euclidean", storage="f32"):
    jm, tm = meshes
    return (J.VectorStore.with_sharded_flat_index(J.DistanceMetric(metric),
                                                  jm, storage=storage),
            T.VectorStore.with_sharded_flat_index(T.DistanceMetric(metric),
                                                  tm, storage=storage))


def _insert_both(js, ts, data, meta=None):
    for i in range(len(data)):
        m = meta(i) if meta else {}
        js.insert_with_metadata(f"v{i}", J.Vector(data[i]), J.Metadata(m))
        ts.insert_with_metadata(f"v{i}", T.Vector(data[i]), T.Metadata(m))


class TestShardedStore:
    """Full VectorStore (CRUD + metadata + exact filters) on a mesh."""

    def test_sharded_store_crud_and_search(self, meshes):
        rng = _rng(8)
        js, ts = _store_pair(meshes)
        data = rng.standard_normal((300, 16)).astype(np.float32)
        _insert_both(js, ts, data, lambda i: {"par": str(i % 2)})
        assert len(ts) == len(js) == 300
        hits = ts.search(T.Vector(data[42]), 3)
        assert hits[0].id == "v42"
        # upsert + delete against sharded storage
        for s, mod in ((js, J), (ts, T)):
            s.insert("v42", mod.Vector(-data[42]))
        assert ts.search(T.Vector(data[42]), 1)[0].id != "v42"
        js.delete("v0")
        ts.delete("v0")
        assert len(ts) == 299
        assert all(h.id != "v0" for h in ts.search(T.Vector(data[0]), 5))
        q = rng.standard_normal((4, 16)).astype(np.float32)
        _same_hits(js.search_batch([(J.Vector(x), 5) for x in q]),
                   ts.search_batch([(T.Vector(x), 5) for x in q]))
        # the slot layout is the JAX package's
        jv, jvalid, jids = js.index.packed_arrays()
        tv, tvalid, tids = ts.index.packed_arrays()
        assert ts.index.capacity == js.index.capacity == 8192
        np.testing.assert_array_equal(tvalid, jvalid)
        np.testing.assert_array_equal(tids, jids)
        np.testing.assert_array_equal(tv, jv)

    def test_sharded_store_exact_filtered_search(self, meshes):
        rng = _rng(9)
        js, ts = _store_pair(meshes)
        data = rng.standard_normal((200, 8)).astype(np.float32)
        _insert_both(js, ts, data,
                     lambda i: {"tag": "rare" if i >= 195 else "common"})
        q = rng.standard_normal(8).astype(np.float32)
        hits = ts.search_with_filter(T.Vector(q), 5,
                                     T.MetadataFilter.eq("tag", "rare"))
        assert {h.id for h in hits} == {f"v{i}" for i in range(195, 200)}
        _same_hits([js.search_with_filter(
            J.Vector(q), 5, J.MetadataFilter.eq("tag", "rare"))], [hits])
        # a broad filter runs the masked sharded search
        _same_hits([js.search_with_filter(
            J.Vector(q), 7, J.MetadataFilter.eq("tag", "common"))],
            [ts.search_with_filter(T.Vector(q), 7,
                                   T.MetadataFilter.eq("tag", "common"))])

    def test_sharded_store_matches_single_device(self, meshes):
        rng = _rng(10)
        data = rng.standard_normal((256, 12)).astype(np.float32)
        single = T.VectorStore.with_flat_index(T.DistanceMetric.COSINE,
                                               device="cpu")
        js, ts = _store_pair(meshes, "cosine")
        for i in range(256):
            single.insert(f"v{i}", T.Vector(data[i]))
        _insert_both(js, ts, data)
        queries = [data[i] + 0.01 for i in range(4)]
        res_s = single.search_batch([(T.Vector(x), 5) for x in queries])
        res_m = ts.search_batch([(T.Vector(x), 5) for x in queries])
        _same_hits(res_s, res_m, rtol=1e-4, atol=1e-5)
        _same_hits(js.search_batch([(J.Vector(x), 5) for x in queries]),
                   res_m, atol=1e-6)

    def test_sharded_arrays_live_on_all_devices(self, meshes):
        rng = _rng(11)
        js, ts = _store_pair(meshes)
        data = rng.standard_normal((100, 8)).astype(np.float32)
        _insert_both(js, ts, data)
        ts.search(T.Vector(data[0]), 1)  # forces the sync
        dev = ts.index._device
        assert [t.device for t in dev["db"]] == list(meshes[1].devices.flat)
        js.search(J.Vector(data[0]), 1)
        jdb = js.index._device["db"]
        assert len(jdb.sharding.device_set) == 8
        np.testing.assert_array_equal(torch.cat(dev["db"]).numpy(),
                                      np.asarray(jdb))
        for key in ("sq_norms", "norms", "valid"):
            np.testing.assert_array_equal(
                torch.cat(dev[key]).numpy(),
                np.asarray(js.index._device[key]))
        np.testing.assert_allclose(float(dev["elo_max"]),
                                   float(js.index._device["elo_max"]),
                                   rtol=1e-6)


def _engine_rows(tmp_path, data, n_snap, storage="f32", index_type="flat"):
    """A JAX engine directory: n_snap rows checkpointed, the rest in the
    WAL tail, one delete."""
    with JEngine.open(tmp_path, JEngineConfig(index_type=index_type,
                                              storage=storage)) as eng:
        eng.insert_batch([J.BatchInsertItem(f"v{i}", J.Vector(data[i]))
                          for i in range(n_snap)])
        eng.checkpoint()
        for i in range(n_snap, len(data)):
            eng.insert(f"v{i}", J.Vector(data[i]))
        eng.delete("v0")


def _copy_dir(src, dst):
    import shutil
    shutil.copytree(src, dst)
    return dst


def test_engine_recovery_hydrates_sharded_devices(meshes, tmp_path):
    """Crash-recover a WAL+snapshot database into mesh-sharded device
    storage; the port reopens the JAX package's directory and answers as
    the JAX package's mesh reopen does."""
    jm, tm = meshes
    data = _rng(12).standard_normal((200, 16)).astype(np.float32)
    _engine_rows(tmp_path / "a", data, 150)
    _copy_dir(tmp_path / "a", tmp_path / "b")
    q = _rng(13).standard_normal((3, 16)).astype(np.float32)
    with StorageEngine.open(tmp_path / "a", EngineConfig(mesh=tm)) as eng, \
            JEngine.open(tmp_path / "b", JEngineConfig(mesh=jm)) as jeng:
        assert len(eng) == len(jeng) == 199
        hits = eng.search(T.Vector(data[123]), 1)
        assert hits[0].id == "v123"
        dev = eng.store.index._device
        assert [t.device for t in dev["db"]] == list(tm.devices.flat)
        assert all(h.id != "v0" for h in eng.search(T.Vector(data[0]), 5))
        _same_hits([jeng.search(J.Vector(x), 5) for x in q],
                   [eng.search(T.Vector(x), 5) for x in q])


# ---------------------------------------------------------------------------
# the per-shard certified coarse route
# ---------------------------------------------------------------------------

class TestShardedCoarse:
    """Sharded 1-pass certified coarse path (make_sharded_search_coarse)."""

    @pytest.mark.parametrize("metric", METRICS)
    def test_matches_oracle_and_engages(self, meshes, metric, monkeypatch):
        rng = _rng(14)
        n, d, q, k = 3000, 32, 6, 10
        db = rng.standard_normal((n, d)).astype(np.float32) + 2.0
        queries = rng.standard_normal((q, d)).astype(np.float32) + 2.0
        calls, jcalls = [], []
        _spy(monkeypatch, tck, "coarse_search_1p", calls)
        _spy(monkeypatch, jdist_mod, "make_sharded_search_coarse", jcalls)
        jix, tix = _dist_pair(meshes, metric)
        jix.load(db)
        tix.load(db)
        assert tix._elo_max is not None and tix._block_rows % 1024 == 0
        assert tix._block_rows == jix._block_rows
        np.testing.assert_allclose(float(tix._elo_max),
                                   float(jix._elo_max), rtol=1e-6)
        tres = tix.search_batch(queries, k)
        # one coarse pipeline per shard
        assert len(calls) == 8, "the coarse route should have run per shard"
        oracle = _oracle(queries, db, metric)
        for qi in range(q):
            assert [r[0] for r in tres[qi]] == [
                int(w) for w in np.argsort(oracle[qi], kind="stable")[:k]]
        _same(jix.search_batch(queries, k), tres, atol=1e-6)
        assert jcalls, "the JAX side took its coarse route too"
        # the certified flags, shard AND shard, equal the JAX package's
        cq = np.concatenate([queries, np.zeros((2, d), np.float32)])
        _, _, cert = tix._coarse_searcher(k)(cq, *tix._device, tix._elo_max)
        _, _, jcert = jix._coarse_searcher(k)(jnp.asarray(cq), *jix._device,
                                              jix._elo_max)
        np.testing.assert_array_equal(cert.numpy(), np.asarray(jcert))

    def test_uncertified_falls_back_exact(self, meshes):
        rng = _rng(15)
        n, d, q, k = 2048, 16, 4, 5
        db = rng.standard_normal((n, d)).astype(np.float32)
        queries = rng.standard_normal((q, d)).astype(np.float32)
        jix, tix = _dist_pair(meshes)
        jix.load(db)
        tix.load(db)
        tix._elo_max = torch.tensor(1e9)   # absurd bound: nothing certifies
        jix._elo_max = jnp.float32(1e9)
        cq = queries
        _, _, cert = tix._coarse_searcher(k)(cq, *tix._device, tix._elo_max)
        assert not cert.any()
        tres = tix.search_batch(queries, k)
        oracle = _oracle(queries, db, "euclidean")
        for qi in range(q):
            assert [r[0] for r in tres[qi]] == [
                int(w) for w in np.argsort(oracle[qi], kind="stable")[:k]]
        _same(jix.search_batch(queries, k), tres)

    def test_padding_rows_never_surface(self, meshes):
        rng = _rng(16)
        n, d, k = 1000, 8, 10   # 8 x 1024 blocks: 7192 dead rows
        db = rng.standard_normal((n, d)).astype(np.float32)
        jix, tix = _dist_pair(meshes)
        jix.load(db)
        tix.load(db)
        q = rng.standard_normal((3, d)).astype(np.float32)
        res = tix.search_batch(q, k)
        for row in res:
            assert len(row) == k
            assert all(0 <= rid < n for rid, _ in row)
        _same(jix.search_batch(q, k), res)


class TestShardedStoreCoarse:
    """Store-level sharded serving through the per-shard certified
    route: the store engages the same pipeline as DistributedFlatIndex."""

    def test_store_sharded_search_engages_coarse(self, meshes, monkeypatch):
        calls = []
        _spy(monkeypatch, tdist_mod, "make_sharded_search_coarse", calls)
        rng = _rng(17)
        n, d, k = 500, 16, 10
        data = rng.standard_normal((n, d)).astype(np.float32)
        js, ts = _store_pair(meshes)
        js.insert_batch([J.BatchInsertItem(f"v{i}", J.Vector(data[i]))
                         for i in range(n)])
        ts.insert_batch([T.BatchInsertItem(f"v{i}", T.Vector(data[i]))
                         for i in range(n)])
        qs = [data[i] + 0.01 for i in range(4)]
        res = ts.search_batch([(T.Vector(x), k) for x in qs])
        assert [c.get("src") for c in calls] == ["f32"], calls
        oracle = _oracle(np.stack(qs), data, "euclidean")
        for qi in range(4):
            assert [h.id for h in res[qi]] == [
                f"v{int(w)}" for w in np.argsort(oracle[qi],
                                                 kind="stable")[:k]]
        # near-self distances (~0.04) carry ~5e-5 of |q|^2+|x|^2-2qx noise
        _same_hits(js.search_batch([(J.Vector(x), k) for x in qs]), res,
                   atol=1e-4)

    def test_store_sharded_bf16_exact_over_stored(self, meshes):
        import ml_dtypes
        rng = _rng(18)
        n, d, k = 400, 16, 5
        data = rng.standard_normal((n, d)).astype(np.float32)
        js, ts = _store_pair(meshes, storage="bf16")
        _insert_both(js, ts, data)
        with ts.index._lock:
            dev = ts.index._sync_device()
        assert all(t.dtype == torch.bfloat16 for t in dev["db"])
        assert bool(dev.get("bf16_storage"))
        stored = data.astype(ml_dtypes.bfloat16).astype(np.float32)
        q = rng.standard_normal((3, d)).astype(np.float32)
        res = ts.search_batch([(T.Vector(x), k) for x in q])
        oracle = _oracle(q, stored, "euclidean")
        for qi in range(3):
            assert [h.id for h in res[qi]] == [
                f"v{int(w)}" for w in np.argsort(oracle[qi],
                                                 kind="stable")[:k]]
            np.testing.assert_allclose(
                [h.distance for h in res[qi]],
                np.sort(oracle[qi], kind="stable")[:k], rtol=1e-3,
                atol=1e-3)
        _same_hits(js.search_batch([(J.Vector(x), k) for x in q]), res)

    def test_2d_mesh_coarse_engages_and_matches(self, meshes2d, monkeypatch):
        calls = []
        _spy(monkeypatch, tdist_mod, "make_sharded_search_coarse", calls)
        rng = _rng(19)
        n, d, q, k = 2000, 16, 8, 10
        db = rng.standard_normal((n, d)).astype(np.float32)
        queries = rng.standard_normal((q, d)).astype(np.float32)
        jix, tix = _dist_pair(meshes2d, row_axis="shard",
                              batch_axis="batch")
        jix.load(db)
        tix.load(db)
        results = tix.search_batch(queries, k)
        assert [c.get("batch_axis") for c in calls] == ["batch"], calls
        oracle = _oracle(queries, db, "euclidean")
        for qi in range(q):
            assert [r[0] for r in results[qi]] == [
                int(w) for w in np.argsort(oracle[qi], kind="stable")[:k]]
        _same(jix.search_batch(queries, k), results)

    def test_distributed_bf16_storage_matches_oracle(self, meshes):
        import ml_dtypes
        rng = _rng(20)
        n, d, q, k = 2000, 16, 6, 10
        db = rng.standard_normal((n, d)).astype(np.float32)
        queries = rng.standard_normal((q, d)).astype(np.float32)
        jix, tix = _dist_pair(meshes, storage="bf16")
        jix.load(db)
        tix.load(db)
        assert tix._device[0][0].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            torch.cat(tix._device[0]).float().numpy(),
            np.asarray(jix._device[0]).astype(np.float32))
        stored = db.astype(ml_dtypes.bfloat16).astype(np.float32)
        results = tix.search_batch(queries, k)
        oracle = _oracle(queries, stored, "euclidean")
        for qi in range(q):
            assert [r[0] for r in results[qi]] == [
                int(w) for w in np.argsort(oracle[qi], kind="stable")[:k]]
        _same(jix.search_batch(queries, k), results)


class TestShardedInt8:
    """int8 storage on the mesh: exact over the stored pow2-quantized
    values, per shard, with the distributed merge."""

    @staticmethod
    def _stored(db):
        from vectordb_tpu_torch.index.flat import _quantize_int8
        return _quantize_int8(db)

    def test_distributed_int8_storage_matches_oracle(self, meshes):
        rng = _rng(21)
        n, d, q, k = 2000, 16, 6, 10
        db = rng.standard_normal((n, d)).astype(np.float32)
        queries = rng.standard_normal((q, d)).astype(np.float32)
        jix, tix = _dist_pair(meshes, storage="int8")
        jix.load(db)
        tix.load(db)
        assert tix._device[0][0].dtype == torch.int8
        assert tix._scales is not None
        np.testing.assert_array_equal(torch.cat(tix._device[0]).numpy(),
                                      np.asarray(jix._device[0]))
        np.testing.assert_array_equal(torch.cat(tix._scales).numpy(),
                                      np.asarray(jix._scales))
        stored = self._stored(db)
        results = tix.search_batch(queries, k)
        oracle = _oracle(queries, stored, "euclidean")
        for qi in range(q):
            assert [r[0] for r in results[qi]] == [
                int(w) for w in np.argsort(oracle[qi], kind="stable")[:k]]
            np.testing.assert_allclose(
                [r[1] for r in results[qi]],
                np.sort(oracle[qi], kind="stable")[:k], rtol=1e-5,
                atol=1e-5)
        _same(jix.search_batch(queries, k), results)

    def test_distributed_int8_xla_fallback_exact(self, meshes):
        rng = _rng(22)
        n, d, q, k = 2048, 16, 4, 5
        db = rng.standard_normal((n, d)).astype(np.float32)
        queries = rng.standard_normal((q, d)).astype(np.float32)
        jix, tix = _dist_pair(meshes, storage="int8")
        jix.load(db)
        tix.load(db)
        tix._elo_max = torch.tensor(1e9)   # nothing certifies: exact scan
        jix._elo_max = jnp.float32(1e9)
        results = tix.search_batch(queries, k)
        oracle = _oracle(queries, self._stored(db), "euclidean")
        for qi in range(q):
            assert [r[0] for r in results[qi]] == [
                int(w) for w in np.argsort(oracle[qi], kind="stable")[:k]]
        _same(jix.search_batch(queries, k), results)

    @pytest.mark.parametrize("metric", METRICS)
    def test_store_sharded_int8_exact_over_stored(self, meshes, metric,
                                                  monkeypatch):
        calls = []
        _spy(monkeypatch, tdist_mod, "make_sharded_search_coarse", calls)
        rng = _rng(23)
        n, d, k = 400, 16, 5
        data = rng.standard_normal((n, d)).astype(np.float32) + 1.0
        js, ts = _store_pair(meshes, metric, storage="int8")
        assert isinstance(ts.index, T.FlatIndex)
        _insert_both(js, ts, data)
        with ts.index._lock:
            dev = ts.index._sync_device()
        assert all(t.dtype == torch.int8 for t in dev["db"])
        assert bool(dev.get("int8_storage"))
        q = rng.standard_normal((3, d)).astype(np.float32) + 1.0
        res = ts.search_batch([(T.Vector(x), k) for x in q])
        assert "int8" in [c.get("src") for c in calls], calls
        oracle = _oracle(q, self._stored(data), metric)
        for qi in range(3):
            assert [h.id for h in res[qi]] == [
                f"v{int(w)}" for w in np.argsort(oracle[qi],
                                                 kind="stable")[:k]]
            np.testing.assert_allclose(
                [h.distance for h in res[qi]],
                np.sort(oracle[qi], kind="stable")[:k], rtol=1e-4,
                atol=1e-4)
        _same_hits(js.search_batch([(J.Vector(x), k) for x in q]), res,
                   atol=1e-6)

    def test_store_sharded_int8_crud_resync(self, meshes):
        """Mutations after the first sync re-put the dirty shard; deletes
        never resurface; upserts see the fresh values."""
        rng = _rng(24)
        n, d, k = 300, 16, 5
        data = rng.standard_normal((n, d)).astype(np.float32)
        js, ts = _store_pair(meshes, storage="int8")
        _insert_both(js, ts, data)
        ts.search_batch([(T.Vector(data[0]), k)])   # first sync
        js.search_batch([(J.Vector(data[0]), k)])
        for s, mod in ((js, J), (ts, T)):
            s.delete("v1")
            s.insert("v5", mod.Vector(data[5] + 2.5))   # upsert
        q = rng.standard_normal((2, d)).astype(np.float32)
        res = ts.search_batch([(T.Vector(x), k) for x in q])
        assert ts.index.mesh_pieces_put == [0]
        stored = self._stored(np.concatenate(
            [data[:1], data[2:5], data[6:],
             self._stored(data[5] + 2.5)[None]]))
        ids = (["v0"] + [f"v{i}" for i in range(2, 5)]
               + [f"v{i}" for i in range(6, n)] + ["v5"])
        oracle = _oracle(q, stored, "euclidean")
        for qi in range(2):
            assert [h.id for h in res[qi]] == [
                ids[int(w)] for w in np.argsort(oracle[qi],
                                                kind="stable")[:k]]
            assert all(h.id != "v1" for h in res[qi])
        _same_hits(js.search_batch([(J.Vector(x), k) for x in q]), res)

    def test_sharded_int8_filtered_search_exact(self, meshes):
        """The filter ANDs into each shard's validity; the masked merge
        stays exact over the stored values."""
        rng = _rng(25)
        n, d, k = 256, 16, 4
        data = rng.standard_normal((n, d)).astype(np.float32)
        js, ts = _store_pair(meshes, storage="int8")
        _insert_both(js, ts, data, lambda i: {"par": str(i % 2)})
        stored = self._stored(data)
        elig = np.arange(0, n, 2)
        q = data[10] + 0.01
        d2 = np.sum((stored[elig] - q) ** 2, axis=1)
        want = [f"v{elig[j]}" for j in np.argsort(d2, kind="stable")[:k]]
        got = ts.search_with_filter(T.Vector(q), k,
                                    T.MetadataFilter.eq("par", "0"))
        assert [r.id for r in got] == want
        # a near-self query: ~5e-5 of cancellation noise at distance 0.05
        _same_hits([js.search_with_filter(J.Vector(q), k,
                                          J.MetadataFilter.eq("par", "0"))],
                   [got], atol=1e-4)


# ---------------------------------------------------------------------------
# PQ on the mesh
# ---------------------------------------------------------------------------

class TestShardedPq:
    """PQ codes on the mesh: codes sharded over the row axis, per-shard
    streaming scan (plain K8), exact merged top-r, exact host re-rank.
    The port takes the JAX index's trained state and codes, so both scan
    the same codes slot for slot."""

    def _pair(self, meshes, n=4000, d=16, refine=512, rotate=False,
              seed_rows=26, meta=False, sharded=True):
        jm, tm = meshes if sharded else (None, None)
        kw = dict(m=4, ksub=16, refine=refine, auto_train_min=10 ** 9,
                  seed=0, rotate=rotate)
        jix = JPq(J.DistanceMetric.EUCLIDEAN, mesh=jm, **kw)
        tix = PqFlatIndex(T.DistanceMetric.EUCLIDEAN, mesh=tm, device="cpu",
                          **kw)
        js, ts = J.VectorStore.with_index(jix), T.VectorStore.with_index(tix)
        data = _rng(seed_rows).standard_normal((n, d)).astype(np.float32)
        _insert_both(js, ts, data,
                     (lambda i: {"par": str(i % 2)}) if meta else None)
        return js, ts, data

    @staticmethod
    def _train(js, ts):
        js.index.train()
        js.search_batch([(J.Vector(np.zeros(js.dimension, np.float32)), 1)])
        ts.index.import_trained_state(js.index.export_trained_state())
        ts.index.adopt_codes(np.asarray(js.index._codes))

    def test_sharded_pq_scan_engages_and_exact_at_full_pool(self, meshes,
                                                            monkeypatch):
        calls, jcalls = [], []
        _spy(monkeypatch, tdist_mod, "make_sharded_pq_scan", calls)
        _spy(monkeypatch, jdist_mod, "make_sharded_pq_scan", jcalls)
        js, ts, data = self._pair(meshes, n=500)
        self._train(js, ts)
        q = _rng(27).standard_normal((5, 16)).astype(np.float32)
        res = ts.search_batch([(T.Vector(x), 10) for x in q])
        assert calls and jcalls, "the sharded PQ scan must engage"
        # refine 512 covers every live row: the exact re-rank is exact
        oracle = _oracle(q, data[:500], "euclidean")
        for qi in range(5):
            assert [h.id for h in res[qi]] == [
                f"v{int(w)}" for w in np.argsort(oracle[qi],
                                                 kind="stable")[:10]]
            np.testing.assert_allclose(
                [h.distance for h in res[qi]],
                np.sort(oracle[qi], kind="stable")[:10], rtol=1e-6)
        _same_hits(js.search_batch([(J.Vector(x), 10) for x in q]), res)

    def test_sharded_pq_large_recall_and_exact_distances(self, meshes):
        """At n >> r the pool is approximate, but every returned distance
        is the exact f32 distance of the stored row."""
        js, ts, data = self._pair(meshes, n=4000, refine=512)
        self._train(js, ts)
        q = _rng(28).standard_normal((6, 16)).astype(np.float32)
        res = ts.search_batch([(T.Vector(x), 10) for x in q])
        oracle = _oracle(q, data, "euclidean")
        hits = 0
        for qi in range(6):
            want = {f"v{int(w)}"
                    for w in np.argsort(oracle[qi], kind="stable")[:10]}
            hits += len({h.id for h in res[qi]} & want)
            for h in res[qi]:
                np.testing.assert_allclose(
                    h.distance, oracle[qi][int(h.id[1:])], rtol=1e-6)
        assert hits >= 48
        _same_hits(js.search_batch([(J.Vector(x), 10) for x in q]), res)

    def test_sharded_pq_matches_single_chip_pool(self, meshes):
        """The sharded scan's merged pool equals the unsharded scan's
        over the same codes: the same candidates, so the same answers."""
        js, ts, data = self._pair(meshes, refine=256)
        self._train(js, ts)
        js1, ts1, _ = self._pair(meshes, refine=256, sharded=False)
        ts1.index.import_trained_state(js.index.export_trained_state())
        # the same rows in the same slots: the unsharded capacity is the
        # mesh's first 4096 slots
        ts1.index.adopt_codes(np.asarray(js.index._codes)[:4096])
        q = _rng(29).standard_normal((4, 16)).astype(np.float32)
        qt = torch.from_numpy(q)
        with ts.index._lock:
            st = ts.index._scan_state()
        with ts1.index._lock:
            st1 = ts1.index._scan_state()
        sv, sl = ts.index._scan_call(st, qt, 256)
        sv1, sl1 = ts1.index._scan_call(st1, qt, 256)
        np.testing.assert_allclose(sv.numpy(), sv1.numpy(), rtol=1e-6)
        assert all(set(a) == set(b) for a, b in zip(sl.tolist(),
                                                    sl1.tolist()))
        res_s = ts.search_batch([(T.Vector(x), 5) for x in q])
        _same_hits(ts1.search_batch([(T.Vector(x), 5) for x in q]), res_s)
        _same_hits(js.search_batch([(J.Vector(x), 5) for x in q]), res_s)

    def test_sharded_pq_with_rotation(self, meshes):
        js, ts, data = self._pair(meshes, n=500, rotate=True)
        self._train(js, ts)
        assert ts.index._rot is not None
        q = _rng(30).standard_normal((3, 16)).astype(np.float32)
        res = ts.search_batch([(T.Vector(x), 10) for x in q])
        oracle = _oracle(q, data[:500], "euclidean")
        for qi in range(3):
            assert [h.id for h in res[qi]] == [
                f"v{int(w)}" for w in np.argsort(oracle[qi],
                                                 kind="stable")[:10]]
        _same_hits(js.search_batch([(J.Vector(x), 10) for x in q]), res)

    def test_sharded_pq_filter_composes(self, meshes):
        js, ts, data = self._pair(meshes, meta=True)
        self._train(js, ts)
        elig = np.arange(0, 4000, 2)
        q = data[12] + 0.01
        d2 = np.sum((data[elig] - q) ** 2, axis=1)
        want = [f"v{elig[j]}" for j in np.argsort(d2, kind="stable")[:5]]
        flt, jflt = (T.MetadataFilter.eq("par", "0"),
                     J.MetadataFilter.eq("par", "0"))
        got = ts.search_with_filter(T.Vector(q), 5, flt)
        assert [r.id for r in got] == want
        got2 = ts.search_with_filter(T.Vector(q), 5, flt, refine=512)
        assert [r.id for r in got2] == want
        _same_hits([js.search_with_filter(J.Vector(q), 5, jflt)], [got])

    def test_sharded_pq_untrained_falls_back_sharded_exact(self, meshes,
                                                           monkeypatch):
        calls = []
        _spy(monkeypatch, tdist_mod, "make_sharded_search_coarse", calls)
        js, ts, data = self._pair(meshes, n=1500)
        assert not ts.index.is_trained
        q = data[7] + 0.001
        res = ts.search_batch([(T.Vector(q), 5)])
        assert calls, "the untrained fallback is the sharded flat route"
        oracle = _oracle(q[None], data, "euclidean")
        assert [h.id for h in res[0]] == [
            f"v{int(w)}" for w in np.argsort(oracle[0], kind="stable")[:5]]
        _same_hits(js.search_batch([(J.Vector(q), 5)]), res, atol=1e-3)

    def test_sharded_pq_mutation_resync(self, meshes):
        js, ts, data = self._pair(meshes, n=3000)
        self._train(js, ts)
        ts.search_batch([(T.Vector(data[0]), 5)])   # first sharded sync
        codes0 = ts.index._codes_dev
        moved = data[9] + 3.0
        for s, mod in ((js, J), (ts, T)):
            s.delete("v2")
            s.insert("v9", mod.Vector(moved))       # upsert, re-encodes
        res = ts.search_batch([(T.Vector(moved + 0.001), 5)])
        assert res[0][0].id == "v9"
        assert all(h.id != "v2" for h in res[0])
        # the codes went up anew, one tensor per shard
        assert ts.index._codes_dev is not codes0
        assert len(ts.index._codes_dev) == 8
        np.testing.assert_array_equal(
            torch.cat(ts.index._codes_dev).numpy()[ts.index.slot_of(
                ts._id_to_internal["v9"])],
            ts.index._codes[ts.index.slot_of(ts._id_to_internal["v9"])])
        assert [h.id for h in res[0]] == [
            h.id for h in js.search_batch([(J.Vector(moved + 0.001), 5)])[0]]

    def test_sharded_pq_masked_device_scan(self, meshes):
        """Eligible set above _MASKED_EXACT_MAX: the masked sharded scan
        itself runs; filter exactness is unconditional, the k contract is
        served, recall is governed by refine."""
        from vectordb_tpu_torch.index.pq import _MASKED_EXACT_MAX
        js, ts, data = self._pair(meshes, n=6000, refine=64, meta=True)
        assert 3000 > _MASKED_EXACT_MAX
        self._train(js, ts)
        flt, jflt = (T.MetadataFilter.eq("par", "0"),
                     J.MetadataFilter.eq("par", "0"))
        elig = np.arange(0, 6000, 2)
        hits = jhits = 0
        for q in (data[8] + 0.005, data[100] + 0.005):
            d2 = np.sum((data[elig] - q) ** 2, axis=1)
            want = {f"v{elig[j]}" for j in np.argsort(d2)[:5]}
            got = ts.search_with_filter(T.Vector(q), 5, flt)
            jgot = js.search_with_filter(J.Vector(q), 5, jflt)
            assert len(got) == 5
            assert all(int(r.id[1:]) % 2 == 0 for r in got)
            dd = [r.distance for r in got]
            assert dd == sorted(dd)
            hits += len({r.id for r in got} & want)
            jhits += len({r.id for r in jgot} & want)
            # the same pools give the same answers; a pool-boundary tie of
            # equal codes may swap the last one
            assert len({r.id for r in got} & {r.id for r in jgot}) >= 4
        assert hits >= 6 and abs(hits - jhits) <= 1


# ---------------------------------------------------------------------------
# durable engines on the mesh
# ---------------------------------------------------------------------------

def test_engine_recovery_int8_sharded(meshes, tmp_path):
    """An int8 database crash-recovers into mesh-sharded code + scale
    storage, exact over the stored values, as the JAX package's does."""
    from vectordb_tpu_torch.index.flat import _quantize_int8
    jm, tm = meshes
    data = _rng(31).standard_normal((160, 16)).astype(np.float32)
    with JEngine.open(tmp_path / "a", JEngineConfig(storage="int8")) as eng:
        eng.insert_batch([J.BatchInsertItem(f"v{i}", J.Vector(data[i]))
                          for i in range(120)])
        eng.checkpoint()
        for i in range(120, 160):
            eng.insert(f"v{i}", J.Vector(data[i]))
        eng.delete("v3")
    _copy_dir(tmp_path / "a", tmp_path / "b")
    q = _rng(32).standard_normal((2, 16)).astype(np.float32)
    with StorageEngine.open(tmp_path / "a", EngineConfig(
            mesh=tm, storage="int8")) as eng, \
            JEngine.open(tmp_path / "b", JEngineConfig(
                mesh=jm, storage="int8")) as jeng:
        assert len(eng) == 159
        eng.search(T.Vector(data[1]), 1)            # force the sync
        dev = eng.store.index._device
        assert all(t.dtype == torch.int8 for t in dev["db"])
        assert len(dev["db"]) == 8
        stored = _quantize_int8(data)
        keep = [i for i in range(160) if i != 3]
        oracle = _oracle(q, stored[keep], "euclidean")
        for qi in range(2):
            want = [f"v{keep[int(w)]}"
                    for w in np.argsort(oracle[qi], kind="stable")[:5]]
            assert [h.id for h in eng.search(T.Vector(q[qi]), 5)] == want
        _same_hits([jeng.search(J.Vector(x), 5) for x in q],
                   [eng.search(T.Vector(x), 5) for x in q])


def test_engine_recovery_pq_sharded(meshes, tmp_path):
    """A trained PQ store reopens with its codes sharded over the mesh:
    the codebook restored (pq_state.npz), codes re-derived; the port's
    mesh reopen of the JAX package's directory answers as the JAX
    package's own mesh reopen."""
    jm, tm = meshes
    n, d, k = 600, 16, 5
    data = _rng(33).standard_normal((n, d)).astype(np.float32)
    with JEngine.open(tmp_path / "a", JEngineConfig(index_type="pq")) as eng:
        eng.insert_batch([J.BatchInsertItem(f"v{i}", J.Vector(data[i]))
                          for i in range(n)])
        eng.store.index.auto_train_min = 1
        eng.store.index.train()
        eng.checkpoint()
        before = [[h.id for h in eng.search(J.Vector(data[i]), k)]
                  for i in (3, 77)]
    _copy_dir(tmp_path / "a", tmp_path / "b")
    with StorageEngine.open(tmp_path / "a", EngineConfig(
            index_type="pq", mesh=tm)) as eng:
        assert len(eng) == n
        idx = eng.store.index
        assert idx.is_trained and idx._mesh is tm
        after = [[h.id for h in eng.search(T.Vector(data[i]), k)]
                 for i in (3, 77)]
        assert after[0][0] == "v3" and after[1][0] == "v77"
        assert len(set(before[0]) & set(after[0])) >= k - 1
        with idx._lock:
            codes = idx._pq_sync()[0]
        assert len(codes) == 8
        jcodebook = np.load(tmp_path / "b" / "pq_state.npz")["codebook"]
        np.testing.assert_array_equal(idx._codebook, jcodebook)
    with JEngine.open(tmp_path / "b", JEngineConfig(index_type="pq",
                                                   mesh=jm)) as jeng:
        jafter = [[h.id for h in jeng.search(J.Vector(data[i]), k)]
                  for i in (3, 77)]
        assert jafter[0][0] == "v3" and jafter[1][0] == "v77"


def test_engine_mesh_rejected_for_unsharded_index_types(meshes, tmp_path):
    jm, tm = meshes
    for it in ("hnsw", "ivf", "ivfpq"):
        with pytest.raises(ValueError, match="does not support mesh"):
            StorageEngine.open(tmp_path / it,
                               EngineConfig(index_type=it, mesh=tm))
        with pytest.raises(ValueError):
            JEngine.open(tmp_path / f"j{it}",
                         JEngineConfig(index_type=it, mesh=jm))


def test_mesh_engine_files_are_the_jax_packages(meshes, tmp_path):
    """A mesh engine writes the JAX package's files, byte for byte: the
    shard layout keeps one device's slots."""
    jm, tm = meshes
    data = _rng(34).standard_normal((300, 16)).astype(np.float32)
    for eng in (StorageEngine.open(tmp_path / "t", EngineConfig(mesh=tm)),
                JEngine.open(tmp_path / "j", JEngineConfig(mesh=jm))):
        mod = T if isinstance(eng, StorageEngine) else J
        with eng:
            eng.insert_batch([mod.BatchInsertItem(f"v{i}",
                                                  mod.Vector(data[i]))
                              for i in range(200)])
            eng.search(mod.Vector(data[0]), 1)
            eng.delete("v7")
            eng.checkpoint()
            for i in range(200, 300):
                eng.insert(f"v{i}", mod.Vector(data[i]))
    for name in ("snapshot.bin", "wal.log"):
        assert ((tmp_path / "t" / name).read_bytes()
                == (tmp_path / "j" / name).read_bytes()), name


# ---------------------------------------------------------------------------
# the storage and radius compositions, signatures, the dry run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("storage", ["bf16", "int8"])
def test_storage_composes_with_mesh(meshes, storage):
    """test_bf16_composes_with_mesh, test_int8_composes_with_mesh."""
    jm, tm = meshes
    idx = T.FlatIndex(T.DistanceMetric.EUCLIDEAN, storage=storage, mesh=tm)
    jidx = J.FlatIndex(J.DistanceMetric.EUCLIDEAN, storage=storage, mesh=jm)
    assert idx.storage == jidx.storage == storage
    assert idx._mesh is not None and jidx._mesh is not None


def test_radius_on_sharded_store(meshes):
    """Radius rides FlatIndex.search, which routes to the sharded
    pipeline on a mesh."""
    jm, tm = meshes
    out = []
    for mod, mesh in ((J, jm), (T, tm)):
        store = mod.VectorStore(mod.FlatIndex(mod.DistanceMetric.EUCLIDEAN,
                                              mesh=mesh))
        store.insert_batch([
            mod.BatchInsertItem(id=f"v{i}",
                                vector=mod.Vector([float(i), 0.0]))
            for i in range(64)])
        out.append(store.search_radius(mod.Vector([0.0, 0.0]), 2.5))
    assert [h.id for h in out[1]] == ["v0", "v1", "v2"]
    dd = [h.distance for h in out[1]]
    assert dd == sorted(dd)
    _same_hits([out[0]], [out[1]], atol=1e-3)


def _params(fn):
    import inspect
    return [(p.name, p.default)
            for p in inspect.signature(fn).parameters.values()]


@pytest.mark.parametrize("name, extra", [
    ("make_mesh", ["devices"]), ("shard_rows", []),
    ("make_sharded_search", []), ("make_sharded_search_coarse", []),
    ("make_sharded_pq_scan", []), ("DistributedFlatIndex", []),
    ("ShardedHnswIndex", []), ("with_sharded_flat_index", []),
    ("PqFlatIndex", ["device"]), ("FlatIndex", ["device"])])
def test_signatures_match_the_jax_package(name, extra):
    """The JAX package's parameters in its order, then the port's own."""
    pairs = {
        "make_mesh": (jpar.make_mesh, tpar.make_mesh),
        "shard_rows": (jpar.shard_rows, tpar.shard_rows),
        "make_sharded_search": (jpar.make_sharded_search,
                                tpar.make_sharded_search),
        "make_sharded_search_coarse": (jpar.make_sharded_search_coarse,
                                       tpar.make_sharded_search_coarse),
        "make_sharded_pq_scan": (jdist_mod.make_sharded_pq_scan,
                                 tpar.make_sharded_pq_scan),
        "DistributedFlatIndex": (jpar.DistributedFlatIndex.__init__,
                                 tpar.DistributedFlatIndex.__init__),
        "ShardedHnswIndex": (jpar.ShardedHnswIndex.__init__,
                             tpar.ShardedHnswIndex.__init__),
        "with_sharded_flat_index": (J.VectorStore.with_sharded_flat_index,
                                    T.VectorStore.with_sharded_flat_index),
        "PqFlatIndex": (JPq.__init__, PqFlatIndex.__init__),
        "FlatIndex": (J.FlatIndex.__init__, T.FlatIndex.__init__),
    }
    ref, port = pairs[name]
    ref_p, port_p = _params(ref), _params(port)
    assert [n for n, _ in port_p[:len(ref_p)]] == [n for n, _ in ref_p]
    assert [n for n, _ in port_p[len(ref_p):]] == extra
    # defaults equal but for the mesh types (jax.sharding vs the port's)
    assert [d for _, d in port_p[:len(ref_p)]] == [d for _, d in ref_p]


@pytest.mark.parametrize("n_devices", [8, 3])
def test_dryrun_multichip(n_devices):
    """The dry run on a mesh repeating the CPU: a 2-D mesh at 8 shards,
    1-D at 3 (the JAX package's split)."""
    out = tpar.dryrun_multichip(n_devices, devices=["cpu"])
    assert out["rows"] == 64 * n_devices
    want = ({"shard": 4, "batch": 2} if n_devices == 8
            else {"shard": 3})
    assert out["mesh"] == want
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tpar.dryrun_multichip(2)


def test_jax_mesh_is_the_virtual_cpu_mesh():
    """The JAX side of these tests runs on conftest.py's 8 devices."""
    assert len(jax.devices()) == 8
