"""The recovery hooks of the port's indexes against the JAX package's.

Mirrors tests/test_recovery_hydration.py's ``TestReserve`` and
``TestDirtySuppression`` (its mesh classes wait for the multi-device
slice), then the rest of what recovery calls: ``prehydrate`` (the device
build on a side thread while the WAL tail replays, its dirty-slot window
and its discard on a storage growth), ``bulk_append_matrix`` with
``quantized=True`` (snapshot rows taken as stored values, no second
rounding), the bulk loaders and ``host_backing`` on the flat and PQ
indexes. Stored values are held bit for bit to the JAX package's on the
same numpy inputs; the port runs on ``device="cpu"``.
"""

import threading

import numpy as np
import pytest
import torch

from vectordb_tpu.index.flat import FlatIndex as JFlat
from vectordb_tpu.distance import DistanceMetric as JMetric

import vectordb_tpu_torch as T
from vectordb_tpu_torch import BatchInsertItem, Vector
from vectordb_tpu_torch.distance import DistanceMetric
from vectordb_tpu_torch.errors import DimensionMismatchError
from vectordb_tpu_torch.index.flat import FlatIndex
from vectordb_tpu_torch.index.pq import PqFlatIndex
from vectordb_tpu_torch.persistence import EngineConfig, StorageEngine

torch.set_num_threads(1)
EUC = DistanceMetric.EUCLIDEAN


def _mat(rng, n, d=16):
    return rng.standard_normal((n, d)).astype(np.float32)


def _flat(**kw):
    return FlatIndex(EUC, device="cpu", **kw)


def _oracle(rows, ids, q, k):
    d = np.linalg.norm(rows[None, :, :] - q[:, None, :], axis=-1)
    order = np.argsort(d, axis=1)[:, :k]
    return [[int(ids[j]) for j in row] for row in order]


class TestReserve:
    def test_reserve_presizes_once(self, rng):
        ix = _flat()
        ix.reserve(5000, dim=16)
        assert ix.capacity >= 5000
        vecs0 = ix._vectors
        for lo in range(0, 5000, 500):
            ix.bulk_append_matrix(np.arange(lo, lo + 500, dtype=np.int64),
                                  _mat(rng, 500))
        assert ix._vectors is vecs0
        assert len(ix) == 5000

    def test_reserve_unknown_dim_is_noop(self):
        ix = _flat()
        ix.reserve(1000)
        assert ix.capacity == 0

    def test_reserve_dim_mismatch_raises(self):
        ix = _flat()
        ix.add(0, Vector(np.ones(8, np.float32)))
        with pytest.raises(DimensionMismatchError):
            ix.reserve(100, dim=16)

    def test_store_reserve_passthrough(self):
        store = T.VectorStore.with_flat_index(EUC, device="cpu")
        store.reserve(3000, 16)
        assert store.index.capacity >= 3000


class TestDirtySuppression:
    def test_no_mirror_no_dirty_bookkeeping(self, rng):
        ix = _flat()
        ix.bulk_append_matrix(np.arange(100, dtype=np.int64), _mat(rng, 100))
        assert not ix._dirty_slots
        ix.search(Vector(_mat(rng, 1)[0]), 5)
        ix.add(1000, Vector(_mat(rng, 1)[0]))
        assert ix._dirty_slots

    def test_prehydrate_window_tracks_mutations(self, rng):
        ix = _flat()
        data = _mat(rng, 50)
        ix.bulk_append_matrix(np.arange(50, dtype=np.int64), data)
        with ix._lock:
            ix._build_inflight = True
        try:
            ix.add(999, Vector(data[0] + 1.0))
            assert ix._dirty_slots
        finally:
            with ix._lock:
                ix._build_inflight = False

    def test_mutation_correctness_after_suppression(self, rng):
        ix = _flat()
        data = _mat(rng, 64)
        ix.bulk_append_matrix(np.arange(64, dtype=np.int64), data)
        ix.remove(7)
        ix.add(100, Vector(data[7]))
        assert ix.search(Vector(data[7]), 1)[0][0] == 100


class TestPrehydrate:
    def test_installs_the_full_build(self, rng):
        data = _mat(rng, 300)
        ix, ref = _flat(), _flat()
        for x in (ix, ref):
            x.bulk_append_matrix(np.arange(300, dtype=np.int64), data)
        ix.prehydrate()
        assert ix._device is not None and not ix._build_inflight
        assert ix._device_ready is None        # CPU tensors: no event
        with ref._lock:
            want = ref._sync_device()
        got = ix._device
        assert sorted(got) == sorted(want)
        for key, t in want.items():
            if isinstance(t, torch.Tensor):
                assert torch.equal(got[key], t), key

    def test_noop_when_empty_or_built(self, rng):
        ix = _flat()
        ix.prehydrate()
        assert ix._device is None
        ix.bulk_append_matrix(np.arange(10, dtype=np.int64), _mat(rng, 10))
        ix.search(Vector(_mat(rng, 1)[0]), 1)
        dev = ix._device
        ix.prehydrate()
        assert ix._device is dev

    def test_write_during_the_build_is_repaired(self, rng, monkeypatch):
        """A row written (from another thread) while the unlocked build
        reads the host arrays is dirty afterwards, and the first search
        serves it exactly."""
        data = _mat(rng, 200)
        ix = _flat()
        ix.bulk_append_matrix(np.arange(200, dtype=np.int64), data)
        real = FlatIndex._build_device_full
        fresh = _mat(rng, 1)[0]

        def racing(self):
            dev = real(self)
            t = threading.Thread(target=lambda: (ix.remove(3),
                                                 ix.add(500, Vector(fresh))))
            t.start()
            t.join()
            return dev

        monkeypatch.setattr(FlatIndex, "_build_device_full", racing)
        ix.prehydrate()
        monkeypatch.setattr(FlatIndex, "_build_device_full", real)
        assert ix._device is not None and ix._dirty_slots
        rows = data.copy()
        rows[3] = fresh
        ids = np.arange(200)
        ids[3] = 500
        q = np.concatenate([fresh[None], data[:5]])
        got = [[i for i, _ in r] for r in ix.search_batch(q, 4)]
        assert got == _oracle(rows, ids, q, 4)
        assert not ix._dirty_slots

    def test_growth_during_the_build_discards_it(self, rng, monkeypatch):
        data = _mat(rng, 100)
        ix = _flat()
        ix.bulk_append_matrix(np.arange(100, dtype=np.int64), data)
        real = FlatIndex._build_device_full
        extra = _mat(rng, ix.capacity)

        def growing(self):
            dev = real(self)
            ix.bulk_append_matrix(
                np.arange(1000, 1000 + len(extra), dtype=np.int64), extra)
            return dev

        monkeypatch.setattr(FlatIndex, "_build_device_full", growing)
        ix.prehydrate()
        monkeypatch.setattr(FlatIndex, "_build_device_full", real)
        assert ix._device is None and not ix._build_inflight
        assert ix.search(Vector(extra[5]), 1)[0][0] == 1005

    def test_engine_reopen_hydrates_before_the_first_search(self, rng,
                                                            tmp_path):
        data = _mat(rng, 300)
        cfg = EngineConfig(device="cpu")
        with StorageEngine.open(tmp_path, cfg) as eng:
            eng.insert_batch([BatchInsertItem(f"v{i}", Vector(data[i]))
                              for i in range(250)])
            eng.checkpoint()
            for i in range(250, 300):
                eng.insert(f"v{i}", Vector(data[i]))
            eng.delete("v1")
        with StorageEngine.open(tmp_path, cfg) as eng:
            ix = eng.store.index
            assert ix._device is not None and not ix._build_inflight
            assert "hydration build" in eng.recovery_marks
            assert eng.search(Vector(data[275]), 1)[0].id == "v275"
            assert all(h.id != "v1" for h in eng.search(Vector(data[1]), 5))
            assert len(eng) == 299


# ---------------------------------------------------------------------------
# bulk paths, held to the JAX package's stored values
# ---------------------------------------------------------------------------

STORAGES = ["f32", "bf16", "int8"]


def _stored(ix):
    vecs, valid, ids = ix.packed_arrays()
    return np.asarray(vecs, np.float32), np.asarray(valid), np.asarray(ids)


def _same_stored(j, t):
    jv, jvalid, jids = _stored(j)
    tv, tvalid, tids = _stored(t)
    assert np.array_equal(jvalid, tvalid) and np.array_equal(jids, tids)
    assert np.array_equal(jv.view(np.uint32), tv.view(np.uint32))
    assert np.array_equal(np.asarray(j._sq_norms), t._sq_norms)


@pytest.mark.parametrize("storage", STORAGES)
def test_bulk_append_matrix_matches_jax(rng, storage):
    data = _mat(rng, 700)
    j = JFlat(JMetric.EUCLIDEAN, storage=storage)
    t = _flat(storage=storage)
    for x in (j, t):
        x.add(5000, data[0])
        x.bulk_append_matrix(np.arange(600, dtype=np.int64), data[:600])
        x.remove(3)
        x.bulk_append_matrix(np.arange(600, 700, dtype=np.int64),
                             data[600:])
    _same_stored(j, t)


@pytest.mark.parametrize("storage", STORAGES)
def test_quantized_rows_take_no_second_rounding(rng, storage):
    """Snapshot rows ARE stored values: ``quantized=True`` keeps their
    bits, and they equal what a raw insert stores."""
    raw = _mat(rng, 64)
    t = _flat(storage=storage)
    t.bulk_append_matrix(np.arange(64, dtype=np.int64), raw)
    stored = _stored(t)[0][:64].copy()
    r = _flat(storage=storage)
    r.bulk_append_matrix(np.arange(64, dtype=np.int64), stored,
                         quantized=True)
    assert np.array_equal(_stored(r)[0][:64].view(np.uint32),
                          stored.view(np.uint32))
    j = JFlat(JMetric.EUCLIDEAN, storage=storage)
    j.bulk_append_matrix(np.arange(64, dtype=np.int64), stored,
                         quantized=True)
    _same_stored(j, r)


def test_bulk_append_matrix_refusals(rng):
    t = _flat()
    t.bulk_append_matrix(np.arange(4, dtype=np.int64), _mat(rng, 4))
    with pytest.raises(ValueError, match="duplicate"):
        t.bulk_append_matrix(np.array([9, 9]), _mat(rng, 2))
    with pytest.raises(ValueError, match="fresh"):
        t.bulk_append_matrix(np.array([2]), _mat(rng, 1))
    with pytest.raises(DimensionMismatchError):
        t.bulk_append_matrix(np.array([7]), _mat(rng, 1, d=8))
    with pytest.raises(ValueError, match="length"):
        t.bulk_append_matrix(np.array([7, 8]), _mat(rng, 1))


@pytest.mark.parametrize("storage", STORAGES)
def test_bulk_load_matrix_and_stream_match_jax(rng, storage):
    data = _mat(rng, 1500)
    ids = rng.permutation(5000)[:1500].astype(np.int64)
    j = JFlat(JMetric.EUCLIDEAN, storage=storage)
    t = _flat(storage=storage)
    j.bulk_load_matrix(ids, data)
    t.bulk_load_matrix(ids, data)
    _same_stored(j, t)
    js = JFlat(JMetric.EUCLIDEAN, storage=storage)
    ts = _flat(storage=storage)
    chunks = [data[a:a + 400] for a in range(0, 1500, 400)]
    js.bulk_load_stream(1500, 16, iter(chunks))
    ts.bulk_load_stream(1500, 16, iter(chunks))
    _same_stored(js, ts)
    q = _mat(rng, 4)
    assert [[i for i, _ in r] for r in ts.search_batch(q, 5)] == \
        [[i for i, _ in r] for r in js.search_batch(q, 5)]


def test_bulk_loader_refusals(rng):
    t = _flat()
    with pytest.raises(ValueError, match="duplicate"):
        t.bulk_load_matrix(np.array([1, 1]), _mat(rng, 2))
    with pytest.raises(ValueError, match="declared"):
        t.bulk_load_stream(10, 16, iter([_mat(rng, 4)]))
    with pytest.raises(ValueError, match="exceed"):
        _flat().bulk_load_stream(3, 16, iter([_mat(rng, 4)]))
    with pytest.raises(DimensionMismatchError):
        _flat().bulk_load_stream(4, 16, iter([_mat(rng, 4, d=8)]))
    full = _flat()
    full.add(0, _mat(rng, 1)[0])
    with pytest.raises(ValueError, match="empty"):
        full.bulk_load_matrix(np.array([1]), _mat(rng, 1))
    with pytest.raises(ValueError, match="empty"):
        full.bulk_load_stream(1, 16, iter([_mat(rng, 1)]))


# ---------------------------------------------------------------------------
# host_backing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("storage", ["f32", "bf16"])
def test_host_backing_rows_live_in_a_memmap(rng, tmp_path, storage):
    data = _mat(rng, 1500)
    t = _flat(storage=storage, host_backing=str(tmp_path))
    ram = _flat(storage=storage)
    for x in (t, ram):
        x.add_batch([(i, data[i]) for i in range(900)])
    assert isinstance(t._vectors, np.memmap)
    first = t._vectors_path
    assert first.startswith(str(tmp_path))
    for x in (t, ram):                 # grows past 1024: a new row file
        x.add_batch([(i, data[i]) for i in range(900, 1500)])
    assert t._vectors_path != first and len(list(tmp_path.iterdir())) == 1
    assert np.array_equal(_stored(t)[0].view(np.uint32),
                          _stored(ram)[0].view(np.uint32))
    q = _mat(rng, 3)
    assert t.search_batch(q, 5) == ram.search_batch(q, 5)


def test_bulk_attach_memmap_reopens_a_row_file(rng, tmp_path):
    data = _mat(rng, 1500)
    a = _flat(host_backing=str(tmp_path / "a"))
    a.bulk_load_stream(1500, 16, iter([data[:700], data[700:]]))
    a._vectors.flush()
    b = _flat(host_backing=str(tmp_path / "b"))
    b.bulk_attach_memmap(a._vectors_path, 1500, 16)
    c = _flat(host_backing=str(tmp_path / "c"))
    c.bulk_attach_memmap(a._vectors_path, 1500, 16,
                         sq_norms=a._sq_norms[:1500])
    q = _mat(rng, 4)
    want = a.search_batch(q, 5)
    assert b.search_batch(q, 5) == want and c.search_batch(q, 5) == want
    np.testing.assert_array_equal(b._sq_norms, a._sq_norms)
    with pytest.raises(ValueError, match="bytes"):
        _flat(host_backing=str(tmp_path)).bulk_attach_memmap(
            a._vectors_path, 1500, 8)
    with pytest.raises(ValueError, match="host_backing"):
        _flat().bulk_attach_memmap(a._vectors_path, 1500, 16)
    with pytest.raises(ValueError, match="f32"):
        _flat(storage="int8", host_backing=str(tmp_path)).bulk_attach_memmap(
            a._vectors_path, 1500, 16)


# ---------------------------------------------------------------------------
# PQ: the bulk loaders and host_backing (once refused)
# ---------------------------------------------------------------------------

def _pq(**kw):
    return PqFlatIndex(EUC, m=4, ksub=32, refine=32, device="cpu", **kw)


def _clustered(rng, n, d=16):
    centers = rng.standard_normal((16, d)).astype(np.float32)
    return (centers[rng.integers(0, 16, n)]
            + 0.3 * rng.standard_normal((n, d)).astype(np.float32))


@pytest.mark.parametrize("loader", ["matrix", "stream", "attach"])
def test_pq_bulk_loaders_serve_like_add_batch(rng, tmp_path, loader):
    data = _clustered(rng, 1200)
    ref = _pq()
    ref.add_batch([(i, data[i]) for i in range(1200)])
    ref.train()
    t = _pq(host_backing=str(tmp_path / "t")) if loader == "attach" \
        else _pq()
    if loader == "attach":
        src = FlatIndex(EUC, device="cpu", host_backing=str(tmp_path / "s"))
        src.bulk_load_stream(1200, 16, iter([data]))
        src._vectors.flush()
        t.bulk_attach_memmap(src._vectors_path, 1200, 16)
    elif loader == "stream":
        t.bulk_load_stream(1200, 16, iter([data[:500], data[500:]]))
    else:
        t.bulk_load_matrix(np.arange(1200, dtype=np.int64), data)
    t.import_trained_state(ref.export_trained_state())
    q = data[:16] + 0.01
    assert t.search_batch(q, 5) == ref.search_batch(q, 5)
    # a trained index re-encodes in full after a bulk load
    t2 = _pq()
    t2.add(9999, data[0])
    t2.import_trained_state(ref.export_trained_state())
    t2.remove(9999)
    t2.bulk_load_matrix(np.arange(1200, dtype=np.int64), data)
    assert t2._pq_full_reencode
    assert t2.search_batch(q, 5) == ref.search_batch(q, 5)


def test_pq_host_backing_reranks_on_the_host(rng, tmp_path):
    data = _clustered(rng, 1200)
    t = _pq(host_backing=str(tmp_path), rerank="device")
    ram = _pq()
    for x in (t, ram):
        x.add_batch([(i, data[i]) for i in range(1200)])
    t.train()
    ram.import_trained_state(t.export_trained_state())
    assert isinstance(t._vectors, np.memmap)
    assert t._rerank_venue() == "gathered"
    t.rerank_mode = "auto"
    assert t._rerank_venue() == "host"
    q = data[:8] + 0.01
    assert t.search_batch(q, 5) == ram.search_batch(q, 5)
