"""Mesh recovery in the port against the JAX package's, on the CPU.

Mirrors the mesh classes of tests/test_recovery_hydration.py
(``TestMeshPieceResync``, ``TestProgressiveHydration``): the piece-level
resync of a sharded state, its all-dirty fallback, the quantized
storages, the engine's progressive hydration on reopen, its abandonment
on a storage reallocation, and its equality with a full build. The JAX
side runs on conftest.py's 8 virtual CPU devices, the port on a mesh
repeating the CPU; answers are held to each other and to a numpy oracle.

One case departs from the JAX package on purpose: its progressive
hydration leaves every applied slot dirty (``finish()`` never clears
``_dirty_slots``), so the first search after a mesh reopen rebuilds the
state it has just hydrated. The port marks only slots written after their
shard's piece was put; ``test_reopen_without_tail_puts_no_piece`` reads
the JAX package's behaviour and holds the port to the repair.
"""

import numpy as np
import pytest
import torch

import vectordb_tpu as J
from vectordb_tpu.index.flat import FlatIndex as JFlat
from vectordb_tpu.parallel import make_mesh as jmake_mesh
from vectordb_tpu.persistence import EngineConfig as JEngineConfig
from vectordb_tpu.persistence import StorageEngine as JEngine

from vectordb_tpu_torch import Vector
from vectordb_tpu_torch.distance import DistanceMetric
from vectordb_tpu_torch.index.flat import FlatIndex
from vectordb_tpu_torch.parallel import make_mesh
from vectordb_tpu_torch.persistence import EngineConfig, StorageEngine

torch.set_num_threads(1)
EUC = DistanceMetric.EUCLIDEAN


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    # the JAX mesh arms its per-shard coarse route only in interpret mode
    monkeypatch.setenv("VDB_TPU_PALLAS_INTERPRET", "1")


@pytest.fixture
def meshes():
    return jmake_mesh(8), make_mesh(8, devices=["cpu"] * 8)


def _mat(rng, n, d=16):
    return rng.standard_normal((n, d)).astype(np.float32)


def _pair(meshes, **kw):
    jm, tm = meshes
    return (JFlat(J.DistanceMetric.EUCLIDEAN, mesh=jm, **kw),
            FlatIndex(EUC, mesh=tm, **kw))


def _same(ja, ta, rtol=2e-5):
    assert [[i for i, _ in r] for r in ta] == [[i for i, _ in r] for r in ja]
    np.testing.assert_allclose([d for r in ta for _, d in r],
                               [d for r in ja for _, d in r], rtol=rtol,
                               atol=2e-5)


def _jengine_dir(path, data, n_snap, storage="f32"):
    with JEngine.open(path, JEngineConfig(storage=storage)) as eng:
        eng.insert_batch([J.BatchInsertItem(f"v{i}", J.Vector(data[i]))
                          for i in range(n_snap)])
        eng.checkpoint()
        for i in range(n_snap, len(data)):      # the WAL tail
            eng.insert(f"v{i}", J.Vector(data[i]))


class TestMeshPieceResync:
    def test_partial_piece_resync_engages_and_exact(self, meshes,
                                                    monkeypatch):
        rng = np.random.default_rng(1)
        jix, ix = _pair(meshes)
        n, d = 4096, 16
        data = _mat(rng, n, d)
        for x in (jix, ix):
            x.bulk_append_matrix(np.arange(n, dtype=np.int64), data)
        ix.search(Vector(data[0]), 1)           # build the state
        jix.search(J.Vector(data[0]), 1)
        dev_db0 = list(ix._device["db"])
        newrow = _mat(rng, 1, d)[0]
        ix.remove(3)
        ix.add(n + 1, Vector(newrow))
        jix.remove(3)
        jix.add(n + 1, J.Vector(newrow))
        calls = {}
        orig = FlatIndex._mesh_piece_resync

        def spy(self):
            calls["ret"] = orig(self)
            return calls["ret"]

        monkeypatch.setattr(FlatIndex, "_mesh_piece_resync", spy)
        hits = ix.search(Vector(newrow), 1)
        assert calls.get("ret") is True
        assert hits[0][0] == n + 1
        # one shard was put anew; every clean shard kept its tensor
        assert ix.mesh_pieces_put == [0]
        assert ix._device["db"][0] is not dev_db0[0]
        assert all(a is b for a, b in zip(ix._device["db"][1:], dev_db0[1:]))
        q = _mat(rng, 4, d)
        got = ix.search_batch(q, 3)
        _same(jix.search_batch(q, 3), got)
        d2 = np.linalg.norm(data[None, :, :] - q[:, None, :], axis=-1)
        d2[:, 3] = np.inf                       # the deleted row
        for qi in range(4):
            want = np.argsort(d2[qi])[:3]
            for w, g in zip(want, [iid for iid, _ in got[qi]]):
                if g != n + 1:                  # the new row took slot 3
                    assert g == w

    def test_all_pieces_dirty_falls_back(self, meshes):
        rng = np.random.default_rng(2)
        jix, ix = _pair(meshes)
        d = 8
        data = _mat(rng, 1024, d)
        for x, mod in ((jix, J), (ix, None)):
            x.bulk_append_matrix(np.arange(1024, dtype=np.int64), data)
            x.search((mod.Vector if mod else Vector)(data[0]), 1)
        n = ix.capacity                 # fill every shard's slot range
        assert n == jix.capacity == 8192
        extra = _mat(rng, n - 1024, d)
        for x in (jix, ix):
            x.bulk_append_matrix(np.arange(1024, n, dtype=np.int64), extra)
        ix.search(Vector(data[0]), 1)   # rebuild, clear dirty
        jix.search(J.Vector(data[0]), 1)
        per_shard = n // 8
        for base in range(0, n, per_shard):   # one dirty slot per shard
            ix.remove(base)
            jix.remove(base)
        with ix._lock:
            assert ix._mesh_piece_resync() is False
        with jix._lock:
            assert jix._mesh_piece_resync() is False
        q = _mat(rng, 3, d)
        got = ix.search_batch(q, 4)
        assert ix.mesh_pieces_put == list(range(8))
        _same(jix.search_batch(q, 4), got)

    @pytest.mark.parametrize("storage", ["bf16", "int8"])
    def test_piece_resync_quantized_storage_exact(self, meshes, storage):
        rng = np.random.default_rng(3)
        jix, ix = _pair(meshes, storage=storage)
        n, d = 2048, 16
        data = _mat(rng, n, d)
        for x in (jix, ix):
            x.bulk_append_matrix(np.arange(n, dtype=np.int64), data)
        ix.search(Vector(data[0]), 1)
        jix.search(J.Vector(data[0]), 1)
        target = _mat(rng, 1, d)[0]
        ix.add(n + 5, Vector(target))           # one shard dirtied
        jix.add(n + 5, J.Vector(target))
        hits = ix.search(Vector(target), 1)
        assert hits[0][0] == n + 5
        assert len(ix.mesh_pieces_put) == 1
        q = _mat(rng, 3, d)
        _same(jix.search_batch(q, 5), ix.search_batch(q, 5))


class TestProgressiveHydration:
    def test_engine_mesh_reopen_installs_before_first_search(
            self, meshes, tmp_path):
        jm, tm = meshes
        rng = np.random.default_rng(4)
        data = _mat(rng, 300, 16)
        _jengine_dir(tmp_path / "a", data, 250)
        with JEngine.open(tmp_path / "a", JEngineConfig()) as eng:
            eng.delete("v1")
        import shutil
        shutil.copytree(tmp_path / "a", tmp_path / "b")
        with StorageEngine.open(tmp_path / "a", EngineConfig(mesh=tm)) as eng:
            ix = eng.store.index
            # the progressive hydrator installed a state during recovery
            assert ix._device is not None
            assert not ix._build_inflight and ix._hydrating is None
            # only tail writes after their piece's put are dirty (whether
            # the put of shard 0 began before the tail is the threads'
            # race), and only their shard is put again
            assert ix._dirty_slots <= {1} | set(range(250, 300))
            assert "progressive hydration finished (installed=True)" in \
                eng.recovery_marks
            hits = eng.search(Vector(data[275]), 1)
            assert hits[0].id == "v275"
            assert ix.mesh_pieces_put in ([], [0])
            assert all(h.id != "v1"
                       for h in eng.search(Vector(data[1]), 5))
            assert len(eng) == 299
            q = _mat(rng, 3, 16)
            with JEngine.open(tmp_path / "b",
                              JEngineConfig(mesh=jm)) as jeng:
                for x in q:
                    _same([[(h.id, h.distance)
                            for h in jeng.search(J.Vector(x), 5)]],
                          [[(h.id, h.distance)
                            for h in eng.search(Vector(x), 5)]])

    @pytest.mark.parametrize("storage", ["bf16", "int8"])
    def test_engine_mesh_reopen_quantized(self, meshes, tmp_path, storage):
        jm, tm = meshes
        data = _mat(np.random.default_rng(5), 200, 16)
        _jengine_dir(tmp_path, data, 200, storage=storage)
        with StorageEngine.open(tmp_path, EngineConfig(
                mesh=tm, storage=storage)) as eng:
            assert eng.store.index._device is not None
            hits = eng.search(Vector(data[42]), 1)
            assert hits[0].id == "v42"
            assert eng.store.index.mesh_pieces_put == []
            got = [[(h.id, h.distance) for h in eng.search(Vector(x), 5)]
                   for x in data[:3] + 0.3]
        with JEngine.open(tmp_path, JEngineConfig(
                mesh=jm, storage=storage)) as jeng:
            _same([[(h.id, h.distance) for h in jeng.search(J.Vector(x), 5)]
                   for x in data[:3] + 0.3], got)

    def test_hydrator_abandons_on_realloc(self, meshes):
        """Storage growing mid-hydration: finish() refuses the stale
        state, as the JAX package's does."""
        rng = np.random.default_rng(6)
        data = _mat(rng, 1024, 8)
        out = []
        for ix in _pair(meshes):
            ix.reserve(1024, dim=8)
            hyd = ix.start_progressive_hydration(1024)
            assert hyd is not None
            ix.bulk_append_matrix(np.arange(1024, dtype=np.int64), data)
            hyd.advance(1024)
            extra = ix.capacity - len(ix) + 1   # past the reserve
            ix.bulk_append_matrix(
                np.arange(10_000, 10_000 + extra, dtype=np.int64),
                _mat(np.random.default_rng(7), extra, 8))
            assert hyd.finish() is False
            assert ix._device is None and not ix._build_inflight
            out.append(ix)
        jix, ix = out
        assert ix._hydrating is None
        hits = ix.search(Vector(data[5]), 1)   # a full sync, exact
        assert hits[0][0] == 5
        assert ix.mesh_pieces_put == list(range(8))
        q = data[:4] + 0.1
        _same(jix.search_batch(q, 3), ix.search_batch(q, 3))

    @pytest.mark.parametrize("storage", ["f32", "bf16", "int8"])
    def test_hydrator_matches_full_build(self, meshes, storage):
        """Progressive assembly equals the wholesale build, tensor for
        tensor, and answers as the JAX package's."""
        rng = np.random.default_rng(8)
        n, d = 2048, 16
        data = _mat(rng, n, d)
        jix, ix = _pair(meshes, storage=storage)
        for x in (jix, ix):
            x.reserve(n, dim=d)
            hyd = x.start_progressive_hydration(n)
            assert hyd is not None
            for lo in range(0, n, 256):
                x.bulk_append_matrix(np.arange(lo, lo + 256, dtype=np.int64),
                                     data[lo:lo + 256])
                hyd.advance(lo + 256)
            assert hyd.finish() is True
        assert not ix._dirty_slots      # nothing written after its put
        full = ix._build_device_full()
        for key in ("db", "sq_norms", "norms", "valid") + (
                ("scales",) if storage == "int8" else ()):
            for a, b in zip(ix._device[key], full[key]):
                assert torch.equal(a, b), key
        assert float(ix._device["elo_max"]) == float(full["elo_max"])
        got = ix.search_batch(data[:8], 1)
        for qi in range(8):
            assert got[qi][0][0] == qi
        assert ix.mesh_pieces_put == []
        q = _mat(rng, 3, d)
        _same(jix.search_batch(q, 4), ix.search_batch(q, 4))

    def test_write_racing_a_put_is_dirty(self, meshes):
        """A write to a shard whose piece was put is dirty; a write to a
        shard not yet put is in the piece it reads."""
        rng = np.random.default_rng(9)
        _, ix = _pair(meshes)
        n, d = 8192, 8
        data = _mat(rng, n, d)
        ix.reserve(n, dim=d)
        hyd = ix.start_progressive_hydration(n)
        ix.bulk_append_matrix(np.arange(1024, dtype=np.int64), data[:1024])
        hyd.advance(1024)                       # shard 0's range applied
        deadline = 200
        while not hyd._started[0] and deadline:
            import time
            time.sleep(0.01)
            deadline -= 1
        assert hyd._started[0] and not hyd._started[1]
        ix.bulk_append_matrix(np.arange(1024, n, dtype=np.int64),
                              data[1024:])
        with ix._lock:
            ix.remove(5)                         # after shard 0's put
        assert hyd.finish() is True
        assert sorted(ix._dirty_slots) == [5]
        hits = ix.search(Vector(data[5]), 1)
        assert hits[0][0] != 5 and ix.mesh_pieces_put == [0]


def test_reopen_without_tail_puts_no_piece(meshes, tmp_path):
    """The defect repair: a mesh reopen with no WAL tail leaves nothing
    dirty, and the first search puts no piece. The JAX package's hydrator
    leaves every applied slot dirty, so its first search rebuilds the
    whole state it has just hydrated (read here off the JAX package)."""
    jm, tm = meshes
    data = _mat(np.random.default_rng(10), 8000, 16)   # every shard holds rows
    _jengine_dir(tmp_path, data, 8000)
    q = data[:3] + 0.05
    with JEngine.open(tmp_path, JEngineConfig(mesh=jm)) as jeng:
        jix = jeng.store.index
        assert jix._device is not None
        assert len(jix._dirty_slots) == 8000        # the defect
        with jix._lock:
            # more than a quarter dirty: no piece resync, a full rebuild
            assert jix._mesh_piece_resync() is False
        db0 = jix._device["db"]
        jres = [[(h.id, h.distance) for h in jeng.search(J.Vector(x), 5)]
                for x in q]
        assert jix._device["db"] is not db0          # every piece anew
    with StorageEngine.open(tmp_path, EngineConfig(mesh=tm)) as eng:
        ix = eng.store.index
        assert ix._device is not None and not ix._dirty_slots
        db0 = list(ix._device["db"])
        got = [[(h.id, h.distance) for h in eng.search(Vector(x), 5)]
               for x in q]
        assert ix.mesh_pieces_put == []
        assert all(a is b for a, b in zip(ix._device["db"], db0))
    _same(jres, got)
