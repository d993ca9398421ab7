"""The port's durability layer against the JAX package's, on the CPU.

Mirrors tests/test_persistence.py (the HNSW cases wait for the HNSW
slice): the WAL entry codec, WAL framing / CRC / replay, snapshots, the
mmap vector file, corrupt inputs and the engine, each on both backends
(the native C++ core the port builds into ``vectordb_tpu_torch/_build/``,
and the pure-Python backend asked for with ``VDB_TPU_NO_NATIVE=1``).
Then the two packages side by side:

  * byte parity: the same operations through both engines write
    identical ``wal.log``, ``snapshot.bin`` and ``manifest.json`` bytes;
  * cross-read, both ways: a directory written by one package opens in
    the other with the same rows, metadata and ``next_id``, and the two
    answer the same searches (ids equal, distances at rtol 2e-5) for flat
    f32, bf16 and int8, exact and fast, and PQ with ``pq_state.npz``.

The JAX side runs as its own tests run it (Pallas in interpret mode, the
1-pass tier's gate lowered to 512 rows, as in tests/test_torch_store.py);
the port runs on ``device="cpu"``.
"""

import struct
import zlib

import numpy as np
import pytest
import torch

import vectordb_tpu as J
from vectordb_tpu.ops import topk as jtopk
from vectordb_tpu.persistence import EngineConfig as JEngineConfig
from vectordb_tpu.persistence import StorageEngine as JStorageEngine
from vectordb_tpu.persistence import serialization as jser

import vectordb_tpu_torch as T
from vectordb_tpu_torch import DistanceMetric, Metadata, Vector
from vectordb_tpu_torch.errors import (DimensionMismatchError,
                                       SerializationError, StorageError)
from vectordb_tpu_torch.ops import topk as ttopk
from vectordb_tpu_torch.persistence import (DatabaseSnapshot, EngineConfig,
                                            MmapVectorStorage,
                                            SerializedVector,
                                            SnapshotManager, StorageEngine,
                                            WalEntry, WriteAheadLog,
                                            native_lib)
from vectordb_tpu_torch.persistence.serialization import (
    SNAPSHOT_MAGIC, WAL_CHECKPOINT, WAL_DELETE, WAL_INSERT, decode_wal_entry,
    encode_snapshot, encode_wal_entry, write_snapshot_stream)

torch.set_num_threads(1)


@pytest.fixture(params=["native", "python"])
def backend(request, monkeypatch):
    """Both backends; the native one is built, never skipped."""
    if request.param == "python":
        monkeypatch.setenv("VDB_TPU_NO_NATIVE", "1")
    else:
        monkeypatch.delenv("VDB_TPU_NO_NATIVE", raising=False)
        assert native_lib.get_native() is not None
    return request.param


@pytest.fixture
def _tiers(monkeypatch):
    monkeypatch.setenv("VDB_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setattr(jtopk, "_EXACT1P_MIN_N", 512)
    monkeypatch.setattr(ttopk, "_EXACT1P_MIN_N", 512)


def cfg(**kw):
    return EngineConfig(device="cpu", **kw)


def open_engine(path, **kw):
    return StorageEngine.open(path, cfg(**kw))


class TestWalEntryCodec:
    def test_insert_roundtrip(self):
        e = WalEntry.insert("doc-1", 42, np.array([1.5, -2.0], np.float32),
                            {"cat": "x", "lang": "en"})
        got = decode_wal_entry(encode_wal_entry(e))
        assert got.kind == WAL_INSERT
        assert got.string_id == "doc-1"
        assert got.internal_id == 42
        np.testing.assert_array_equal(got.data, e.data)
        assert got.metadata == {"cat": "x", "lang": "en"}

    def test_delete_roundtrip(self):
        got = decode_wal_entry(encode_wal_entry(WalEntry.delete("gone")))
        assert got.kind == WAL_DELETE and got.string_id == "gone"

    def test_checkpoint_roundtrip(self):
        got = decode_wal_entry(encode_wal_entry(WalEntry.checkpoint()))
        assert got.kind == WAL_CHECKPOINT

    def test_unicode_ids(self):
        e = WalEntry.insert("ключ-🔑", 0, np.zeros(2, np.float32), {})
        assert decode_wal_entry(encode_wal_entry(e)).string_id == "ключ-🔑"

    @pytest.mark.parametrize("kind", ["insert", "delete", "checkpoint"])
    def test_bytes_are_the_jax_codecs(self, kind):
        args = {"insert": ("é-1", 7, np.array([0.5, -3.25, 1e-30],
                                                np.float32),
                           {"k": "v", "✓": ""}),
                "delete": ("gone",), "checkpoint": ()}[kind]
        mine = encode_wal_entry(getattr(WalEntry, kind)(*args))
        assert mine == jser.encode_wal_entry(
            getattr(jser.WalEntry, kind)(*args))
        theirs = jser.decode_wal_entry(mine)
        got = decode_wal_entry(mine)
        assert (got.kind, got.string_id, got.internal_id, got.metadata) == \
            (theirs.kind, theirs.string_id, theirs.internal_id,
             theirs.metadata)

    def test_snapshot_bytes_are_the_jax_codecs(self):
        rng = np.random.default_rng(0)
        rows = rng.standard_normal((5, 3)).astype(np.float32)
        meta = {1: {"a": "b"}, 4: {"é": "✓"}}
        mine = encode_snapshot(DatabaseSnapshot(
            [SerializedVector(i, f"s{i}", rows[i]) for i in range(5)],
            meta, 9, 3))
        theirs = jser.encode_snapshot(jser.DatabaseSnapshot(
            [jser.SerializedVector(i, f"s{i}", rows[i]) for i in range(5)],
            meta, 9, 3))
        assert mine == theirs
        got = jser.decode_snapshot(mine)
        assert got.metadata == meta and got.next_id == 9


class TestWal:
    def test_append_replay(self, backend, tmp_path):
        path = tmp_path / "wal.log"
        wal = WriteAheadLog.open(path)
        wal.append(WalEntry.insert("a", 0, np.array([1.0], np.float32)))
        wal.append(WalEntry.delete("a"))
        wal.append(WalEntry.checkpoint())
        wal.close()
        entries = WriteAheadLog.open(path).replay()
        assert [e.kind for e in entries] == [WAL_INSERT, WAL_DELETE,
                                             WAL_CHECKPOINT]

    def test_replay_empty(self, backend, tmp_path):
        wal = WriteAheadLog.open(tmp_path / "wal.log")
        assert wal.replay() == []

    def test_replay_stops_at_garbage(self, backend, tmp_path):
        path = tmp_path / "wal.log"
        wal = WriteAheadLog.open(path)
        wal.append(WalEntry.insert("a", 0, np.array([1.0], np.float32)))
        wal.append(WalEntry.insert("b", 1, np.array([2.0], np.float32)))
        wal.close()
        with open(path, "ab") as f:
            f.write(b"\x07\x00\x00\x00garbage-bytes")
        entries = WriteAheadLog.open(path).replay()
        assert len(entries) == 2
        assert entries[1].string_id == "b"

    def test_replay_stops_at_crc_mismatch(self, backend, tmp_path):
        path = tmp_path / "wal.log"
        wal = WriteAheadLog.open(path)
        wal.append(WalEntry.insert("a", 0, np.array([1.0], np.float32)))
        wal.append(WalEntry.insert("b", 1, np.array([2.0], np.float32)))
        wal.close()
        raw = bytearray(path.read_bytes())
        first_len = struct.unpack_from("<I", raw, 0)[0]
        raw[8 + first_len + 8 + 2] ^= 0xFF
        path.write_bytes(bytes(raw))
        entries = WriteAheadLog.open(path).replay()
        assert [e.string_id for e in entries] == ["a"]

    def test_replay_stops_at_truncated_frame(self, backend, tmp_path):
        path = tmp_path / "wal.log"
        wal = WriteAheadLog.open(path)
        wal.append(WalEntry.insert("a", 0, np.array([1.0], np.float32)))
        wal.close()
        path.write_bytes(path.read_bytes()[:-3])
        assert WriteAheadLog.open(path).replay() == []

    def test_truncate(self, backend, tmp_path):
        path = tmp_path / "wal.log"
        wal = WriteAheadLog.open(path)
        wal.append(WalEntry.delete("x"))
        wal.truncate()
        assert wal.replay() == []
        wal.append(WalEntry.delete("y"))
        wal.close()
        entries = WriteAheadLog.open(path).replay()
        assert [e.string_id for e in entries] == ["y"]

    def test_frame_layout_is_len_crc_payload(self, backend, tmp_path):
        path = tmp_path / "wal.log"
        wal = WriteAheadLog.open(path)
        entry = WalEntry.delete("abc")
        wal.append(entry)
        wal.close()
        raw = path.read_bytes()
        payload = encode_wal_entry(entry)
        length, crc = struct.unpack_from("<II", raw, 0)
        assert length == len(payload)
        assert crc == (zlib.crc32(payload) & 0xFFFFFFFF)
        assert raw[8:] == payload

    def test_one_fsync_per_append_and_per_batch(self, backend, tmp_path,
                                                monkeypatch):
        """The durability floor: an fsync after every append, and ONE for
        a group-committed batch (the Python backend calls os.fsync; the
        native core calls fsync(2) itself, so only its bytes are read)."""
        import os
        calls = []
        real = os.fsync
        monkeypatch.setattr(os, "fsync", lambda fd: (calls.append(fd),
                                                     real(fd))[1])
        wal = WriteAheadLog.open(tmp_path / "wal.log")
        wal.append(WalEntry.delete("a"))
        wal.append(WalEntry.delete("b"))
        wal.append_batch([WalEntry.delete(f"c{i}") for i in range(5)])
        wal.close()
        if backend == "python":
            assert len(calls) == 3
        got = WriteAheadLog.open(tmp_path / "wal.log").replay()
        assert [e.string_id for e in got] == ["a", "b"] + [
            f"c{i}" for i in range(5)]


def test_wal_cross_backend_compat(tmp_path, monkeypatch):
    """Files written natively replay in pure Python and vice versa."""
    monkeypatch.delenv("VDB_TPU_NO_NATIVE", raising=False)
    native_path = tmp_path / "native.log"
    wal = WriteAheadLog.open(native_path)
    assert wal._handle is not None
    wal.append(WalEntry.insert("n", 5, np.array([3.0], np.float32),
                               {"k": "v"}))
    wal.close()
    monkeypatch.setenv("VDB_TPU_NO_NATIVE", "1")
    entries = WriteAheadLog.open(native_path).replay()
    assert entries[0].string_id == "n" and entries[0].metadata == {"k": "v"}
    py_path = tmp_path / "python.log"
    wal = WriteAheadLog.open(py_path)
    assert wal._handle is None
    wal.append(WalEntry.delete("p"))
    wal.close()
    monkeypatch.delenv("VDB_TPU_NO_NATIVE")
    assert WriteAheadLog.open(py_path).replay()[0].string_id == "p"


class TestSnapshot:
    def test_save_load_roundtrip(self, backend, tmp_path):
        mgr = SnapshotManager(tmp_path)
        snap = DatabaseSnapshot(
            vectors=[SerializedVector(0, "a", np.array([1., 2.], np.float32)),
                     SerializedVector(1, "b", np.array([3., 4.], np.float32))],
            metadata={1: {"cat": "x"}}, next_id=2, dimension=2)
        mgr.save(snap)
        got = mgr.load()
        assert got.next_id == 2 and got.dimension == 2
        assert [(v.internal_id, v.string_id) for v in got.vectors] == \
            [(0, "a"), (1, "b")]
        np.testing.assert_array_equal(got.vectors[1].data, [3., 4.])
        assert got.metadata == {1: {"cat": "x"}}

    def test_load_absent_returns_none(self, backend, tmp_path):
        assert SnapshotManager(tmp_path).load() is None
        assert not SnapshotManager(tmp_path).exists()

    def test_manifest(self, backend, tmp_path):
        mgr = SnapshotManager(tmp_path)
        mgr.save(DatabaseSnapshot([], {}, next_id=7, dimension=None))
        assert mgr.manifest() == {"vector_count": 0, "next_id": 7,
                                  "dimension": None}

    def test_no_tmp_residue(self, backend, tmp_path):
        mgr = SnapshotManager(tmp_path)
        mgr.save(DatabaseSnapshot([], {}, 0, None))
        assert not list(tmp_path.glob("*.tmp"))

    def test_stream_writer_byte_parity(self, backend, tmp_path):
        import io
        rng = np.random.default_rng(3)
        vecs = [SerializedVector(i, f"id{i}",
                                 rng.standard_normal(5).astype(np.float32))
                for i in range(37)]
        meta = {4: {"k": "v", "x": "y"}, 11: {"é": "✓"}}
        ref = encode_snapshot(DatabaseSnapshot(vecs, meta, next_id=99,
                                               dimension=5))
        buf = io.BytesIO()
        write_snapshot_stream(
            buf, ((v.internal_id, v.string_id, v.data) for v in vecs),
            meta, 99, 5, len(vecs))
        assert buf.getvalue() == ref

    def test_stream_reader_roundtrip(self, backend, tmp_path):
        mgr = SnapshotManager(tmp_path)
        rows = np.random.default_rng(4).standard_normal(
            (23, 7)).astype(np.float32)
        meta = {5: {"a": "b"}}
        mgr.save_stream(((i, f"v{i}", rows[i]) for i in range(23)), meta,
                        23, 7, 23)
        got = mgr.load()
        assert len(got.vectors) == 23 and got.metadata == meta
        with mgr.open_stream() as r:
            assert (r.count, r.next_id, r.dimension) == (23, 23, 7)
            assert r.read_metadata() == meta
            out = list(r.vectors())
        assert [(i, s) for i, s, _ in out] == [(i, f"v{i}")
                                               for i in range(23)]
        np.testing.assert_array_equal(np.stack([d for _, _, d in out]),
                                      rows)
        assert out[0][2].sum() == rows[0].sum()

    def test_stream_chunks_match_rows(self, backend, tmp_path):
        mgr = SnapshotManager(tmp_path)
        rows = np.random.default_rng(5).standard_normal(
            (50, 6)).astype(np.float32)
        mgr.save_stream(((i, f"v{i}", rows[i]) for i in range(50)), {},
                        50, 6, 50)
        with mgr.open_stream() as r:
            chunks = list(r.vector_chunks(16))
        assert [len(c[0]) for c in chunks] == [16, 16, 16, 2]
        np.testing.assert_array_equal(np.concatenate([c[2] for c in chunks]),
                                      rows)
        assert sum((c[1] for c in chunks), []) == [f"v{i}"
                                                   for i in range(50)]

    def test_stream_count_mismatch_keeps_old_snapshot(self, backend,
                                                      tmp_path):
        mgr = SnapshotManager(tmp_path)
        mgr.save_stream(((0, "keep", np.ones(2, np.float32)),), {}, 1, 2, 1)
        with pytest.raises(SerializationError):
            mgr.save_stream(((0, "new", np.ones(2, np.float32)),),
                            {}, 1, 2, count=5)
        assert not list(tmp_path.glob("*.tmp"))
        with mgr.open_stream() as r:
            assert next(r.vectors())[1] == "keep"


class TestEngine:
    def test_insert_search_reopen(self, backend, tmp_path):
        with open_engine(tmp_path) as eng:
            eng.insert("a", Vector([1.0, 0.0]))
            eng.insert("b", Vector([0.0, 1.0]))
        with open_engine(tmp_path) as eng:
            assert len(eng) == 2
            assert eng.search(Vector([1.0, 0.1]), 1)[0].id == "a"

    def test_chunked_wal_replay_order(self, backend, tmp_path, monkeypatch):
        monkeypatch.setattr(StorageEngine, "_APPLY_CHUNK", 3)
        with open_engine(tmp_path) as eng:
            for i in range(10):
                eng.insert(f"v{i}", Vector([float(i), 0.0]))
            eng.delete("v4")
            eng.insert("v5", Vector([50.0, 1.0]))
            eng.insert("v4", Vector([40.0, 2.0]))
            eng.delete("v9")
        with open_engine(tmp_path) as eng:
            assert sorted(eng.list_ids()) == sorted(
                [f"v{i}" for i in range(9)])
            assert eng.get("v5").as_list() == [50.0, 1.0]
            assert eng.get("v4").as_list() == [40.0, 2.0]
            assert eng.search(Vector([50.0, 1.0]), 1)[0].id == "v5"

    def test_snapshot_plus_wal_recovery(self, backend, tmp_path):
        with open_engine(tmp_path) as eng:
            eng.insert("a", Vector([1.0]))
            eng.checkpoint()
            eng.insert("b", Vector([2.0]))
        with open_engine(tmp_path) as eng:
            assert sorted(eng.list_ids()) == ["a", "b"]

    def test_delete_replay(self, backend, tmp_path):
        with open_engine(tmp_path) as eng:
            eng.insert("a", Vector([1.0]))
            eng.insert("b", Vector([2.0]))
            eng.delete("a")
        with open_engine(tmp_path) as eng:
            assert eng.list_ids() == ["b"]
            assert eng.get("a") is None

    def test_auto_checkpoint_1000_vectors(self, backend, tmp_path):
        with open_engine(tmp_path, checkpoint_interval=100) as eng:
            for i in range(250):
                eng.insert(f"v{i}", Vector([float(i), 0.0]))
        assert SnapshotManager(tmp_path).exists()
        with open_engine(tmp_path, checkpoint_interval=100) as eng:
            assert len(eng) == 250
            assert eng.search(Vector([123.0, 0.0]), 1)[0].id == "v123"

    def test_metadata_persisted(self, backend, tmp_path):
        with open_engine(tmp_path) as eng:
            eng.insert_with_metadata("a", Vector([1.0]),
                                     Metadata({"cat": "books"}))
            eng.checkpoint()
            eng.insert_with_metadata("b", Vector([2.0]),
                                     Metadata({"cat": "films"}))
        with open_engine(tmp_path) as eng:
            assert eng.get_metadata("a").get("cat") == "books"
            assert eng.get_metadata("b").get("cat") == "films"

    def test_upsert_survives_recovery(self, backend, tmp_path):
        with open_engine(tmp_path) as eng:
            eng.insert("a", Vector([1.0]))
            eng.insert("a", Vector([9.0]))
        with open_engine(tmp_path) as eng:
            assert len(eng) == 1
            assert eng.get("a") == Vector([9.0])

    def test_torn_tail_recovers_prefix(self, backend, tmp_path):
        with open_engine(tmp_path) as eng:
            eng.insert("a", Vector([1.0]))
            eng.insert("b", Vector([2.0]))
        with open(tmp_path / "wal.log", "ab") as f:
            f.write(b"\xff\xff\xff\x7fpartial")
        with open_engine(tmp_path) as eng:
            assert sorted(eng.list_ids()) == ["a", "b"]

    def test_write_after_a_torn_tail_survives(self, backend, tmp_path):
        """Recovery cuts the torn frame off, so a write acknowledged after
        it replays at the next reopen (the JAX package appends it behind
        the garbage, where replay stops: ROADMAP queue 3)."""
        with open_engine(tmp_path) as eng:
            eng.insert("a", Vector([1.0]))
            eng.insert("b", Vector([2.0]))
        wal = tmp_path / "wal.log"
        size = wal.stat().st_size
        with open(wal, "r+b") as f:
            f.truncate(size - 3)
        with open_engine(tmp_path) as eng:
            assert eng.list_ids() == ["a"]
            assert eng.wal.replay_end == wal.stat().st_size < size - 3
            eng.insert("c", Vector([3.0]))
        with open_engine(tmp_path) as eng:
            assert eng.list_ids() == ["a", "c"]

    def test_next_id_survives_reopen(self, backend, tmp_path):
        """Internal ids stay monotonic across a checkpoint and a reopen,
        deleted ids included."""
        with open_engine(tmp_path) as eng:
            for i in range(5):
                eng.insert(f"v{i}", Vector([float(i)]))
            eng.delete("v4")
            eng.checkpoint()
            assert eng.store.next_internal_id == 5
        with open_engine(tmp_path) as eng:
            assert eng.store.next_internal_id == 5
            eng.insert("v4", Vector([4.0]))
            assert eng.store.next_internal_id == 6
        assert SnapshotManager(tmp_path).manifest()["next_id"] == 5

    def test_metric_config(self, backend, tmp_path):
        with open_engine(tmp_path, metric=DistanceMetric.COSINE) as eng:
            eng.insert("a", Vector([1.0, 0.0]))
            eng.insert("b", Vector([0.0, 1.0]))
            hits = eng.search(Vector([1.0, 0.0]), 2)
            assert hits[0].id == "a"
            assert hits[0].distance == pytest.approx(0.0)
            assert hits[1].distance == pytest.approx(1.0)


class TestMmapStorage:
    def test_create_append_get(self, backend, tmp_path):
        with MmapVectorStorage.create(tmp_path / "vectors.bin", 3) as st:
            st.append(Vector([1.0, 2.0, 3.0]))
            st.append(np.array([4.0, 5.0, 6.0], np.float32))
            assert st.count == 2 and st.dimension == 3
            assert st.get(1) == Vector([4.0, 5.0, 6.0])

    def test_reopen(self, backend, tmp_path):
        path = tmp_path / "vectors.bin"
        with MmapVectorStorage.create(path, 2) as st:
            st.append(Vector([1.0, 2.0]))
        with MmapVectorStorage.open(path) as st:
            assert st.count == 1 and st.dimension == 2
            assert st.get(0) == Vector([1.0, 2.0])

    def test_get_mmap(self, backend, tmp_path):
        with MmapVectorStorage.create(tmp_path / "vectors.bin", 2) as st:
            st.append(Vector([7.0, 8.0]))
            assert st.get_mmap(0) == Vector([7.0, 8.0])

    def test_read_range_bulk(self, backend, tmp_path, rng):
        data = rng.standard_normal((20, 4)).astype(np.float32)
        with MmapVectorStorage.create(tmp_path / "vectors.bin", 4) as st:
            for row in data:
                st.append(row)
            np.testing.assert_array_equal(st.read_range(5, 10), data[5:15])

    def test_out_of_range(self, backend, tmp_path):
        with MmapVectorStorage.create(tmp_path / "v.bin", 2) as st:
            with pytest.raises(StorageError):
                st.get(0)

    def test_dim_mismatch(self, backend, tmp_path):
        with MmapVectorStorage.create(tmp_path / "v.bin", 2) as st:
            with pytest.raises(DimensionMismatchError):
                st.append(Vector([1.0, 2.0, 3.0]))

    def test_header_layout(self, backend, tmp_path):
        path = tmp_path / "v.bin"
        with MmapVectorStorage.create(path, 5) as st:
            st.append(Vector([0.0] * 5))
        assert struct.unpack("<II", path.read_bytes()[:8]) == (5, 1)

    def test_file_is_the_jax_packages(self, backend, tmp_path):
        from vectordb_tpu.persistence import MmapVectorStorage as JMmap
        rows = np.arange(12, dtype=np.float32).reshape(4, 3)
        with MmapVectorStorage.create(tmp_path / "t.bin", 3) as st:
            for r in rows:
                st.append(r)
        with JMmap.create(tmp_path / "j.bin", 3) as st:
            for r in rows:
                st.append(r)
        assert (tmp_path / "t.bin").read_bytes() == \
            (tmp_path / "j.bin").read_bytes()


def test_mmap_cross_backend_compat(tmp_path, monkeypatch):
    monkeypatch.delenv("VDB_TPU_NO_NATIVE", raising=False)
    path = tmp_path / "v.bin"
    with MmapVectorStorage.create(path, 2) as st:
        assert st._handle is not None
        st.append(Vector([1.0, 2.0]))
    monkeypatch.setenv("VDB_TPU_NO_NATIVE", "1")
    with MmapVectorStorage.open(path) as st:
        assert st._handle is None
        assert st.get(0) == Vector([1.0, 2.0])
        st.append(Vector([3.0, 4.0]))
    monkeypatch.delenv("VDB_TPU_NO_NATIVE")
    with MmapVectorStorage.open(path) as st:
        assert st.count == 2 and st.get(1) == Vector([3.0, 4.0])


def test_native_crc32_matches_zlib(monkeypatch):
    monkeypatch.delenv("VDB_TPU_NO_NATIVE", raising=False)
    native = native_lib.get_native()
    for data in [b"", b"hello", bytes(range(256)) * 17]:
        assert native.vdb_crc32(native_lib.as_u8p(data), len(data)) == \
            (zlib.crc32(data) & 0xFFFFFFFF)


class TestWalBatchAppend:
    def test_batch_roundtrip(self, backend, tmp_path):
        path = tmp_path / "wal.log"
        wal = WriteAheadLog.open(path)
        wal.append_batch([WalEntry.insert(f"v{i}", i,
                                          np.array([float(i)], np.float32),
                                          {"n": str(i)}) for i in range(5)])
        wal.append(WalEntry.delete("v0"))
        wal.close()
        got = WriteAheadLog.open(path).replay()
        assert [e.string_id for e in got] == ["v0", "v1", "v2", "v3", "v4",
                                              "v0"]
        assert got[3].metadata == {"n": "3"}

    def test_empty_batch_is_noop(self, backend, tmp_path):
        wal = WriteAheadLog.open(tmp_path / "wal.log")
        wal.append_batch([])
        assert wal.replay() == []

    def test_torn_batch_replays_prefix(self, backend, tmp_path):
        path = tmp_path / "wal.log"
        wal = WriteAheadLog.open(path)
        wal.append_batch([WalEntry.delete(f"v{i}") for i in range(4)])
        wal.close()
        path.write_bytes(path.read_bytes()[:-5])
        got = WriteAheadLog.open(path).replay()
        assert [e.string_id for e in got] == ["v0", "v1", "v2"]


class TestEngineBatch:
    def test_engine_insert_batch_recovers(self, backend, tmp_path):
        with open_engine(tmp_path) as eng:
            eng.insert_batch([
                T.BatchInsertItem(f"v{i}", Vector([float(i), 0.0]),
                                  Metadata({"i": str(i)}))
                for i in range(20)])
            assert len(eng) == 20
        with open_engine(tmp_path) as eng:
            assert len(eng) == 20
            assert eng.get_metadata("v7").get("i") == "7"
            assert eng.search(Vector([5.0, 0.0]), 1)[0].id == "v5"

    def test_engine_insert_batch_bad_dim_logs_only_prefix(self, backend,
                                                          tmp_path):
        with open_engine(tmp_path) as eng:
            with pytest.raises(DimensionMismatchError):
                eng.insert_batch([
                    T.BatchInsertItem("a", Vector([1.0, 0.0])),
                    T.BatchInsertItem("bad", Vector([1.0])),
                    T.BatchInsertItem("c", Vector([2.0, 0.0]))])
            assert eng.list_ids() == ["a"]
        with open_engine(tmp_path) as eng:
            assert eng.list_ids() == ["a"]

    def test_engine_unknown_index_type(self, backend, tmp_path):
        with pytest.raises(ValueError):
            open_engine(tmp_path, index_type="annoy")

    @pytest.mark.parametrize("kind, item", [("ivf", 11), ("ivfpq", 12)])
    def test_unported_index_types_name_their_items(self, tmp_path, kind,
                                                   item):
        with pytest.raises(ValueError, match=f"item {item}"):
            open_engine(tmp_path, index_type=kind)

    def test_mesh_names_its_item(self, tmp_path):
        with pytest.raises(ValueError, match="item 13"):
            open_engine(tmp_path, mesh=object())

    def test_default_device_is_cuda(self, tmp_path):
        assert EngineConfig().device == "cuda"
        if torch.cuda.is_available():
            pytest.skip("a CUDA card is present")
        with pytest.raises(RuntimeError, match="cuda"):
            StorageEngine.open(tmp_path)


class TestCorruptInputs:
    def test_snapshot_bad_magic_raises(self, backend, tmp_path):
        (tmp_path / "snapshot.bin").write_bytes(b"NOTMAGIC" + b"\x00" * 32)
        with pytest.raises(SerializationError):
            SnapshotManager(tmp_path).load()

    def test_snapshot_truncated_raises(self, backend, tmp_path):
        mgr = SnapshotManager(tmp_path)
        mgr.save(DatabaseSnapshot(
            [SerializedVector(0, "a", np.array([1.0, 2.0], np.float32))],
            {}, 1, 2))
        raw = (tmp_path / "snapshot.bin").read_bytes()
        (tmp_path / "snapshot.bin").write_bytes(raw[:-22])
        with pytest.raises(SerializationError):
            mgr.load()
        # a clipped footer alone loses nothing: the stream reader walks
        (tmp_path / "snapshot.bin").write_bytes(raw[:-6])
        assert [sv.string_id for sv in mgr.load().vectors] == ["a"]
        with mgr.open_stream() as reader:
            assert reader.read_metadata() == {}
            assert [sid for _, sid, _ in reader.vectors()] == ["a"]

    def test_snapshot_torn_header_raises_serialization_error(
            self, backend, tmp_path):
        (tmp_path / "snapshot.bin").write_bytes(SNAPSHOT_MAGIC + b"\x00" * 4)
        with pytest.raises(SerializationError):
            SnapshotManager(tmp_path).open_stream()
        with pytest.raises(SerializationError):
            open_engine(tmp_path)

    def test_failed_auto_checkpoint_does_not_fail_the_write(
            self, backend, tmp_path, monkeypatch):
        with open_engine(tmp_path, checkpoint_interval=3) as eng:
            monkeypatch.setattr(
                StorageEngine, "_save_snapshot_stream",
                lambda self: (_ for _ in ()).throw(
                    SerializationError("snapshot count mismatch")))
            with pytest.warns(UserWarning, match="auto-checkpoint failed"):
                for i in range(4):
                    eng.insert(f"v{i}", Vector([float(i), 0.0]))
            with pytest.raises(SerializationError):
                eng.checkpoint()
        with open_engine(tmp_path) as eng:
            assert sorted(eng.list_ids()) == ["v0", "v1", "v2", "v3"]

    def test_wal_huge_length_field_no_allocation(self, backend, tmp_path):
        path = tmp_path / "wal.log"
        wal = WriteAheadLog.open(path)
        wal.append(WalEntry.delete("ok"))
        wal.close()
        with open(path, "ab") as f:
            f.write(struct.pack("<II", 0x7FFFFFFF, 0x12345678) + b"tiny")
        assert [e.string_id for e in WriteAheadLog.open(path).replay()] == \
            ["ok"]

    def test_wal_zero_length_frame(self, backend, tmp_path):
        path = tmp_path / "wal.log"
        wal = WriteAheadLog.open(path)
        wal.append(WalEntry.delete("ok"))
        wal.close()
        with open(path, "ab") as f:
            f.write(struct.pack("<II", 0, zlib.crc32(b"") & 0xFFFFFFFF))
        assert [e.string_id for e in WriteAheadLog.open(path).replay()] == \
            ["ok"]


# ---------------------------------------------------------------------------
# the two packages side by side
# ---------------------------------------------------------------------------

N, D = 2000, 32
PKG = {"jax": J, "torch": T}


def _engine(pkg, path, **kw):
    if pkg == "jax":
        return JStorageEngine.open(path, JEngineConfig(**kw))
    return StorageEngine.open(path, EngineConfig(device="cpu", **kw))


def _metric(pkg, name):
    return PKG[pkg].DistanceMetric(name)


def _write_ops(pkg, path, rows, checkpoint=True, **kw):
    """The same operations through either engine: a batch with metadata,
    single inserts, an upsert, deletes, a checkpoint, then a WAL tail."""
    mod = PKG[pkg]
    half = len(rows) // 2
    with _engine(pkg, path, checkpoint_interval=10 ** 9, **kw) as eng:
        eng.insert_batch([mod.BatchInsertItem(
            f"r{i}", mod.Vector(rows[i]),
            mod.Metadata({"g": str(i % 4)} if i % 3 == 0 else {}))
            for i in range(half)])
        for i in range(half, half + 5):
            eng.insert_with_metadata(f"r{i}", mod.Vector(rows[i]),
                                     mod.Metadata({"s": "é"}))
        eng.insert("r1", mod.Vector(rows[-1]))       # upsert
        for i in range(7, 40, 3):
            eng.delete(f"r{i}")
        if checkpoint:
            eng.checkpoint()
        eng.insert_batch([mod.BatchInsertItem(f"r{i}", mod.Vector(rows[i]))
                          for i in range(half + 5, len(rows) - 1)])
        eng.delete("r2")
        eng.insert("r10", mod.Vector(rows[0] * 0.5))  # re-insert deleted


@pytest.mark.parametrize("storage", ["f32", "bf16", "int8"])
def test_engines_write_identical_bytes(backend, tmp_path, storage):
    rows = np.random.default_rng(1).standard_normal((300, D)).astype(
        np.float32)
    for pkg in ("jax", "torch"):
        _write_ops(pkg, tmp_path / pkg, rows, storage=storage)
    for name in ("wal.log", "snapshot.bin", "manifest.json"):
        assert (tmp_path / "torch" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name
    # and after a second checkpoint of the WAL tail
    for pkg in ("jax", "torch"):
        with _engine(pkg, tmp_path / pkg, storage=storage) as eng:
            eng.checkpoint()
    for name in ("wal.log", "snapshot.bin", "manifest.json"):
        assert (tmp_path / "torch" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name


def _answers(eng, pkg, qs, k=10):
    mod = PKG[pkg]
    res = eng.search_batch([(mod.Vector(q), k) for q in qs])
    return ([[r.id for r in row] for row in res],
            np.array([[r.distance for r in row] for row in res]))


def _state(eng):
    store = eng.store
    ids = sorted(store.list_ids())
    return (ids, [store.get_metadata(i).fields() for i in ids],
            np.stack([store.get(i).as_array() for i in ids]),
            store.next_internal_id)


def _same_state(a, b):
    assert a[0] == b[0] and a[1] == b[1] and a[3] == b[3]
    assert np.array_equal(a[2].view(np.uint32), b[2].view(np.uint32))


@pytest.mark.usefixtures("_tiers")
@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("storage, mode", [
    ("f32", "exact"), ("f32", "fast"), ("bf16", "exact"), ("bf16", "fast"),
    ("int8", "exact"), ("int8", "fast")])
def test_flat_directory_opens_in_the_other_package(tmp_path, writer,
                                                   storage, mode):
    reader = "torch" if writer == "jax" else "jax"
    rng = np.random.default_rng(2)
    rows = rng.standard_normal((N, D)).astype(np.float32)
    qs = rng.standard_normal((8, D)).astype(np.float32)
    kw = dict(storage=storage, search_mode=mode)
    _write_ops(writer, tmp_path, rows, **kw)
    with _engine(writer, tmp_path, **kw) as eng:
        want_state = _state(eng)
        want_ids, want_d = _answers(eng, writer, qs)
    with _engine(reader, tmp_path, **kw) as eng:
        _same_state(want_state, _state(eng))
        got_ids, got_d = _answers(eng, reader, qs)
    assert got_ids == want_ids
    np.testing.assert_allclose(got_d, want_d, rtol=2e-5, atol=2e-5)


def _clustered(rng, n, d, n_centers=16, scale=0.15):
    centers = rng.standard_normal((n_centers, d)).astype(np.float32)
    which = rng.integers(0, n_centers, n)
    return (centers[which]
            + scale * rng.standard_normal((n, d)).astype(np.float32))


@pytest.mark.usefixtures("_tiers")
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_pq_directory_opens_in_the_other_package(tmp_path, writer,
                                                 monkeypatch):
    """PQ: the writer trains, checkpoints (pq_state.npz), writes a tail;
    the reader imports the codebook without training, re-encodes the
    recovered rows to the same codes, and answers the same."""
    from vectordb_tpu.index import pq as jpqi

    from vectordb_tpu_torch.index import pq as tpqi
    reader = "torch" if writer == "jax" else "jax"
    rng = np.random.default_rng(3)
    rows = _clustered(rng, N, D)
    qs = np.concatenate([rows[:8] + 0.01, _clustered(rng, 8, D)])
    with _engine(writer, tmp_path, index_type="pq",
                 checkpoint_interval=10 ** 9) as eng:
        mod = PKG[writer]
        eng.insert_batch([mod.BatchInsertItem(str(i), mod.Vector(rows[i]))
                          for i in range(N - 100)])
        eng.store.index.train()
        eng.checkpoint()
        eng.insert_batch([mod.BatchInsertItem(str(i), mod.Vector(rows[i]))
                          for i in range(N - 100, N)])
        eng.delete("5")
    assert (tmp_path / "pq_state.npz").exists()
    with _engine(writer, tmp_path, index_type="pq") as eng:
        want_cb = np.asarray(eng.store.index._codebook)
        want_ids, want_d = _answers(eng, writer, qs)
    for mod in (jpqi.PqFlatIndex, tpqi.PqFlatIndex):
        monkeypatch.setattr(mod, "train", lambda self: pytest.fail(
            "reopen retrained"))
    with _engine(reader, tmp_path, index_type="pq") as eng:
        assert eng.store.index.is_trained and len(eng) == N - 1
        assert np.array_equal(np.asarray(eng.store.index._codebook), want_cb)
        got_ids, got_d = _answers(eng, reader, qs)
    assert got_ids == want_ids
    np.testing.assert_allclose(got_d, want_d, rtol=2e-5, atol=2e-5)
