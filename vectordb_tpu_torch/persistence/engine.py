"""StorageEngine: crash-safe database = VectorStore + WAL + snapshots.

Port of ``vectordb_tpu/persistence/engine.py`` for the index types the
port has: "flat" (``storage=`` f32, bf16 or int8; ``search_mode`` exact or
fast), "pq" (PQ-Flat, its trained codebook kept in ``pq_state.npz``),
"hnsw" (``hnsw_params``; its graph tables kept in ``hnsw_graph.npz``,
bound to the snapshot's sha256 and imported on reopen instead of rebuilt),
"ivf" (IVF-Flat, ``storage=`` f32, bf16 or int8; its trained layout,
centroids and slot assignment, kept in ``ivf_state.npz``, bound to the
snapshot the same way and imported on reopen instead of retrained) and
"ivfpq" (IVF-PQ, f32 only; the layout plus its residual codebook, spill
rows' centroid ids and rotation in ``ivfpq_state.npz``, bound and
imported the same way; the codes re-encode from the recovered rows).
Capability parity with reference src/persistence/engine.rs:15-228:
  * ``open``: mkdir, load snapshot, replay WAL on top (engine.rs:44-73)
  * WAL-first durable writes for insert/delete (engine.rs:107-160): one
    fsync per append, one per ``insert_batch`` (group commit)
  * auto-checkpoint every ``checkpoint_interval`` WAL entries, default 1000
    (engine.rs:22-29, 199-204); checkpoint = snapshot save -> Checkpoint
    entry -> WAL truncate (engine.rs:187-196)

Unlike the JAX package, recovery cuts a torn or corrupt WAL tail off after
replaying the valid prefix, so a write acknowledged after that recovery
is not appended behind garbage, where the next replay would stop before
it (ROADMAP queue 3). As in the JAX package, metadata and ``next_id`` are
persisted, snapshot
writes are atomic (tmp + rename + fsync), and recovery streams the
snapshot in vectorized chunks (a readahead thread overlapping its disk
reads) and replays the WAL tail in chunks, while the flat index builds its
device state on a side thread (``FlatIndex.prehydrate``). The next search
runs the same kernels as on a fresh store. The files are the JAX
package's, byte for byte: either package opens the other's directory.

``EngineConfig.device`` (default "cuda") is where the index's device state
lives; "cuda" without a card raises (an HNSW store keeps its graph on the
host and runs its device build and batched traversal there).
``EngineConfig.mesh`` (a parallel.Mesh; index types "flat" and "pq")
shards the packed rows or codes over the mesh instead: recovery puts each
shard's piece to its device while the snapshot apply goes on
(``FlatIndex.start_progressive_hydration``), and the first search re-puts
only the shards the WAL tail wrote. The files are the same as without a
mesh: shard ``s`` owns slots ``[s*B, (s+1)*B)``.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

from ..distance import DistanceMetric
from ..errors import DimensionMismatchError, VectorNotFoundError
from ..metadata import Metadata
from ..store import BatchInsertItem, SearchResult, VectorStore
from ..vector import Vector
from .serialization import (WAL_CHECKPOINT, WAL_DELETE, WAL_INSERT,
                            DatabaseSnapshot, WalEntry)
from .snapshot import SnapshotManager, _durable_write
from .wal import WriteAheadLog

WAL_FILE = "wal.log"


class _ChunkedInserter:
    """Accumulate BatchInsertItems and flush them through the store's
    vectorized bulk path in fixed-size chunks (WAL replay): far faster
    than per-entry inserts, with peak memory at one chunk."""

    def __init__(self, store: VectorStore, chunk_size: int):
        self._store = store
        self._size = int(chunk_size)
        self._items: List[BatchInsertItem] = []

    def add(self, item: BatchInsertItem) -> None:
        self._items.append(item)
        if len(self._items) >= self._size:
            self.flush()

    def flush(self) -> None:
        if self._items:
            self._store.insert_batch(self._items)
            self._items = []


@dataclass
class EngineConfig:
    """Engine tuning (reference: engine.rs:15-29), in the JAX package's
    field order; ``device`` (the port's own) comes last. ``storage`` (flat
    only): quantization at insert is idempotent (pow2 scales / bf16
    round-trip), so WAL replay and snapshot re-apply reproduce the stored
    values bit for bit. ``hnsw_params`` (index_type "hnsw"): an
    ``HnswParams``, default ``HnswParams()``. ``mesh``: a parallel.Mesh
    for sharded storage (index types "flat" and "pq"; ``device`` is then
    unused)."""
    checkpoint_interval: int = 1000
    metric: DistanceMetric = DistanceMetric.EUCLIDEAN
    index_type: str = "flat"   # "flat" | "hnsw" | "ivf" | "pq" | "ivfpq"
    hnsw_params: Optional[object] = None
    mesh: Optional[object] = None
    search_mode: str = "exact"      # flat scan mode: "exact" | "fast"
    storage: str = "f32"            # flat/ivf: "f32" | "bf16" | "int8"
    device: str = "cuda"            # where the index's device state lives


class StorageEngine:
    GRAPH_FILE = "hnsw_graph.npz"
    IVF_FILE = "ivf_state.npz"
    PQ_FILE = "pq_state.npz"
    IVFPQ_FILE = "ivfpq_state.npz"
    _APPLY_CHUNK = 65536

    def __init__(self, data_dir: "str | Path",
                 config: Optional[EngineConfig] = None):
        self.config = cfg = config or EngineConfig()
        if cfg.mesh is not None and cfg.index_type in ("hnsw", "ivf",
                                                       "ivfpq"):
            # a silently ignored mesh would read as sharded durability
            # without being one; only flat (f32/bf16/int8) and pq shard
            raise ValueError(
                f"index_type={cfg.index_type!r} does not support mesh= "
                "(sharded lanes: 'flat' and 'pq')")
        if cfg.index_type in ("pq", "ivfpq") and cfg.storage != "f32":
            raise ValueError(
                f"index_type={cfg.index_type!r} owns its device "
                "representation (codes); storage quantization modes do "
                "not compose")
        if cfg.index_type == "pq":
            from ..index.pq import PqFlatIndex
            index = PqFlatIndex(cfg.metric, mesh=cfg.mesh,
                                device=cfg.device)
        elif cfg.index_type == "ivfpq":
            from ..index.ivfpq import IvfPqIndex
            index = IvfPqIndex(cfg.metric, device=cfg.device)
        elif cfg.index_type == "hnsw":
            from ..index.hnsw import HnswIndex, HnswParams
            index = HnswIndex(cfg.metric, cfg.hnsw_params or HnswParams(),
                              device=cfg.device)
        elif cfg.index_type == "ivf":
            from ..index.ivf import IvfFlatIndex
            index = IvfFlatIndex(cfg.metric, storage=cfg.storage,
                                 device=cfg.device)
        elif cfg.index_type == "flat":
            from ..index.flat import FlatIndex
            index = FlatIndex(cfg.metric, search_mode=cfg.search_mode,
                              mesh=cfg.mesh, storage=cfg.storage,
                              device=cfg.device)
        else:
            raise ValueError(f"unknown index_type: {cfg.index_type!r}")
        self.store = VectorStore.with_index(index)
        self.data_dir = Path(data_dir)
        self.data_dir.mkdir(parents=True, exist_ok=True)
        self.snapshots = SnapshotManager(self.data_dir)
        self.wal = WriteAheadLog.open(self.data_dir / WAL_FILE)
        self._wal_count = 0
        # seconds since the start of recovery at each of its marks
        # (``VDB_RECOVER_TIMING`` also prints them to stderr)
        self.recovery_marks: dict = {}
        self._recover()

    @classmethod
    def open(cls, data_dir: "str | Path",
             config: Optional[EngineConfig] = None) -> "StorageEngine":
        return cls(data_dir, config)

    # -- recovery (reference: engine.rs:44-104) ------------------------------

    def _recover(self) -> None:
        timing = bool(os.environ.get("VDB_RECOVER_TIMING"))
        t0 = time.perf_counter()

        def _mark(label: str) -> None:
            self.recovery_marks[label] = time.perf_counter() - t0
            if timing:
                print(f"[recover] {label}: "
                      f"{time.perf_counter() - t0:.1f}s",
                      file=sys.stderr, flush=True)

        self._recover_mark = _mark
        # a mesh's progressive hydrator, started by the snapshot apply
        self._hydrator = None
        hydrator = None
        try:
            if self.config.index_type in ("hnsw", "ivf", "ivfpq"):
                # the graph or layout import binds to the whole id set: the
                # snapshot is read whole (these families checkpoint at far
                # smaller row counts)
                snap = self.snapshots.load()
                if snap is not None:
                    imported = (self._try_import_graph(snap)
                                if self.config.index_type == "hnsw"
                                else self._try_import_layout(snap))
                    if not imported:
                        self._apply_snapshot(snap)
            else:
                reader = self.snapshots.open_stream()
                if reader is not None:
                    with reader:
                        self._apply_snapshot_stream(reader)
            _mark("snapshot applied")
            # overlap the device build with the WAL tail: the snapshot rows
            # (the bulk of the database) are final in host storage now, so the
            # host-to-device copies run on a side thread while the tail replays
            # host-side; rows the replay touches are re-scattered by the first
            # locked sync, which also waits on the build's event
            if (self._hydrator is None and self.config.index_type == "flat"
                    and len(self.store)):
                index = self.store.index

                def _hydrate():
                    h0 = time.perf_counter()
                    index.prehydrate()
                    self.recovery_marks["hydration build"] = (
                        time.perf_counter() - h0)

                hydrator = threading.Thread(target=_hydrate, daemon=True)
                hydrator.start()
            # consecutive WAL inserts go through the store's bulk path in
            # chunks; deletes flush the pending chunk first so apply order is
            # exact, and duplicate ids within a chunk keep upsert semantics
            # (insert_batch applies items in order)
            pending = _ChunkedInserter(self.store, self._APPLY_CHUNK)
            for entry in self.wal.iter_replay():
                if entry.kind == WAL_INSERT:
                    pending.add(BatchInsertItem(
                        id=entry.string_id, vector=Vector(entry.data),
                        metadata=Metadata(entry.metadata)))
                    self._wal_count += 1
                else:
                    pending.flush()
                    self._apply_wal_entry(entry)
            pending.flush()
            # a torn or corrupt tail goes: appends from here on must follow
            # the last valid frame to be replayed after the next crash
            self.wal.trim_to_replayed()
            _mark("wal replayed")
        finally:
            if self._hydrator is not None:
                installed = self._hydrator.finish()
                self._hydrator = None
                _mark(f"progressive hydration finished "
                      f"(installed={installed})")
            if hydrator is not None:
                hydrator.join()
        if hydrator is not None:
            _mark("hydration joined")
        self._try_import_pq()

    def _pq_path(self) -> Path:
        return self.data_dir / self.PQ_FILE

    def _graph_path(self) -> Path:
        return self.data_dir / self.GRAPH_FILE

    def _layout_path(self) -> Path:
        """The trained-layout state file of an "ivf" or "ivfpq" engine."""
        return self.data_dir / (self.IVFPQ_FILE
                                if self.config.index_type == "ivfpq"
                                else self.IVF_FILE)

    def _try_import_layout(self, snap: DatabaseSnapshot) -> bool:
        """Restore a trained IVF layout (centroids + slot assignment; for
        IVF-PQ also the residual codebook, the spill rows' centroid ids
        and the rotation, the codes re-encoding from the rows) instead of
        retraining on the first search: recovery reproduces the
        pre-crash search behaviour exactly (reference parity:
        engine.rs:44-73 replays to identical state). The state must
        belong to exactly this snapshot (its sha256) and name exactly its
        ids; any mismatch or corruption rebuilds from the snapshot."""
        path = self._layout_path()
        if not path.exists():
            return False
        try:
            import numpy as np
            with np.load(path) as z:
                tables = {key: z[key] for key in z.files}
            if str(tables.get("metric", "")) != self.config.metric.value:
                return False
            if str(tables.get("snapshot_digest", "")) != \
                    self._snapshot_digest():
                return False
            id_of_slot = np.asarray(tables["id_of_slot"], np.int64)
            state_ids = {int(i) for i in id_of_slot[id_of_slot >= 0]}
            if state_ids != {sv.internal_id for sv in snap.vectors}:
                return False
            rows_by_id = {sv.internal_id: sv.data for sv in snap.vectors}
            self.store.index.import_trained_state(
                tables, rows_by_id, int(snap.dimension))
            self.store.adopt_index_state(
                {sv.internal_id: sv.string_id for sv in snap.vectors},
                snap.metadata, snap.next_id, snap.dimension)
            return True
        except Exception:
            return False  # any inconsistency: rebuild from the snapshot

    def _try_import_graph(self, snap: DatabaseSnapshot) -> bool:
        """Fast HNSW reopen: restore the checkpointed graph tables instead
        of re-inserting every row (O(read) against O(rebuild)). Any
        mismatch or corruption falls back to the rebuild."""
        if not self._graph_path().exists():
            return False
        try:
            import numpy as np
            index = self.store.index
            with np.load(self._graph_path()) as z:
                tables = {key: z[key] for key in z.files}
            params = index.params
            if (int(tables["m"]) != params.m
                    or int(tables["m_max0"]) != params.m_max0
                    or int(tables["max_layers"]) != params.max_layers
                    or str(tables["metric"]) != self.config.metric.value):
                return False
            # the graph must belong to EXACTLY this snapshot: a crash
            # between the snapshot and graph writes (or a rebuild that
            # remapped internal ids) leaves a stale graph whose id set can
            # still collide, which only the content digest tells apart
            if str(tables.get("snapshot_digest", "")) != \
                    self._snapshot_digest():
                return False
            graph_ids = {int(i) for i in tables["id_of_slot"][
                np.asarray(tables["valid"], dtype=bool)]}
            if graph_ids != {sv.internal_id for sv in snap.vectors}:
                return False
            index.graph.import_padded_tables(tables)
            self.store.adopt_index_state(
                {sv.internal_id: sv.string_id for sv in snap.vectors},
                snap.metadata, snap.next_id, snap.dimension)
            return True
        except Exception:
            return False  # any inconsistency: rebuild from the snapshot

    def _apply_snapshot(self, snap: DatabaseSnapshot) -> None:
        """Rebuild from a materialized snapshot: one batched insert of
        every row with its metadata, then the internal-id counter."""
        items = [BatchInsertItem(
            id=sv.string_id, vector=Vector(sv.data),
            metadata=Metadata(snap.metadata.get(sv.internal_id) or {}))
            for sv in snap.vectors]
        if items:
            self.store.insert_batch(items)
        self.store.restore_next_internal_id(snap.next_id)

    def _try_import_pq(self) -> bool:
        """Restore a trained PQ codebook so reopen never retrains. The
        codebook is a pure quantizer, valid for any row set of its
        dimension (codes re-encode from the recovered rows), so it needs
        only metric and dimension agreement."""
        if self.config.index_type != "pq" or not self._pq_path().exists():
            return False
        try:
            import numpy as np
            with np.load(self._pq_path()) as z:
                tables = {key: z[key] for key in z.files}
            if str(tables.get("metric", "")) != self.config.metric.value:
                return False
            cb = np.asarray(tables["codebook"], np.float32)
            dim = self.store.dimension
            # an empty store fixes its dimension on first insert: a stale
            # codebook would wedge every later search, and with zero rows
            # there is nothing to encode, so auto-train refits instead
            if dim is None or cb.shape[0] * cb.shape[2] != dim:
                return False
            self.store.index.import_trained_state(tables)
            return True
        except Exception:
            return False  # stale/corrupt state: retrain on first search

    def _apply_snapshot_stream(self, reader) -> None:
        """Vectorized chunked restore from a SnapshotStreamReader: matrix
        chunks with their ORIGINAL internal ids go through the store's
        no-per-row-object path (restore_snapshot_chunk), and a pread
        readahead thread overlaps the disk reads with the Python decode
        walk (mmap page faults hold the GIL; pread does not). Bounded
        memory: one 64k-row chunk."""
        stop = threading.Event()
        ra = threading.Thread(target=reader.readahead, args=(stop,),
                              daemon=True)
        ra.start()
        try:
            metadata = reader.read_metadata()
            self._recover_mark("metadata walk")
            if reader.count and reader.dimension:
                # one allocation up front instead of pow2 growth by chunk
                self.store.reserve(reader.count, reader.dimension)
                if self.config.index_type == "flat":
                    # mesh lane: shard pieces go to their devices under
                    # the apply (None without a mesh: the post-apply
                    # thread builds instead)
                    start = getattr(self.store.index,
                                    "start_progressive_hydration", None)
                    if start is not None:
                        self._hydrator = start(reader.count)
            t_decode = t_apply = 0.0
            applied = 0
            t_mark = time.perf_counter()
            for iids, sids, rows in reader.vector_chunks(self._APPLY_CHUNK):
                now = time.perf_counter()
                t_decode += now - t_mark
                self.store.restore_snapshot_chunk(iids, sids, rows,
                                                  metadata)
                t_mark = time.perf_counter()
                t_apply += t_mark - now
                applied += len(iids)
                if self._hydrator is not None:
                    self._hydrator.advance(applied)
            self._recover_mark(
                f"apply split: decode+IO {t_decode:.0f}s / "
                f"store-apply {t_apply:.0f}s")
        finally:
            stop.set()
            ra.join()
        self.store.restore_next_internal_id(reader.next_id)

    def _apply_wal_entry(self, entry: WalEntry) -> None:
        if entry.kind == WAL_INSERT:
            self.store.insert_with_metadata(
                entry.string_id, Vector(entry.data), Metadata(entry.metadata))
            self._wal_count += 1
        elif entry.kind == WAL_DELETE:
            try:
                self.store.delete(entry.string_id)
            except VectorNotFoundError:
                pass  # the logged delete may have failed at runtime too
            self._wal_count += 1
        elif entry.kind == WAL_CHECKPOINT:
            pass

    # -- durable writes (reference: engine.rs:107-160) -----------------------

    def insert(self, id: str, vector: Vector) -> None:
        self.insert_with_metadata(id, vector, Metadata())

    def insert_with_metadata(self, id: str, vector: Vector,
                             metadata: Metadata) -> None:
        # validate BEFORE logging: a WAL entry the store would reject would
        # abort every future recovery (the store re-raises during replay)
        expected = self.store.dimension
        if expected is not None and vector.dimension != expected:
            raise DimensionMismatchError(expected, vector.dimension)
        internal_id = self.store.next_internal_id
        self.wal.append(WalEntry.insert(str(id), internal_id,
                                        vector.as_array(), metadata.fields()))
        self._wal_count += 1
        self.store.insert_with_metadata(id, vector, metadata)
        self._maybe_checkpoint()

    def insert_batch(self, items: List[BatchInsertItem]) -> None:
        """Durable bulk insert: one group-committed WAL write (one fsync),
        then one batched store apply. Dimensions are validated before
        logging, so the WAL never records entries the store would reject
        and replay reproduces the runtime state."""
        expected = self.store.dimension
        accepted: List[BatchInsertItem] = []
        error = None
        for item in items:
            dim = item.vector.dimension
            if expected is None:
                expected = dim
            elif dim != expected:
                error = DimensionMismatchError(expected, dim)
                break
            accepted.append(item)
        if accepted:
            base = self.store.next_internal_id
            entries = [
                WalEntry.insert(str(item.id), base + i,
                                item.vector.as_array(),
                                item.metadata.fields())
                for i, item in enumerate(accepted)
            ]
            self.wal.append_batch(entries)
            self._wal_count += len(entries)
            self.store.insert_batch(accepted)
            self._maybe_checkpoint()
        if error is not None:
            raise error

    def delete(self, id: str) -> Vector:
        self.wal.append(WalEntry.delete(str(id)))
        self._wal_count += 1
        removed = self.store.delete(id)
        self._maybe_checkpoint()
        return removed

    # -- reads (proxied to the store) ----------------------------------------
    # The full VectorStore read surface, so the engine can sit directly
    # behind the HTTP AppState (``serve --durable-dir``).

    def search(self, query: Vector, k: int, *, ef: Optional[int] = None,
               nprobe: Optional[int] = None,
               refine: Optional[int] = None,
               filter=None) -> List[SearchResult]:
        return self.store.search(query, k, ef=ef, nprobe=nprobe,
                                 refine=refine, filter=filter)

    def search_with_filter(self, query: Vector, k: int, filter, *,
                           ef: Optional[int] = None,
                           nprobe: Optional[int] = None,
                           refine: Optional[int] = None
                           ) -> List[SearchResult]:
        return self.store.search_with_filter(query, k, filter, ef=ef,
                                             nprobe=nprobe, refine=refine)

    def search_radius(self, query: Vector, radius: float, *,
                      limit: int = 100, filter=None) -> List[SearchResult]:
        return self.store.search_radius(query, radius, limit=limit,
                                        filter=filter)

    def search_batch(self, queries, *, ef: Optional[int] = None,
                     nprobe: Optional[int] = None,
                     refine: Optional[int] = None):
        return self.store.search_batch(queries, ef=ef, nprobe=nprobe,
                                       refine=refine)

    def search_batch_submit(self, queries, *, ef: Optional[int] = None,
                            nprobe: Optional[int] = None,
                            refine: Optional[int] = None):
        return self.store.search_batch_submit(queries, ef=ef,
                                              nprobe=nprobe, refine=refine)

    def search_batch_with_filter(self, queries, filter, *,
                                 ef: Optional[int] = None,
                                 nprobe: Optional[int] = None,
                                 refine: Optional[int] = None):
        return self.store.search_batch_with_filter(
            queries, filter, ef=ef, nprobe=nprobe, refine=refine)

    @property
    def metric(self) -> DistanceMetric:
        return self.store.metric

    @property
    def dimension(self) -> Optional[int]:
        return self.store.dimension

    def get(self, id: str) -> Optional[Vector]:
        return self.store.get(id)

    def get_metadata(self, id: str) -> Optional[Metadata]:
        return self.store.get_metadata(id)

    def __len__(self) -> int:
        return len(self.store)

    def is_empty(self) -> bool:
        return self.store.is_empty()

    def list_ids(self) -> List[str]:
        return self.store.list_ids()

    # -- checkpointing (reference: engine.rs:187-228) ------------------------

    def _maybe_checkpoint(self) -> None:
        if self._wal_count < self.config.checkpoint_interval:
            return
        try:
            self.checkpoint()
        except Exception as e:
            # the WAL append and the store apply already succeeded, so the
            # row IS durable (recovery replays the uncompacted WAL): warn,
            # skip the compaction, and retry after another full interval,
            # so a persistent fault cannot turn every later insert into a
            # failed O(N) snapshot. An explicit checkpoint() still raises.
            import warnings
            warnings.warn(
                f"auto-checkpoint failed ({e!r}); the write is durable "
                f"in the WAL; retrying after the next "
                f"{self.config.checkpoint_interval} entries")
            self._wal_count = 0

    def checkpoint(self) -> None:
        self._save_snapshot_stream()
        self._save_graph()
        self._save_ivf()
        self._save_pq()
        self.wal.append(WalEntry.checkpoint())
        self.wal.truncate()
        self._wal_count = 0

    def _save_snapshot_stream(self) -> None:
        """Stream the snapshot straight from the index to disk (the bytes
        of the materialized encoder, ~64 MB of peak memory)."""
        id_map = self.store.internal_to_string_ids()
        metadata: dict = {}

        def rows():
            for internal_id, vector in self.store.index.iter_items():
                string_id = id_map.get(internal_id)
                if string_id is None:
                    # out-of-sync id map: fewer rows than the header count,
                    # so the writer aborts (and discards the tmp file)
                    # instead of persisting a corrupt snapshot
                    continue
                meta = self.store.get_metadata(string_id)
                if meta is not None and not meta.is_empty():
                    metadata[internal_id] = meta.fields()
                yield internal_id, string_id, vector.as_array()

        self.snapshots.save_stream(rows(), metadata,
                                   self.store.next_internal_id,
                                   self.store.dimension, len(self.store))

    def _snapshot_digest(self) -> str:
        """sha256 of snapshot.bin ("" when absent): binds a graph file to
        the snapshot it was written beside."""
        import hashlib
        h = hashlib.sha256()
        try:
            with open(self.snapshots.snapshot_path, "rb") as f:
                while True:
                    blk = f.read(64 << 20)
                    if not blk:
                        return h.hexdigest()
                    h.update(blk)
        except OSError:
            return ""

    def _save_graph(self) -> None:
        """Write the HNSW graph tables beside the snapshot (the JAX
        package's ``hnsw_graph.npz``, byte for byte) so reopen imports
        instead of rebuilding."""
        if self.config.index_type != "hnsw":
            return
        import io

        import numpy as np
        index = self.store.index
        tables = index.graph.export_padded_tables()
        params = index.params
        buf = io.BytesIO()
        np.savez(buf, m=params.m, m_max0=params.m_max0,
                 max_layers=params.max_layers,
                 metric=self.config.metric.value,
                 snapshot_digest=self._snapshot_digest(), **tables)
        _durable_write(self._graph_path(), buf.getvalue())

    def _save_ivf(self) -> None:
        """Write the trained IVF or IVF-PQ state (the JAX package's
        ``ivf_state.npz`` / ``ivfpq_state.npz``, byte for byte) beside the
        snapshot so reopen imports it instead of retraining. Untrained:
        remove any stale file, so recovery cannot bind an old layout to a
        newer snapshot."""
        if self.config.index_type not in ("ivf", "ivfpq"):
            return
        path = self._layout_path()
        state = self.store.index.export_trained_state()
        if state is None:
            path.unlink(missing_ok=True)
            return
        import io

        import numpy as np
        buf = io.BytesIO()
        np.savez(buf, metric=self.config.metric.value,
                 snapshot_digest=self._snapshot_digest(), **state)
        _durable_write(path, buf.getvalue())

    def _save_pq(self) -> None:
        """Serialize the trained PQ codebook beside the snapshot so reopen
        re-encodes instead of retraining."""
        if self.config.index_type != "pq":
            return
        state = self.store.index.export_trained_state()
        if state is None:
            self._pq_path().unlink(missing_ok=True)
            return
        import io

        import numpy as np
        buf = io.BytesIO()
        np.savez(buf, metric=self.config.metric.value, **state)
        _durable_write(self._pq_path(), buf.getvalue())

    def close(self) -> None:
        self.wal.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


__all__ = ["StorageEngine", "EngineConfig", "WAL_FILE"]
