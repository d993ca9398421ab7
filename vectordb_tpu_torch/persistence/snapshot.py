"""Snapshot manager: full-state binary snapshots + human-readable manifest.

Port of ``vectordb_tpu/persistence/snapshot.py``, unchanged in behaviour.

Capability parity with reference src/persistence/snapshot.rs:9-64:
``save`` writes ``snapshot.bin`` (binary DatabaseSnapshot) and
``manifest.json`` {vector_count, next_id, dimension}; ``load`` returns None
when no snapshot exists. Improvement over the reference: the snapshot write
is atomic + durable (tmp file, fsync, rename, directory fsync) via the
native core, so a crash mid-checkpoint can never destroy the previous
snapshot.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Optional

from ..errors import SerializationError, VdbIoError
from . import native_lib
from .serialization import (DatabaseSnapshot, SnapshotStreamReader,
                            decode_snapshot, encode_snapshot,
                            write_snapshot_stream)

SNAPSHOT_FILE = "snapshot.bin"
MANIFEST_FILE = "manifest.json"


def _durable_write_with(path: Path, write_fn) -> None:
    """THE atomic+durable write sequence (tmp file, fsync, rename,
    directory fsync, tmp cleanup on failure) — one copy serving both the
    materialized and the streaming writers. ``write_fn(f)`` produces the
    payload into the open tmp file."""
    tmp = path.with_suffix(path.suffix + ".tmp")
    try:
        with open(tmp, "wb") as f:
            write_fn(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        dir_fd = os.open(str(path.parent), os.O_RDONLY)
        try:
            os.fsync(dir_fd)
        finally:
            os.close(dir_fd)
    except OSError as e:
        raise VdbIoError(e) from None
    finally:
        if tmp.exists():
            try:
                tmp.unlink()
            except OSError:
                pass


def _durable_write(path: Path, payload: bytes) -> None:
    native = native_lib.get_native()
    if native is not None:
        rc = native.vdb_durable_write(str(path).encode(),
                                      native_lib.as_u8p(payload), len(payload))
        if rc != 0:
            raise VdbIoError(f"durable write failed for {path}")
        return
    _durable_write_with(path, lambda f: f.write(payload))


class SnapshotManager:
    def __init__(self, directory: "str | Path"):
        self.directory = Path(directory)
        self.snapshot_path = self.directory / SNAPSHOT_FILE
        self.manifest_path = self.directory / MANIFEST_FILE

    def save(self, snapshot: DatabaseSnapshot) -> None:
        """Write snapshot.bin + manifest.json (reference snapshot.rs:30-46)."""
        payload = encode_snapshot(snapshot)
        _durable_write(self.snapshot_path, payload)
        self._write_manifest(len(snapshot.vectors), snapshot.next_id,
                             snapshot.dimension)

    def save_stream(self, vectors, metadata, next_id: int, dimension,
                    count: int) -> None:
        """Streaming ``save``: same bytes on disk, bounded (~64 MB) memory
        — the checkpoint path for multi-GB stores (a 10M x 768 store's
        snapshot is ~30 GB; ``save`` would hold it in RAM twice). Write is
        atomic + durable via the shared ``_durable_write_with`` sequence.
        ``vectors``/``metadata`` follow write_snapshot_stream's contract
        (metadata may be populated by the vector iterator itself)."""
        _durable_write_with(
            self.snapshot_path,
            lambda f: write_snapshot_stream(f, vectors, metadata, next_id,
                                            dimension, count))
        self._write_manifest(count, next_id, dimension)

    def _write_manifest(self, count: int, next_id: int, dimension) -> None:
        manifest = {
            "vector_count": count,
            "next_id": next_id,
            "dimension": dimension,
        }
        _durable_write(self.manifest_path,
                       json.dumps(manifest, indent=2).encode())

    def open_stream(self) -> Optional[SnapshotStreamReader]:
        """Streaming ``load``: header + row iterator over an mmap, or None
        when no snapshot exists. The caller must ``close()`` the reader
        (or use it as a context manager)."""
        if not self.snapshot_path.exists():
            return None
        try:
            return SnapshotStreamReader(self.snapshot_path)
        except OSError as e:
            raise VdbIoError(e) from None

    def load(self) -> Optional[DatabaseSnapshot]:
        """Decode snapshot.bin, or None when absent (snapshot.rs:49-58)."""
        if not self.snapshot_path.exists():
            return None
        try:
            return decode_snapshot(self.snapshot_path.read_bytes())
        except SerializationError:
            raise
        except OSError as e:
            raise VdbIoError(e) from None

    def exists(self) -> bool:
        return self.snapshot_path.exists()

    def manifest(self) -> Optional[dict]:
        if not self.manifest_path.exists():
            return None
        return json.loads(self.manifest_path.read_text())


__all__ = ["SnapshotManager", "SNAPSHOT_FILE", "MANIFEST_FILE"]
