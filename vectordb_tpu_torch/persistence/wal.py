"""Write-ahead log with per-append fsync and CRC-framed entries.

Port of ``vectordb_tpu/persistence/wal.py``, with one repair:
``trim_to_replayed`` cuts a torn or corrupt tail off the log after
recovery has replayed its valid prefix. The JAX package appends after the
garbage, so a write acknowledged after such a recovery is unreadable to
the next replay (ROADMAP queue 3).

Capability parity with reference src/persistence/wal.rs:28-121:
  * frame = [len: u32 LE][crc32: u32 LE][payload], append-only
  * fsync after every append (the durability floor, wal.rs:54-56)
  * replay returns all valid entries, stopping silently at the first
    truncated / CRC-mismatched / undecodable frame (wal.rs:66-110)
  * truncate() clears the log after a checkpoint (wal.rs:113-120)

The framing + fsync fast path is the native C++ core (walcore.cpp via
ctypes); a pure-Python implementation with the identical on-disk bytes
runs when asked for (VDB_TPU_NO_NATIVE=1), and the two interoperate on
the same files.
"""

from __future__ import annotations

import ctypes
import os
import struct
import zlib
from pathlib import Path
from typing import List

from ..errors import SerializationError, VdbIoError
from . import native_lib
from .serialization import WalEntry, decode_wal_entry, encode_wal_entry


class WriteAheadLog:
    def __init__(self, path: "str | Path"):
        self.path = Path(path)
        self._native = native_lib.get_native()
        self._handle = None
        self._file = None
        # bytes of the valid prefix the last complete replay walked (None
        # until one completes)
        self.replay_end: "int | None" = None
        try:
            if self._native is not None:
                self._handle = self._native.vdb_wal_open(
                    str(self.path).encode())
                if not self._handle:
                    raise OSError(f"cannot open WAL at {self.path}")
            else:
                self._file = open(self.path, "ab")
        except OSError as e:
            raise VdbIoError(e) from None

    @classmethod
    def open(cls, path: "str | Path") -> "WriteAheadLog":
        return cls(path)

    # -- append -------------------------------------------------------------

    def append(self, entry: WalEntry) -> None:
        """Frame, write and fsync one entry (reference wal.rs:45-56)."""
        payload = encode_wal_entry(entry)
        if self._handle is not None:
            rc = self._native.vdb_wal_append(
                self._handle, native_lib.as_u8p(payload), len(payload))
            if rc != 0:
                raise VdbIoError(f"WAL append failed for {self.path}")
            return
        crc = zlib.crc32(payload) & 0xFFFFFFFF
        frame = struct.pack("<II", len(payload), crc) + payload
        try:
            self._file.write(frame)
            self._file.flush()
            os.fsync(self._file.fileno())
        except OSError as e:
            raise VdbIoError(e) from None

    def append_batch(self, entries: "List[WalEntry]") -> None:
        """Group commit: frame and write all entries, then ONE fsync.

        Bulk loads pay the durability latency floor once per batch instead
        of once per row (the reference has no batch path and fsyncs per
        append even under insert_batch; engine.rs:107-116). Atomicity is
        per-entry: a crash mid-batch replays the prefix that hit the disk.
        """
        if not entries:
            return
        frames = bytearray()
        for entry in entries:
            payload = encode_wal_entry(entry)
            crc = zlib.crc32(payload) & 0xFFFFFFFF
            frames += struct.pack("<II", len(payload), crc)
            frames += payload
        data = bytes(frames)
        if self._handle is not None:
            # native append writes [len][crc][payload] itself; feed it one
            # pre-framed blob via the raw file path to keep a single fsync
            rc = self._native.vdb_wal_append_raw(
                self._handle, native_lib.as_u8p(data), len(data))
            if rc != 0:
                raise VdbIoError(f"WAL batch append failed for {self.path}")
            return
        try:
            self._file.write(data)
            self._file.flush()
            os.fsync(self._file.fileno())
        except OSError as e:
            raise VdbIoError(e) from None

    def sync(self) -> None:
        if self._handle is not None:
            if self._native.vdb_wal_sync(self._handle) != 0:
                raise VdbIoError(f"fsync failed for {self.path}")
        elif self._file is not None:
            self._file.flush()
            os.fsync(self._file.fileno())

    # -- replay -------------------------------------------------------------

    def replay(self) -> List[WalEntry]:
        """All valid entries; stops at the first corruption (wal.rs:66-110)."""
        return list(self.iter_replay())

    def iter_replay(self):
        """Streaming ``replay``: yields valid entries off an mmap of the
        log, one frame at a time, stopping at the first corruption. Peak
        memory is one frame — ``replay`` on a 30 GB WAL (10M x 768 rows)
        would otherwise hold the raw bytes AND a 10M-entry list."""
        self.replay_end = None
        if not self.path.exists():
            self.replay_end = 0
            return
        valid_end = None
        check_crc = True
        if self._native is not None:
            # native pass validates framing + CRC and bounds the valid
            # prefix, so the python walk can skip per-frame CRC work
            n_frames = ctypes.c_int64(0)
            valid_end = self._native.vdb_wal_scan(
                str(self.path).encode(), ctypes.byref(n_frames))
            if valid_end < 0:
                return
            check_crc = False
        import mmap as _mmap
        with open(self.path, "rb") as f:
            try:
                mm = _mmap.mmap(f.fileno(), 0, access=_mmap.ACCESS_READ)
            except ValueError:      # empty file
                self.replay_end = 0
                return
            try:
                raw = memoryview(mm)
                if valid_end is not None:
                    raw = raw[:valid_end]
                reached = [0]
                yield from self._iter_frames(raw, check_crc, reached)
                self.replay_end = reached[0]
            finally:
                del raw
                mm.close()

    @staticmethod
    def _iter_frames(raw, check_crc: bool, reached=None):
        """Decoded entries of ``raw``'s valid frames; ``reached[0]``
        follows the end of the last one yielded."""
        off = 0
        n = len(raw)
        while off + 8 <= n:
            length, crc = struct.unpack_from("<II", raw, off)
            start = off + 8
            end = start + length
            if end > n:
                break  # truncated
            payload = raw[start:end]
            if check_crc and (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
                break  # corrupted
            try:
                entry = decode_wal_entry(payload)
            except SerializationError:
                break  # undecodable — stop, like the reference
            if reached is not None:
                reached[0] = end
            yield entry
            off = end

    def trim_to_replayed(self) -> None:
        """After a complete replay, cut the log back to the valid prefix it
        walked (a torn or corrupt tail goes, then an fsync), so that later
        appends follow the last valid frame."""
        if self.replay_end is None:
            return
        try:
            if self.path.stat().st_size <= self.replay_end:
                return
            fd = os.open(self.path, os.O_WRONLY)
            try:
                os.ftruncate(fd, self.replay_end)
                os.fsync(fd)
            finally:
                os.close(fd)
        except OSError as e:
            raise VdbIoError(e) from None

    # -- truncate / close ----------------------------------------------------

    def truncate(self) -> None:
        """Clear the log after a successful checkpoint (wal.rs:113-120)."""
        if self._handle is not None:
            if self._native.vdb_wal_truncate(self._handle) != 0:
                raise VdbIoError(f"WAL truncate failed for {self.path}")
            return
        self._file.close()
        self._file = open(self.path, "wb")
        self._file.flush()
        os.fsync(self._file.fileno())
        self._file.close()
        self._file = open(self.path, "ab")

    def close(self) -> None:
        if self._handle is not None:
            self._native.vdb_wal_close(self._handle)
            self._handle = None
        if self._file is not None:
            self._file.close()
            self._file = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


__all__ = ["WriteAheadLog", "WalEntry"]
