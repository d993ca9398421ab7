"""Memory-mapped fixed-dimension vector file.

Port of ``vectordb_tpu/persistence/mmap_storage.py``, unchanged in
behaviour.

Capability parity with reference src/persistence/mmap.rs:18-173: header
``[dim: u32 LE][count: u32 LE]`` followed by packed LE f32 rows; ``append``
writes the row then rewrites the header and fsyncs (mmap.rs:66-95); ``get``
is a positional read (mmap.rs:98-120); ``get_mmap`` reads through an mmap
with graceful fallback to the positional path (mmap.rs:124-149). Like the
reference, this is a standalone large-dataset facility not wired into the
StorageEngine — here its bulk path (``read_range``) doubles as the
device-shard hydration fast path: one mmap'd memcpy straight into a numpy
buffer that a host-to-device copy ships to the card.

Backed by the native C++ core; the pure-Python backend (asked for with
``VDB_TPU_NO_NATIVE=1``) writes the identical bytes.
"""

from __future__ import annotations

import ctypes
import mmap as _mmap
import os
import struct
from pathlib import Path
from typing import Optional

import numpy as np

from ..errors import DimensionMismatchError, StorageError, VdbIoError
from ..vector import Vector, as_f32_array
from . import native_lib

_HEADER = 8


class MmapVectorStorage:
    def __init__(self, path: "str | Path", handle, native, dim: int,
                 count: int, pyfile=None):
        self.path = Path(path)
        self._handle = handle
        self._native = native
        self._dim = dim
        self._count = count
        self._pyfile = pyfile

    # -- constructors (reference mmap.rs:24-63) ------------------------------

    @classmethod
    def create(cls, path: "str | Path", dimension: int) -> "MmapVectorStorage":
        native = native_lib.get_native()
        if native is not None:
            handle = native.vdb_mmf_create(str(path).encode(), int(dimension))
            if not handle:
                raise VdbIoError(f"cannot create vector file at {path}")
            return cls(path, handle, native, int(dimension), 0)
        f = open(path, "w+b")
        f.write(struct.pack("<II", int(dimension), 0))
        f.flush()
        os.fsync(f.fileno())
        return cls(path, None, None, int(dimension), 0, pyfile=f)

    @classmethod
    def open(cls, path: "str | Path") -> "MmapVectorStorage":
        native = native_lib.get_native()
        if native is not None:
            handle = native.vdb_mmf_open(str(path).encode())
            if not handle:
                raise VdbIoError(f"cannot open vector file at {path}")
            return cls(path, handle, native,
                       int(native.vdb_mmf_dim(handle)),
                       int(native.vdb_mmf_count(handle)))
        f = open(path, "r+b")
        dim, count = struct.unpack("<II", f.read(_HEADER))
        return cls(path, None, None, dim, count, pyfile=f)

    # -- properties ----------------------------------------------------------

    @property
    def dimension(self) -> int:
        return self._dim

    @property
    def count(self) -> int:
        return self._count

    def __len__(self) -> int:
        return self._count

    # -- append (reference mmap.rs:66-95) ------------------------------------

    def append(self, vector: "Vector | np.ndarray") -> int:
        arr = as_f32_array(vector)
        if arr.shape[0] != self._dim:
            raise DimensionMismatchError(self._dim, arr.shape[0])
        if self._handle is not None:
            buf = np.ascontiguousarray(arr, dtype="<f4")
            rc = self._native.vdb_mmf_append(
                self._handle,
                buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
            if rc < 0:
                raise VdbIoError(f"append failed for {self.path}")
            self._count = int(rc)
            return self._count
        f = self._pyfile
        f.seek(_HEADER + self._count * self._dim * 4)
        f.write(np.ascontiguousarray(arr, dtype="<f4").tobytes())
        f.seek(4)
        f.write(struct.pack("<I", self._count + 1))
        f.flush()
        os.fsync(f.fileno())
        self._count += 1
        return self._count

    # -- reads ---------------------------------------------------------------

    def get(self, index: int) -> Vector:
        """Positional read of one row (reference mmap.rs:98-120)."""
        if index >= self._count:
            raise StorageError(
                f"index {index} out of range (count={self._count})")
        if self._handle is not None:
            out = np.empty(self._dim, dtype=np.float32)
            rc = self._native.vdb_mmf_get(
                self._handle, int(index),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
            if rc != 0:
                raise VdbIoError(f"read failed for {self.path}[{index}]")
            return Vector(out)
        f = self._pyfile
        f.seek(_HEADER + index * self._dim * 4)
        raw = f.read(self._dim * 4)
        return Vector(np.frombuffer(raw, dtype="<f4"))

    def get_mmap(self, index: int) -> Vector:
        """Read through an mmap, falling back to ``get`` on failure
        (reference mmap.rs:124-149)."""
        try:
            return Vector(self.read_range(index, 1)[0])
        except (OSError, ValueError):
            return self.get(index)

    def read_range(self, start: int, count: int) -> np.ndarray:
        """Bulk mmap read of rows [start, start+count) as f32[count, dim] —
        the device-hydration fast path."""
        if start + count > self._count:
            raise StorageError(
                f"range [{start}, {start + count}) out of bounds "
                f"(count={self._count})")
        if self._handle is not None:
            out = np.empty((count, self._dim), dtype=np.float32)
            rc = self._native.vdb_mmf_read_range(
                self._handle, int(start), int(count),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
            if rc != 0:
                raise VdbIoError(f"mmap read failed for {self.path}")
            return out
        with open(self.path, "rb") as f:
            with _mmap.mmap(f.fileno(), 0, access=_mmap.ACCESS_READ) as m:
                offset = _HEADER + start * self._dim * 4
                nbytes = count * self._dim * 4
                return np.frombuffer(
                    m[offset:offset + nbytes], dtype="<f4"
                ).reshape(count, self._dim).copy()

    def close(self) -> None:
        if self._handle is not None:
            self._native.vdb_mmf_close(self._handle)
            self._handle = None
        if self._pyfile is not None:
            self._pyfile.close()
            self._pyfile = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


__all__ = ["MmapVectorStorage"]
