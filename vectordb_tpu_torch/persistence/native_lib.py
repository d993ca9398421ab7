"""Loader for the native persistence core.

Port of ``vectordb_tpu/persistence/native_lib.py``. The C++ sources are
the JAX package's, read by path from ``vectordb_tpu/persistence/native/``
(``walcore.cpp``, ``hnswcore.cpp``, ``httpcore.cpp``: ``_configure`` binds
symbols of all three) and never copied or written there: the first call
of ``get_native`` compiles them with ``g++`` into
``vectordb_tpu_torch/_build/``, keyed by a hash of the sources, by the
package's one build helper (``utils/cext.py``). Nothing builds at import.

Every caller in this package keeps a pure-Python backend that writes the
same bytes. It runs only when the caller asks for it: ``get_native``
returns None while ``VDB_TPU_NO_NATIVE`` is set (the JAX package's
switch, so one setting flips both packages). A failed build raises with
the compiler's log; it never falls back to the Python backend.
"""

from __future__ import annotations

import ctypes
import os
import threading
from pathlib import Path
from typing import Optional

from ..utils.cext import build

# the C++ sources, shared with the JAX package by path (the port builds
# them into its own cache directory)
NATIVE_SRC = (Path(__file__).resolve().parent.parent.parent
              / "vectordb_tpu" / "persistence" / "native")
SOURCES = ("walcore.cpp", "hnswcore.cpp", "httpcore.cpp")
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXXFLAGS = ("-O2", "-fPIC", "-std=c++17", "-pthread", "-shared")
_build_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _configure(lib: ctypes.CDLL) -> ctypes.CDLL:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.vdb_crc32.argtypes = [u8p, ctypes.c_uint64]
    lib.vdb_crc32.restype = ctypes.c_uint32
    lib.vdb_wal_open.argtypes = [ctypes.c_char_p]
    lib.vdb_wal_open.restype = ctypes.c_void_p
    lib.vdb_wal_append.argtypes = [ctypes.c_void_p, u8p, ctypes.c_uint32]
    lib.vdb_wal_append.restype = ctypes.c_int
    lib.vdb_wal_sync.argtypes = [ctypes.c_void_p]
    lib.vdb_wal_sync.restype = ctypes.c_int
    lib.vdb_wal_append_raw.argtypes = [ctypes.c_void_p, u8p, ctypes.c_uint64]
    lib.vdb_wal_append_raw.restype = ctypes.c_int
    lib.vdb_wal_truncate.argtypes = [ctypes.c_void_p]
    lib.vdb_wal_truncate.restype = ctypes.c_int
    lib.vdb_wal_close.argtypes = [ctypes.c_void_p]
    lib.vdb_wal_close.restype = None
    lib.vdb_wal_scan.argtypes = [ctypes.c_char_p,
                                 ctypes.POINTER(ctypes.c_int64)]
    lib.vdb_wal_scan.restype = ctypes.c_int64
    lib.vdb_durable_write.argtypes = [ctypes.c_char_p, u8p, ctypes.c_uint64]
    lib.vdb_durable_write.restype = ctypes.c_int
    lib.vdb_mmf_create.argtypes = [ctypes.c_char_p, ctypes.c_uint32]
    lib.vdb_mmf_create.restype = ctypes.c_void_p
    lib.vdb_mmf_open.argtypes = [ctypes.c_char_p]
    lib.vdb_mmf_open.restype = ctypes.c_void_p
    lib.vdb_mmf_dim.argtypes = [ctypes.c_void_p]
    lib.vdb_mmf_dim.restype = ctypes.c_uint32
    lib.vdb_mmf_count.argtypes = [ctypes.c_void_p]
    lib.vdb_mmf_count.restype = ctypes.c_uint32
    lib.vdb_mmf_append.argtypes = [ctypes.c_void_p, f32p]
    lib.vdb_mmf_append.restype = ctypes.c_int64
    lib.vdb_mmf_get.argtypes = [ctypes.c_void_p, ctypes.c_uint32, f32p]
    lib.vdb_mmf_get.restype = ctypes.c_int
    lib.vdb_mmf_read_range.argtypes = [ctypes.c_void_p, ctypes.c_uint32,
                                       ctypes.c_uint32, f32p]
    lib.vdb_mmf_read_range.restype = ctypes.c_int
    lib.vdb_mmf_close.argtypes = [ctypes.c_void_p]
    lib.vdb_mmf_close.restype = None
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.vdb_hnsw_create.argtypes = [ctypes.c_uint32] * 6 + [
        ctypes.c_uint64, ctypes.c_double]
    lib.vdb_hnsw_create.restype = ctypes.c_void_p
    lib.vdb_hnsw_free.argtypes = [ctypes.c_void_p]
    lib.vdb_hnsw_free.restype = None
    lib.vdb_hnsw_insert.argtypes = [ctypes.c_void_p, ctypes.c_int64, f32p]
    lib.vdb_hnsw_insert.restype = ctypes.c_int64
    lib.vdb_hnsw_insert_batch.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), f32p,
        ctypes.c_int64, ctypes.c_int32, ctypes.POINTER(ctypes.c_int32)]
    lib.vdb_hnsw_insert_batch.restype = None
    lib.vdb_hnsw_remove_slot.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.vdb_hnsw_remove_slot.restype = None
    lib.vdb_hnsw_search.argtypes = [ctypes.c_void_p, f32p, ctypes.c_uint32,
                                    ctypes.c_uint32, i64p, f32p]
    lib.vdb_hnsw_search.restype = ctypes.c_int64
    lib.vdb_hnsw_search_masked.argtypes = [
        ctypes.c_void_p, f32p, ctypes.c_uint32, ctypes.c_uint32, u8p,
        ctypes.c_int64, i64p, f32p]
    lib.vdb_hnsw_search_masked.restype = ctypes.c_int64
    lib.vdb_hnsw_len.argtypes = [ctypes.c_void_p]
    lib.vdb_hnsw_len.restype = ctypes.c_int64
    lib.vdb_hnsw_capacity.argtypes = [ctypes.c_void_p]
    lib.vdb_hnsw_capacity.restype = ctypes.c_int64
    lib.vdb_hnsw_entry.argtypes = [ctypes.c_void_p]
    lib.vdb_hnsw_entry.restype = ctypes.c_int32
    lib.vdb_hnsw_max_level.argtypes = [ctypes.c_void_p]
    lib.vdb_hnsw_max_level.restype = ctypes.c_int32
    lib.vdb_hnsw_version.argtypes = [ctypes.c_void_p]
    lib.vdb_hnsw_version.restype = ctypes.c_uint64
    lib.vdb_hnsw_get_slot.argtypes = [ctypes.c_void_p, ctypes.c_int32, f32p]
    lib.vdb_hnsw_get_slot.restype = ctypes.c_int
    lib.vdb_hnsw_export.argtypes = [ctypes.c_void_p, f32p, f32p, i32p, i32p,
                                    i64p, ctypes.POINTER(ctypes.c_uint8)]
    lib.vdb_hnsw_export.restype = ctypes.c_int
    lib.vdb_hnsw_import.argtypes = [ctypes.c_void_p, f32p, i32p, i32p, i64p,
                                    ctypes.POINTER(ctypes.c_uint8),
                                    ctypes.c_int64, ctypes.c_int32,
                                    ctypes.c_int32]
    lib.vdb_hnsw_import.restype = ctypes.c_int
    lib.vdb_http_start.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.vdb_http_start.restype = ctypes.c_void_p
    lib.vdb_http_port.argtypes = [ctypes.c_void_p]
    lib.vdb_http_port.restype = ctypes.c_int
    lib.vdb_http_stop.argtypes = [ctypes.c_void_p]
    lib.vdb_http_stop.restype = None
    lib.vdb_http_next_jobs.argtypes = [ctypes.c_void_p, u8p, ctypes.c_int64,
                                       ctypes.c_int]
    lib.vdb_http_next_jobs.restype = ctypes.c_int64
    lib.vdb_http_respond.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                     ctypes.c_int, u8p, ctypes.c_int64]
    lib.vdb_http_respond.restype = ctypes.c_int
    i32p = ctypes.POINTER(ctypes.c_int32)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.vdb_http_respond_search.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int, u8p, u32p, f64p,
        ctypes.c_int32]
    lib.vdb_http_respond_search.restype = ctypes.c_int
    lib.vdb_http_respond_search_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int, u8p, u32p, f64p,
        i32p, ctypes.c_int32]
    lib.vdb_http_respond_search_batch.restype = ctypes.c_int
    return lib


def _build() -> Path:
    """Compile the sources (once per source hash) into BUILD_DIR and
    return the library's path; raises RuntimeError with the compiler's
    log on a failed build."""
    return build("native persistence", [NATIVE_SRC / n for n in SOURCES],
                 os.environ.get("CXX", "g++"), CXXFLAGS, "libvdbwal",
                 BUILD_DIR)


def get_native() -> Optional[ctypes.CDLL]:
    """The configured native library, building it at first use; None
    while ``VDB_TPU_NO_NATIVE`` asks for the Python backend."""
    global _lib
    if os.environ.get("VDB_TPU_NO_NATIVE"):
        return None
    if _lib is not None:
        return _lib
    with _build_lock:
        if _lib is None:
            _lib = _configure(ctypes.CDLL(str(_build())))
    return _lib


def as_u8p(data: bytes):
    return ctypes.cast(ctypes.c_char_p(data), ctypes.POINTER(ctypes.c_uint8))


__all__ = ["get_native", "as_u8p"]
