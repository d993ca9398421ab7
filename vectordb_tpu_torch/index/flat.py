"""Exact brute-force k-NN over a packed device matrix.

Port of ``vectordb_tpu/index/flat.py`` on one device, with its three
storage modes. Capability parity with reference src/flat_index.rs:12-74
(add/remove/search/get_vector/len/iter):

  * rows live in a packed ``[capacity, d]`` host matrix mirrored to the
    device, with a ``bool[capacity]`` validity mask and precomputed row
    norms; capacity grows by powers of two;
  * ``storage="f32"``: the device state carries bf16 hi/lo mirrors and
    the residual bound ``elo_max``; past ``_MIRROR_MEM_LIMIT`` it keeps
    the f32 rows alone (``coarse_f32``) and the coarse kernels round
    them on chip;
  * ``storage="bf16"``: rows are rounded to bf16 at insert (get_vector
    returns the stored values); host and device hold 2 bytes per element
    and the device buffer is its own hi mirror (``elo_max = 0``);
  * ``storage="int8"``: rows are quantized at insert to int8 codes times
    a per-row power-of-two scale; the host keeps the f32 stored values,
    the device 1-byte codes plus a scale per row (``elo_max = 0``);
  * search runs the certified coarse ladder
    (ops/topk.flat_search_batched_submit) on every device: the plain
    kernel versions on a CPU tensor, the CUDA kernels on a CUDA one;
  * insert/delete patch the device state by scatter; a write that races
    an in-flight search scatters into a copy (the search's fallback tier
    reads its snapshot later, on the host's schedule);
  * ``search_masked`` applies a precompiled metadata mask *before* top-k,
    making filtered search exact;
  * ``host_backing``: the packed host rows live in a disk-backed
    ``np.memmap`` in that directory instead of RAM;
  * the storage engine's recovery hooks: ``reserve``,
    ``bulk_append_matrix`` (``quantized=True`` takes snapshot rows as
    stored values, with no second rounding), the bulk loaders
    (``bulk_load_matrix``, ``bulk_load_stream``, ``bulk_attach_memmap``)
    and ``prehydrate``, which builds the device state on a side thread
    while the WAL tail replays. The first search waits on the CUDA event
    the build recorded, so its launches never read a half-copied state.

Not in this slice: mesh sharding and its progressive hydration (ROADMAP
queue 1 item 13).
"""

from __future__ import annotations

import math
import os
import threading
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..distance import (DistanceMetric, prepare_device,
                        validate_cosine_operands)
from ..errors import DimensionMismatchError, InvalidVectorError
from ..ops import coarse_kernel
from ..ops.topk import flat_search_batched_submit, next_pow2
from ..ops.update import (scatter_rows, scatter_rows_copy, scatter_values,
                          scatter_values_copy)
from ..utils.profiling import annotate
from ..vector import Vector, as_f32_array
from .base import Index

_MIN_CAPACITY = 1024
# If more than this fraction of slots is dirty, re-upload wholesale instead
# of scattering.
_FULL_SYNC_FRACTION = 8
# Device footprint gate for the f32 rows + bf16 hi/lo mirrors (8 bytes per
# element), picked for an 80 GB H100: 64 GB leaves room for the query-side
# temporaries (the K1 tile minima alone are 1.07 GB at N=2^20, Q=4096).
# A store past it keeps the f32 rows alone and runs the f32-source kernels
# K4/K5 (coarse_f32). Read at each full device build, so a caller may
# lower it.
_MIRROR_MEM_LIMIT = 64 * 10 ** 9
_STORAGES = ("f32", "bf16", "int8")
_QUANT_CHUNK = 1 << 20   # rows per chunk: bounds f32 temps to ~3 GB @ 768-d


def _bf16_bits(arr: np.ndarray) -> np.ndarray:
    """f32 -> bf16 bit patterns (np.uint16), rounded to nearest even by
    torch's cast, as the JAX package's ml_dtypes cast rounds."""
    arr = np.ascontiguousarray(arr, dtype=np.float32)
    if not arr.flags.writeable:      # torch.from_numpy wants a writable one
        arr = arr.copy()
    t = torch.from_numpy(arr).to(torch.bfloat16)
    return t.view(torch.int16).numpy().view(np.uint16)


def _bf16_widen(bits: np.ndarray) -> np.ndarray:
    """bf16 bit patterns -> the f32 values they hold (exact)."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _quantize_bf16(arr: np.ndarray) -> np.ndarray:
    """Round-trip f32 -> bf16 -> f32 (the stored value set for
    storage="bf16"), without ml_dtypes."""
    return _bf16_widen(_bf16_bits(arr))


def _int8_row_scales(mat: np.ndarray) -> np.ndarray:
    """Per-row POWER-OF-TWO int8 scale: s = 2^ceil(log2(max|row|/127)).

    A pow2 scale makes the scheme exact in f32 arithmetic: code * s is
    exact, so quantization is idempotent, and the scale is recoverable
    from a stored row (max|code| lands in (63.5, 127], so max|stored|/127
    is in (s/2, s] and ceils back to exactly s) — no side table."""
    mx = np.abs(mat).max(axis=1)
    mx = np.where(mx > 0.0, mx, np.float32(127.0))  # zero rows -> s = 1
    return np.exp2(np.ceil(np.log2(mx / np.float32(127.0)))
                   ).astype(np.float32)


def _quantize_int8(arr: np.ndarray) -> np.ndarray:
    """Round-trip a row/matrix through per-row pow2-scaled int8 (the
    stored value set for storage="int8"), chunked over rows so the f32
    temporaries stay bounded."""
    squeeze = arr.ndim == 1
    mat = np.atleast_2d(np.asarray(arr, dtype=np.float32))
    out = np.empty_like(mat)
    for lo in range(0, mat.shape[0], _QUANT_CHUNK):
        blk = mat[lo:lo + _QUANT_CHUNK]
        s = _int8_row_scales(blk)
        out[lo:lo + _QUANT_CHUNK] = np.round(blk / s[:, None]) * s[:, None]
    return out[0] if squeeze else out


def _int8_codes_scales(rows: np.ndarray):
    """(int8 codes, f32 pow2 scales) recovered exactly from stored rows."""
    n = rows.shape[0]
    codes = np.empty(rows.shape, np.int8)
    scales = np.empty(n, np.float32)
    for lo in range(0, n, _QUANT_CHUNK):
        blk = rows[lo:lo + _QUANT_CHUNK]
        s = _int8_row_scales(blk)
        codes[lo:lo + _QUANT_CHUNK] = np.round(blk / s[:, None])
        scales[lo:lo + _QUANT_CHUNK] = s
    return codes, scales


class SearchBatchHandle:
    """An in-flight index-level batched search (search_batch_submit).

    ``collect()`` blocks on the device result, maps slots to internal ids,
    and releases the index's in-flight mark — exactly once, even if called
    repeatedly or if the device work failed. An abandoned handle releases
    the mark from ``__del__`` so writes don't stay pinned to the
    copy-scatter path forever."""

    __slots__ = ("_fn", "_on_done", "_result", "_has_result")

    def __init__(self, fn, on_done=None):
        self._fn = fn
        self._on_done = on_done
        self._has_result = False
        self._result = None

    @classmethod
    def ready(cls, result) -> "SearchBatchHandle":
        handle = cls(None)
        handle._result = result
        handle._has_result = True
        return handle

    def collect(self):
        if not self._has_result:
            try:
                self._result = self._fn()
                self._has_result = True
            finally:
                self._release()
        return self._result

    def _release(self):
        done, self._on_done = self._on_done, None
        if done is not None:
            done()

    def __del__(self):
        try:
            self._release()
        except Exception:
            pass


def _slots_to_ids(dists, idx, id_of_slot, k_req: int, nq: int
                  ) -> List[List[Tuple[int, float]]]:
    """Map (Q, k) slot results to per-query [(internal_id, dist)] rows,
    trimming the +inf masked/invalid tail."""
    out: List[List[Tuple[int, float]]] = []
    for qi in range(nq):
        row: List[Tuple[int, float]] = []
        for j in range(dists.shape[1]):
            dist = float(dists[qi, j])
            if math.isinf(dist):
                break  # masked/invalid tail
            if len(row) == k_req:
                break
            row.append((int(id_of_slot[int(idx[qi, j])]), dist))
        out.append(row)
    return out


class FlatIndex(Index):
    """Exact k-NN via the certified device flat scan."""

    def __init__(self, metric: DistanceMetric, search_mode: str = "exact",
                 mesh=None, row_axis: str = "shard", storage: str = "f32",
                 host_backing: Optional[str] = None, device="cuda"):
        if search_mode not in ("exact", "fast"):
            raise ValueError(f"unknown search_mode: {search_mode!r}")
        if mesh is not None:
            # row_axis names the mesh axis the rows shard over; it has
            # nothing to shard until the mesh is ported
            raise ValueError("FlatIndex(mesh=...) is not ported yet "
                             "(ROADMAP queue 1 item 13, multi-device)")
        if storage not in _STORAGES:
            raise ValueError(f"unknown storage: {storage!r}")
        # "exact": the certified ladder (tiers 1-3). "fast": the 1-pass
        # coarse scan + exact refine (exact distances, approximate ids).
        self.search_mode = search_mode
        # "bf16"/"int8": rows quantized AT INSERT, search certified-exact
        # over the stored values (module docstring). bf16 host rows live
        # as bf16 bit patterns (np.uint16: half the host RAM, and the
        # device upload is the stored bytes); int8 keeps f32 host rows and
        # derives codes and scales per sync, as the JAX package does.
        self.storage = storage
        self._host_dtype = np.dtype(np.uint16 if storage == "bf16"
                                    else np.float32)
        self._device_t = prepare_device(device)
        # host_backing: a directory; the packed row matrix lives in a
        # disk-backed np.memmap there instead of RAM (the OS page cache
        # keeps the hot set); device-side limits are unchanged
        self._host_backing = host_backing
        self._vectors_path: Optional[str] = None
        self._backing_uid: Optional[str] = None
        self._metric = metric
        self._dim: Optional[int] = None
        self._capacity = 0
        self._len = 0
        # host-side packed storage (source of truth)
        self._vectors: Optional[np.ndarray] = None   # host_dtype[cap, d]
        self._valid: Optional[np.ndarray] = None     # bool[capacity]
        self._sq_norms: Optional[np.ndarray] = None  # f32[capacity]
        self._norms: Optional[np.ndarray] = None     # f32[capacity]
        self._id_of_slot: Optional[np.ndarray] = None  # int64[capacity], -1 free
        self._slot_of_id: dict[int, int] = {}
        self._free_slots: list[int] = []
        self._zero_norm_live = 0  # live rows with zero norm (cosine validation)
        # subclasses that never run the coarse kernels (PQ) set this False:
        # the f32 device state then carries no bf16 mirrors, no residual
        # bound, and the exact fallback is the plain f32 scan
        self._want_mirrors = True
        # device state + dirty tracking
        self._device: Optional[dict] = None
        self._dirty_slots: set[int] = set()
        # True while an UNLOCKED device build is reading the host arrays
        # (prehydrate): mutations in that window are tracked although no
        # device state is installed yet, so the first locked sync
        # re-scatters them. When False and no device state exists,
        # mutations skip dirty bookkeeping (the next sync builds in full).
        self._build_inflight = False
        # the CUDA event a side-thread build recorded after its last
        # launch; the first sync after installing it waits on it
        self._device_ready = None
        self._lock = threading.RLock()
        # readers that copied the device dict and released the lock; while
        # any are in flight, syncs scatter into copies (see _sync_device)
        self._searches_in_flight = 0

    # -- basic properties ---------------------------------------------------

    @property
    def metric(self) -> DistanceMetric:
        return self._metric

    @property
    def dimension(self) -> Optional[int]:
        return self._dim

    @property
    def capacity(self) -> int:
        return self._capacity

    def __len__(self) -> int:
        return self._len

    def slot_of(self, internal_id: int) -> Optional[int]:
        return self._slot_of_id.get(internal_id)

    def _quantize(self, arr: np.ndarray) -> np.ndarray:
        """The storage mode's insert-time quantization (identity for
        f32): the f32 values the index will store."""
        if self.storage == "bf16":
            return _quantize_bf16(arr)
        if self.storage == "int8":
            return _quantize_int8(arr)
        return arr

    def _host_rows(self, vals: np.ndarray) -> np.ndarray:
        """Stored f32 values -> the host container's rows."""
        return _bf16_bits(vals) if self.storage == "bf16" else vals

    def _stored(self, rows: np.ndarray) -> np.ndarray:
        """Host container rows -> the f32 values they hold."""
        return _bf16_widen(rows) if self.storage == "bf16" else rows

    # -- storage management -------------------------------------------------

    def _ensure_storage(self, dim: int, want_rows: int) -> None:
        """Allocate or grow packed storage to hold ``want_rows`` live rows."""
        if self._dim is None:
            self._dim = dim
        needed = max(want_rows, _MIN_CAPACITY)
        if self._capacity >= needed:
            return
        new_cap = next_pow2(needed, floor=_MIN_CAPACITY)
        old_path = self._vectors_path
        new_vectors = self._alloc_rows(new_cap, self._dim)
        new_valid = np.zeros(new_cap, dtype=bool)
        new_sq = np.zeros(new_cap, dtype=np.float32)
        new_norms = np.zeros(new_cap, dtype=np.float32)
        new_ids = np.full(new_cap, -1, dtype=np.int64)
        if self._capacity:
            # chunked: bounds dirty page-cache pressure under host_backing
            for lo in range(0, self._capacity, _QUANT_CHUNK):
                hi = min(lo + _QUANT_CHUNK, self._capacity)
                new_vectors[lo:hi] = self._vectors[lo:hi]
            new_valid[: self._capacity] = self._valid
            new_sq[: self._capacity] = self._sq_norms
            new_norms[: self._capacity] = self._norms
            new_ids[: self._capacity] = self._id_of_slot
        self._free_slots.extend(range(new_cap - 1, self._capacity - 1, -1))
        self._vectors, self._valid = new_vectors, new_valid
        self._sq_norms, self._norms, self._id_of_slot = new_sq, new_norms, new_ids
        self._capacity = new_cap
        self._device = None  # full re-upload on next search
        self._dirty_slots.clear()
        if old_path is not None and old_path != self._vectors_path:
            try:
                os.remove(old_path)
            except OSError:
                pass

    def _alloc_rows(self, rows: int, dim: int) -> np.ndarray:
        """Packed row matrix: RAM by default; a zero-initialized
        disk-backed memmap under ``host_backing``. The file name carries a
        per-instance token, so two indexes sharing a backing directory
        never truncate each other's row file; files of crashed processes
        are not reaped (the directory may be shared)."""
        if self._host_backing is None:
            return np.zeros((rows, dim), dtype=self._host_dtype)
        if self._backing_uid is None:
            import uuid
            self._backing_uid = f"{os.getpid()}_{uuid.uuid4().hex[:8]}"
        os.makedirs(self._host_backing, exist_ok=True)
        ext = "f32" if self._host_dtype == np.float32 else "bf16"
        path = os.path.join(self._host_backing,
                            f"rows_{self._backing_uid}_{rows}x{dim}.{ext}")
        mm = np.memmap(path, dtype=self._host_dtype, mode="w+",
                       shape=(rows, dim))
        self._vectors_path = path
        return mm

    def _take_slot(self) -> int:
        if not self._free_slots:
            self._ensure_storage(self._dim, self._capacity * 2 if self._capacity else 1)
        return self._free_slots.pop()

    # -- mutation -----------------------------------------------------------

    def add(self, internal_id: int, vector: Vector) -> None:
        with self._lock:
            arr = as_f32_array(vector)
            dim = arr.shape[0]
            if self._dim is not None and dim != self._dim:
                raise DimensionMismatchError(self._dim, dim)
            self._ensure_storage(dim, self._len + 1)
            old_slot = self._slot_of_id.get(internal_id)
            if old_slot is not None:
                self._clear_slot(old_slot)
            slot = self._take_slot()
            self._write_slot(slot, internal_id, arr)

    def add_batch(self, items: Sequence[Tuple[int, "Vector | np.ndarray"]]) -> None:
        """Amortized bulk add: one host pass, one device sync on next search."""
        with self._lock:
            if not items:
                return
            first = as_f32_array(items[0][1])
            dim = first.shape[0]
            if self._dim is not None and dim != self._dim:
                raise DimensionMismatchError(self._dim, dim)
            self._ensure_storage(dim, self._len + len(items))
            ids = np.fromiter((int(i) for i, _ in items), dtype=np.int64,
                              count=len(items))
            if np.unique(ids).size == len(items) and not any(
                    int(i) in self._slot_of_id for i in ids):
                # vectorized append of fresh distinct ids
                self._bulk_append_fresh(ids, items, dim)
                return
            for internal_id, vector in items:
                arr = as_f32_array(vector)
                if arr.shape[0] != self._dim:
                    raise DimensionMismatchError(self._dim, arr.shape[0])
                old_slot = self._slot_of_id.get(internal_id)
                if old_slot is not None:
                    self._clear_slot(old_slot)
                slot = self._take_slot()
                self._write_slot(slot, internal_id, arr)

    def _bulk_append_fresh(self, ids: np.ndarray, items, dim: int) -> None:
        """Vectorized append of fresh distinct ids (lock held, storage
        pre-sized). On a dimension mismatch the accepted PREFIX is applied
        before the error surfaces (reference storage.rs:293-298)."""
        n = len(items)
        mat = np.empty((n, dim), dtype=np.float32)
        error = None
        for j, (_, vector) in enumerate(items):
            row = as_f32_array(vector)
            if row.shape[0] != dim:
                error = DimensionMismatchError(dim, row.shape[0])
                n = j
                mat = mat[:n]
                ids = ids[:n]
                break
            mat[j] = row
        if n:
            self._append_matrix_locked(ids, mat)
        if error is not None:
            raise error

    def _append_matrix_locked(self, ids: np.ndarray, mat: np.ndarray,
                              quantized: bool = False) -> None:
        """Append a validated (n, d) f32 matrix of fresh distinct ids
        (lock held, storage pre-sized). ``quantized``: the rows already
        hold this index's stored values (snapshot replay), so the
        idempotent re-quantize is skipped."""
        n = len(ids)
        slots = np.fromiter((self._take_slot() for _ in range(n)),
                            dtype=np.int64, count=n)
        try:
            if not quantized:
                mat = self._quantize(mat)   # norms below see stored values
            self._vectors[slots] = self._host_rows(mat)
            sq = np.einsum("ij,ij->i", mat, mat).astype(np.float32)
            self._sq_norms[slots] = sq
            self._norms[slots] = np.sqrt(sq)
            self._valid[slots] = True
            self._id_of_slot[slots] = ids
            self._slot_of_id.update(zip(ids.tolist(), slots.tolist()))
            self._len += n
            self._zero_norm_live += int((sq == 0.0).sum())
        finally:
            # even on a partial failure, every possibly-touched slot is
            # recorded (stale-dirty is safe; missed-dirty is not)
            if self._device is not None or self._build_inflight:
                self._dirty_slots.update(slots.tolist())
            self._note_appended(slots)

    def _note_appended(self, slots: np.ndarray) -> None:
        """Subclass seam: called (lock held) with the slot array the
        append path just touched — PQ stamps per-slot mutation ticks and
        marks codes dirty here. Kept apart from ``_dirty_slots`` (device
        state bookkeeping, skipped while no device state exists)."""

    def adopt_packed(self, vectors: np.ndarray, valid: np.ndarray,
                     id_of_slot: np.ndarray) -> None:
        """Take over a packed slot layout as it stands (an empty index
        only): row ``s`` of ``vectors`` lands in slot ``s``, so the same
        slots give the same candidate tiles as the exporting index
        (convert.store_from_reference). The capacity must be a power of
        two >= 1024, as the index itself allocates it. ``vectors`` are f32
        rows, or bf16 rows (the JAX package's ml_dtypes bfloat16, or their
        np.uint16 bit patterns), read by their bits; they pass through
        this index's quantization (the identity on stored values)."""
        with self._lock:
            if self._len or self._slot_of_id:
                raise ValueError("adopt_packed requires an empty index")
            vectors = np.asarray(vectors)
            if vectors.dtype.itemsize == 2 and vectors.dtype.kind != "f":
                vectors = _bf16_widen(vectors.view(np.uint16))
            vectors = np.ascontiguousarray(vectors, dtype=np.float32)
            valid = np.ascontiguousarray(valid, dtype=bool)
            id_of_slot = np.ascontiguousarray(id_of_slot, dtype=np.int64)
            cap, dim = vectors.shape
            if cap < _MIN_CAPACITY or cap != next_pow2(cap):
                raise ValueError(f"capacity {cap} is not a power of two "
                                 f">= {_MIN_CAPACITY}")
            if valid.shape != (cap,) or id_of_slot.shape != (cap,):
                raise ValueError("valid/id_of_slot must have shape "
                                 f"({cap},)")
            if self._dim is not None and dim != self._dim:
                raise DimensionMismatchError(self._dim, dim)
            live = np.nonzero(valid)[0]
            ids = id_of_slot[live]
            if (ids < 0).any() or np.unique(ids).size != live.size:
                raise ValueError("live slots need distinct ids >= 0")
            self._dim = dim
            self._capacity = cap
            vals = self._quantize(vectors.copy())
            vals[~valid] = 0.0
            self._vectors = self._host_rows(vals)
            self._valid = valid.copy()
            self._sq_norms = np.einsum("ij,ij->i", vals,
                                       vals).astype(np.float32)
            self._norms = np.sqrt(self._sq_norms)
            self._id_of_slot = np.where(valid, id_of_slot, -1)
            self._slot_of_id = dict(zip(ids.tolist(), live.tolist()))
            # pops come off the end: lowest free slot first, as after a
            # fresh pow2 growth
            self._free_slots = np.nonzero(~valid)[0][::-1].tolist()
            self._len = int(live.size)
            self._zero_norm_live = int((self._sq_norms[live] == 0.0).sum())
            self._device = None
            self._dirty_slots.clear()

    def reserve(self, n_rows: int, dim: Optional[int] = None) -> None:
        """Pre-size packed storage for ``n_rows`` live rows: recovery calls
        it with the snapshot's row count before the chunked apply, which
        would otherwise grow by ~log2(n/chunk) pow2 doublings, each copying
        the whole packed array. No-op if the capacity already suffices or
        the dimension is still unknown."""
        with self._lock:
            d = dim if dim is not None else self._dim
            if d is None:
                return
            if self._dim is not None and d != self._dim:
                raise DimensionMismatchError(self._dim, d)
            if n_rows <= self._capacity:
                return
            self._ensure_storage(int(d), int(n_rows))

    def bulk_append_matrix(self, ids: np.ndarray, mat: np.ndarray,
                           quantized: bool = False) -> None:
        """Vectorized append of fresh distinct int64 ids from a validated
        (n, d) f32 matrix into a possibly non-empty index, with no per-row
        Python objects (the recovery path). ``quantized``: ONLY for rows
        that hold this index's stored values already (snapshot replay);
        raw rows must quantize."""
        with self._lock:
            mat = np.ascontiguousarray(mat, dtype=np.float32)
            ids = np.ascontiguousarray(ids, dtype=np.int64)
            if mat.ndim != 2:
                raise ValueError("mat must be a (n, d) matrix")
            n, dim = mat.shape
            if ids.shape[0] != n:
                raise ValueError("ids/matrix length mismatch")
            if n == 0:
                return
            if np.unique(ids).size != n:
                raise ValueError("duplicate ids in bulk_append_matrix")
            if self._dim is not None and dim != self._dim:
                raise DimensionMismatchError(self._dim, dim)
            if self._slot_of_id and any(
                    map(self._slot_of_id.__contains__, ids.tolist())):
                raise ValueError("bulk_append_matrix ids must be fresh (use "
                                 "add_batch for upserts)")
            self._ensure_storage(dim, self._len + n)
            self._append_matrix_locked(ids, mat, quantized=quantized)

    def bulk_load_matrix(self, ids: np.ndarray, mat: np.ndarray) -> None:
        """Fresh load of a validated (n, d) f32 matrix with distinct int64
        ids into slots 0..n-1. Requires an empty index."""
        with self._lock:
            if self._len or self._slot_of_id:
                raise ValueError("bulk_load_matrix requires an empty index")
            mat = np.ascontiguousarray(mat, dtype=np.float32)
            ids = np.ascontiguousarray(ids, dtype=np.int64)
            n, dim = mat.shape
            if ids.shape[0] != n:
                raise ValueError("ids/matrix length mismatch")
            if np.unique(ids).size != n:
                raise ValueError("duplicate ids in bulk_load_matrix")
            if self._dim is not None and dim != self._dim:
                raise DimensionMismatchError(self._dim, dim)
            self._load_prefix(ids, dim, (mat,))

    def bulk_load_stream(self, n: int, dim: int, chunks) -> None:
        """Fresh load from an ITERATOR of (c, d) f32 row chunks totaling
        exactly ``n`` rows, with ids 0..n-1, written straight into the
        packed storage (a disk memmap under ``host_backing``), so no second
        n x d matrix exists. Requires an empty index."""
        with self._lock:
            if self._len or self._slot_of_id:
                raise ValueError("bulk_load_stream requires an empty index")
            if n < 1:
                raise ValueError("n must be >= 1")
            if self._dim is not None and dim != self._dim:
                raise DimensionMismatchError(self._dim, dim)
            self._load_prefix(np.arange(n, dtype=np.int64), dim, chunks)

    def _load_prefix(self, ids: np.ndarray, dim: int, chunks) -> None:
        """Fill slots 0..len(ids)-1 of an empty index from (c, d) f32
        chunks, quantized chunk-wise straight into the packed storage (lock
        held). Norms come from the f32 stored values of each chunk."""
        n = len(ids)
        self._ensure_storage(dim, n)
        pos = 0
        for blk in chunks:
            blk = np.ascontiguousarray(blk, dtype=np.float32)
            if blk.ndim != 2 or blk.shape[1] != dim:
                raise DimensionMismatchError(
                    dim, blk.shape[-1] if blk.ndim else 0)
            if pos + len(blk) > n:
                raise ValueError("chunks exceed declared row count")
            for lo in range(0, len(blk), _QUANT_CHUNK):
                sub = self._quantize(blk[lo:lo + _QUANT_CHUNK])
                a, b = pos + lo, pos + lo + len(sub)
                self._vectors[a:b] = self._host_rows(sub)
                sq = np.einsum("ij,ij->i", sub, sub).astype(np.float32)
                self._sq_norms[a:b] = sq
                self._norms[a:b] = np.sqrt(sq)
            pos += len(blk)
        if pos != n:
            raise ValueError(f"chunks yielded {pos} rows, declared {n}")
        self._valid[:n] = True
        self._id_of_slot[:n] = ids
        self._slot_of_id = dict(zip(ids.tolist(), range(n)))
        self._free_slots = [s for s in self._free_slots if s >= n]
        self._len = n
        self._zero_norm_live = int((self._sq_norms[:n] == 0.0).sum())
        self._device = None
        self._dirty_slots.clear()

    def bulk_attach_memmap(self, path: str, n: int, dim: int,
                           sq_norms: Optional[np.ndarray] = None) -> None:
        """Adopt an EXISTING packed f32 row file as this index's storage
        (the beyond-RAM reopen path): rows get ids 0..n-1, as after
        ``bulk_load_stream``. Requires an empty f32 index constructed with
        ``host_backing``, and a file of exactly the capacity
        ``bulk_load_stream(n)`` allocates (``next_pow2(n)`` rows of ``dim``
        f32s). ``sq_norms`` (shape ``(n,)``) skips the streaming pass that
        otherwise recomputes the per-row norms."""
        with self._lock:
            if self._len or self._slot_of_id:
                raise ValueError("bulk_attach_memmap requires an empty "
                                 "index")
            if self._host_backing is None:
                raise ValueError("bulk_attach_memmap requires host_backing")
            if self.storage != "f32":
                raise ValueError("bulk_attach_memmap supports f32 storage "
                                 "only")
            if n < 1:
                raise ValueError("n must be >= 1")
            if self._dim is not None and dim != self._dim:
                raise DimensionMismatchError(self._dim, dim)
            cap = next_pow2(max(n, _MIN_CAPACITY), floor=_MIN_CAPACITY)
            want = cap * dim * 4
            have = os.path.getsize(path)
            if have != want:
                raise ValueError(
                    f"row file holds {have} bytes; capacity {cap} x {dim} "
                    f"f32 rows needs {want}")
            mm = np.memmap(path, dtype=np.float32, mode="r+",
                           shape=(cap, dim))
            if sq_norms is not None:
                sq = np.ascontiguousarray(sq_norms, np.float32)
                if sq.shape != (n,):
                    raise ValueError(f"sq_norms must have shape ({n},)")
            else:
                sq = np.empty(n, np.float32)
                for lo in range(0, n, _QUANT_CHUNK):
                    blk = mm[lo:min(lo + _QUANT_CHUNK, n)]
                    sq[lo:lo + len(blk)] = np.einsum(
                        "ij,ij->i", blk, blk).astype(np.float32)
            self._dim = dim
            self._capacity = cap
            self._vectors = mm
            self._vectors_path = path
            self._sq_norms = np.zeros(cap, np.float32)
            self._sq_norms[:n] = sq
            self._norms = np.zeros(cap, np.float32)
            self._norms[:n] = np.sqrt(sq)
            self._valid = np.zeros(cap, dtype=bool)
            self._valid[:n] = True
            self._id_of_slot = np.full(cap, -1, np.int64)
            self._id_of_slot[:n] = np.arange(n, dtype=np.int64)
            self._slot_of_id = {j: j for j in range(n)}
            self._free_slots = list(range(cap - 1, n - 1, -1))
            self._len = n
            self._zero_norm_live = int((sq == 0.0).sum())
            self._device = None
            self._dirty_slots.clear()

    def _write_slot(self, slot: int, internal_id: int, arr: np.ndarray) -> None:
        arr = self._quantize(arr)   # norms below see the stored values
        self._vectors[slot] = self._host_rows(arr)
        sq = float(np.dot(arr, arr))
        self._sq_norms[slot] = sq
        self._norms[slot] = math.sqrt(sq)
        self._valid[slot] = True
        self._id_of_slot[slot] = internal_id
        self._slot_of_id[internal_id] = slot
        self._len += 1
        if sq == 0.0:
            self._zero_norm_live += 1
        if self._device is not None or self._build_inflight:
            self._dirty_slots.add(slot)

    def _clear_slot(self, slot: int) -> None:
        internal_id = int(self._id_of_slot[slot])
        if self._sq_norms[slot] == 0.0 and self._valid[slot]:
            self._zero_norm_live -= 1
        self._valid[slot] = False
        self._id_of_slot[slot] = -1
        self._slot_of_id.pop(internal_id, None)
        self._free_slots.append(slot)
        self._len -= 1
        if self._device is not None or self._build_inflight:
            self._dirty_slots.add(slot)

    def remove(self, internal_id: int) -> None:
        with self._lock:
            slot = self._slot_of_id.get(internal_id)
            if slot is None:
                return  # unknown IDs are a no-op, like the reference HashMap remove
            self._clear_slot(slot)

    # -- lookup -------------------------------------------------------------

    def get_vector(self, internal_id: int) -> Optional[Vector]:
        with self._lock:
            slot = self._slot_of_id.get(internal_id)
            if slot is None:
                return None
            return Vector(self._stored(self._vectors[slot]))

    def iter_items(self) -> Iterator[Tuple[int, Vector]]:
        with self._lock:
            slots = np.nonzero(self._valid)[0] if self._valid is not None else []
            pairs = [(int(self._id_of_slot[s]),
                      Vector(self._stored(self._vectors[s]))) for s in slots]
        return iter(pairs)

    # -- device state -------------------------------------------------------

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        # always a copy: on the CPU a from_numpy view would alias the host
        # arrays that later writes mutate under in-flight searches
        return torch.from_numpy(np.require(arr, requirements=["C", "W"])).to(
            self._device_t, copy=True)

    def _build_device_full(self) -> dict:
        """A complete device state from the host arrays: rows, norms,
        validity, and what the certified ladder reads for this storage
        (see the module docstring)."""
        dev = {"sq_norms": self._to_device(self._sq_norms),
               "norms": self._to_device(self._norms),
               "valid": self._to_device(self._valid)}
        if self.storage == "int8":
            # host-side requantization (exact: values were pow2-quantized
            # at insert): 1-byte codes plus a 4-byte scale per row; the
            # codes cast to bf16 exactly, so no database-side residual
            codes, scales = _int8_codes_scales(self._vectors)
            dev.update(db=self._to_device(codes),
                       scales=self._to_device(scales), int8_storage=True,
                       elo_max=self._zero())
        elif self.storage == "bf16":
            # the stored bytes go up as they are; the db IS its own hi
            # mirror, certified-exact over the stored values
            db16 = self._bf16_to_device(self._vectors)
            dev.update(db=db16, hi=db16, bf16_storage=True,
                       elo_max=self._zero())
        elif not self._want_mirrors:
            dev["db"] = self._to_device(self._vectors)
        elif self._capacity * self._dim * 8 > _MIRROR_MEM_LIMIT:
            # past the mirror gate: the f32 rows alone; the coarse kernels
            # round them on chip (K4, K5)
            db = self._to_device(self._vectors)
            dev.update(db=db, coarse_f32=True,
                       elo_max=coarse_kernel.residual_max_norm_f32(db))
        else:
            db = self._to_device(self._vectors)
            hi, lo = coarse_kernel.split_hi_lo(db)
            dev.update(db=db, hi=hi, lo=lo,
                       elo_max=coarse_kernel.residual_max_norm(db, hi))
        return dev

    def _zero(self) -> torch.Tensor:
        return torch.zeros((), dtype=torch.float32, device=self._device_t)

    def _bf16_to_device(self, bits: np.ndarray) -> torch.Tensor:
        return self._to_device(bits.view(np.int16)).view(torch.bfloat16)

    def prehydrate(self) -> None:
        """Build the device state OUTSIDE the index lock and install it if
        no sync got there first: the recovery overlap, where the WAL tail
        replays into the host arrays on one thread while the host-to-device
        copies run on another. Rows written during the unlocked build may
        be read torn, but each such slot is in ``_dirty_slots`` (never
        cleared here) and the next locked sync re-scatters it. If storage
        grew mid-build (the host arrays were reallocated), the state is
        discarded and the first search builds in full.

        The build's copies and kernels run on this thread's current stream,
        which a searching thread need not share: the build records a CUDA
        event after its last launch, and the first sync after the install
        waits on it (``_sync_device``)."""
        with self._lock:
            if self._device is not None or self._len == 0:
                return
            vec0 = self._vectors
            self._build_inflight = True
        ready = None
        try:
            dev = self._build_device_full()
            if self._device_t.type == "cuda":
                ready = torch.cuda.Event()
                ready.record(torch.cuda.current_stream(self._device_t))
        except Exception:
            with self._lock:
                self._build_inflight = False
            return  # the first search surfaces the real error
        with self._lock:
            self._build_inflight = False
            if self._device is None and self._vectors is vec0:
                self._device = dev
                self._device_ready = ready

    def _sync_device(self) -> dict:
        """Bring the device state up to date. Called with the lock held."""
        if self._device_ready is not None:
            # a side-thread build installed this state: its copies and
            # kernels finish before any launch of this caller reads it
            self._device_ready.synchronize()
            self._device_ready = None
        if self._device is None:
            self._device = self._build_device_full()
            self._dirty_slots.clear()
            return self._device
        if self._dirty_slots:
            if len(self._dirty_slots) * _FULL_SYNC_FRACTION > self._capacity:
                self._device = None
                return self._sync_device()
            idx_np = np.fromiter(self._dirty_slots, dtype=np.int64)
            idx = self._to_device(idx_np)
            dev = self._device
            if self._searches_in_flight > 0:
                # a reader still holds the old buffers — copy, don't patch
                s_rows, s_vals = scatter_rows_copy, scatter_values_copy
                s_hl = coarse_kernel.scatter_hi_lo_copy
            else:
                s_rows, s_vals = scatter_rows, scatter_values
                s_hl = coarse_kernel.scatter_hi_lo
            for key, host in (("sq_norms", self._sq_norms),
                              ("norms", self._norms),
                              ("valid", self._valid)):
                dev[key] = s_vals(dev[key], idx,
                                  self._to_device(host[idx_np]))
            if self.storage == "int8":
                # patched rows as codes + scales (1-byte transfer)
                codes, scales = _int8_codes_scales(self._vectors[idx_np])
                dev["db"] = s_rows(dev["db"], idx, self._to_device(codes))
                dev["scales"] = s_vals(dev["scales"], idx,
                                       self._to_device(scales))
            elif self.storage == "bf16":
                # db and hi alias one buffer: both keys track the new one
                rows16 = self._bf16_to_device(self._vectors[idx_np])
                dev["db"] = dev["hi"] = s_rows(dev["db"], idx, rows16)
            else:
                # one host-to-device transfer of the patched rows, shared
                # by the row scatter, the mirror scatter and the bound
                rows = self._to_device(self._vectors[idx_np])
                dev["db"] = s_rows(dev["db"], idx, rows)
                if "hi" in dev:
                    dev["hi"], dev["lo"] = s_hl(dev["hi"], dev["lo"], idx,
                                                rows)
                # patched rows can only RAISE the recorded residual bound
                # (stale-high is safe: the 1-pass margin just widens)
                if "elo_max" in dev:
                    dev["elo_max"] = torch.maximum(
                        dev["elo_max"],
                        coarse_kernel.residual_max_norm_f32(rows))
            self._dirty_slots.clear()
        return self._device

    # -- search -------------------------------------------------------------

    def search(self, query: Vector, k: int) -> List[Tuple[int, float]]:
        results = self.search_batch(as_f32_array(query).reshape(1, -1), k)
        return results[0]

    def search_batch(self, queries: np.ndarray, k: int,
                     slot_mask: Optional[np.ndarray] = None,
                     mask_layout_version: Optional[int] = None
                     ) -> List[List[Tuple[int, float]]]:
        """Q queries in one device submission; optional pre-top-k slot
        mask (``mask_layout_version``: see search_batch_submit)."""
        # non-polymorphic: PqFlatIndex serves its submit through its own
        # search_batch, so dispatching here would recurse
        return FlatIndex.search_batch_submit(
            self, queries, k, slot_mask=slot_mask,
            mask_layout_version=mask_layout_version).collect()

    def search_batch_submit(self, queries: np.ndarray, k: int,
                            slot_mask: Optional[np.ndarray] = None,
                            mask_layout_version: Optional[int] = None
                            ) -> "SearchBatchHandle":
        """Asynchronous ``search_batch``: snapshots device state under the
        index lock, launches the device work, and returns a handle whose
        ``collect()`` waits for it and maps slots to internal ids.
        Mutations racing an in-flight handle take the copy-scatter path
        (``_searches_in_flight``), so collected results always reflect the
        snapshot point. A mask compiled for another slot layout raises
        StaleSlotMaskError (this index never repacks, so its layout
        version stays 0)."""
        queries = np.asarray(queries, dtype=np.float32)
        if queries.ndim != 2:
            raise InvalidVectorError("queries must be a (Q, d) array")
        with self._lock:
            if (slot_mask is not None and mask_layout_version is not None
                    and mask_layout_version != self.slot_layout_version):
                from ..errors import StaleSlotMaskError
                raise StaleSlotMaskError(mask_layout_version,
                                         self.slot_layout_version)
            if self._len == 0 or k <= 0:
                return SearchBatchHandle.ready(
                    [[] for _ in range(queries.shape[0])])
            if queries.shape[1] != self._dim:
                raise DimensionMismatchError(self._dim, queries.shape[1])
            if self._metric is DistanceMetric.COSINE:
                qn = np.sqrt(np.sum(queries * queries, axis=1))
                validate_cosine_operands(self._metric, float(qn.min()),
                                         self._zero_norm_live)
            dev = dict(self._sync_device())
            id_of_slot = self._id_of_slot.copy()
            live = self._len
            self._searches_in_flight += 1
        try:
            if slot_mask is not None:
                mask = np.asarray(slot_mask, dtype=bool)
                cap = int(dev["valid"].shape[0])
                if mask.shape[0] != cap:
                    padded = np.zeros(cap, dtype=bool)
                    padded[: min(mask.shape[0], cap)] = mask[:cap]
                    mask = padded
                dev["valid"] = dev["valid"] & self._to_device(mask)
            k_req = min(int(k), live)
            with annotate("vdb/flat.submit"):
                handle = flat_search_batched_submit(
                    queries, dev, self._metric, k_req,
                    mode=self.search_mode)
        except BaseException:
            self._search_done()
            raise
        nq = queries.shape[0]

        def _collect():
            with annotate("vdb/flat.collect"):
                dists, idx = handle.collect()
                return _slots_to_ids(dists, idx, id_of_slot, k_req, nq)

        return SearchBatchHandle(_collect, on_done=self._search_done)

    def _search_done(self) -> None:
        with self._lock:
            self._searches_in_flight -= 1

    def search_masked(self, query: Vector, k: int, slot_mask: np.ndarray,
                      mask_layout_version: Optional[int] = None
                      ) -> Optional[List[Tuple[int, float]]]:
        results = self.search_batch(as_f32_array(query).reshape(1, -1), k,
                                    slot_mask=slot_mask,
                                    mask_layout_version=mask_layout_version)
        return results[0]

    # -- introspection ------------------------------------------------------

    def packed_arrays(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(vectors[capacity,d] f32 stored values, valid[capacity],
        id_of_slot[capacity]) host copies."""
        with self._lock:
            if self._vectors is None:
                return (np.zeros((0, 0), np.float32), np.zeros(0, bool),
                        np.zeros(0, np.int64))
            return (np.array(self._stored(self._vectors), np.float32),
                    self._valid.copy(), self._id_of_slot.copy())

    def __repr__(self) -> str:
        return (f"FlatIndex(metric={self._metric.value}, len={self._len}, "
                f"dim={self._dim}, capacity={self._capacity}, "
                f"storage={self.storage}, device={self._device_t})")
