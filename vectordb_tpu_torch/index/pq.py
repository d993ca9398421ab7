"""PQ-Flat: a product-quantized flat index with an exact re-rank.

Port of ``vectordb_tpu/index/pq.py`` (``_PqCodesCore`` and
``PqFlatIndex``) on one device. The device holds uint8 codes (``m`` bytes
per row: 96 at 768-d, against 3 KB of f32), the codebook and validity; the
streaming scan (ops/pq.pq_scan_topr, kernel K8 for the decode) returns
each query's top-R candidate slots, and an exact f32 re-rank over the true
stored rows returns exact distances. Recall is governed only by candidate
coverage (``refine``). An OPQ pre-rotation (``rotate=True``) is learned at
train time and applied inside encode and scan.

Re-rank venues (``_rerank_venue``):
  * "mirror": the f32 rows live on the device (the flat device state,
    without bf16 mirrors: ``_want_mirrors = False``); gather, distances
    and top-k run there (ops/pq.pq_rerank_topk). "auto" picks it when the
    index lives on a CUDA device and the rows fit _RERANK_DEV_ROW_BYTES;
  * "host": numpy over the host rows (the CPU, ``host_backing``, and rows
    past the budget);
  * "gathered": ``host_backing`` or rows past the budget, with
    rerank="device": the host gathers the candidate rows and the device
    ranks them.

Mutations follow the flat index's slot semantics: PQ never repacks slots,
so store-compiled filter masks stay valid across training. Post-train
writes re-encode at the next search sync (a scatter into the device codes,
in place, or into a copy while a search is in flight). Candidates whose
slot mutated after a search's snapshot are dropped by per-slot mutation
stamps. Filtered searches run the masked scan, or the exact host paths for
selective filters.

``host_backing`` keeps the f32 rows in a disk-backed memmap (the flat
index's option): the device holds only the codes. The bulk loaders
(``bulk_load_matrix``, ``bulk_load_stream``, ``bulk_attach_memmap``) stamp
every slot and, on a trained index, re-encode in full at the next sync.

``mesh=`` (a parallel.Mesh) shards the codes and validity over the mesh's
row axis, shard ``s`` owning slots ``[s*B, (s+1)*B)``; the codebook
tables are copied to each device. Each shard streams its block through
the same scan (``parallel/distributed.make_sharded_pq_scan``, K8 for each
chunk, the chunk sized on the shard's rows) and one exact top-r over the
S*r pool merges them; a mutation re-puts the shards' codes wholesale.
The re-rank runs on the host ("auto" resolves to "host"; "device"
raises), and the exact-scan fallback is the sharded flat path.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..distance import DistanceMetric, validate_cosine_operands
from ..errors import IndexOpError
from ..ops.update import scatter_rows, scatter_rows_copy
from ..utils.profiling import annotate
from .base import HitColumns, SearchBatchHandle
from .flat import FlatIndex

_TRAIN_SAMPLE_MAX = 1 << 18
_SCAN_CHUNK = 16384         # rows per streamed scan chunk (pow2; picked on
                            # a TPU, a re-pick on Hopper changes no result:
                            # per-chunk and pooled selection are exact)
_MAX_REFINE = 1024          # r beyond this falls back to the exact scan
_CAND_BYTES = 1 << 32       # (Q, nc*r) stacked-candidate budget -> Q
                            # sub-batching at huge N
_ENC_CHUNK_MIN = 256        # floor chunk for small encode batches
_ENC_SLAB = 1 << 20         # rows per host->device encode transfer
_SCORE_BYTES = 1 << 28      # budget for (m, chunk, ksub) score tensors
_ONEHOT_BYTES = 1 << 30     # the JAX package's (chunk, m, ksub) one-hot
                            # budget, kept as the scan-chunk formula's term
_SCATTER_MAX = 1 << 15      # beyond this many dirty codes, re-put wholesale
_RERANK_QBLOCK = 512
_RERANK_DEV_ROW_BYTES = 12 << 30   # device re-rank row budget (the JAX
                                   # package's, sized for a 16 GB TPU)
_MASKED_EXACT_MAX = 2048    # filters with at most max(r, this) eligible
                            # rows answer via the exact host scan
_MASKED_STREAM_CHUNK = 8192  # eligible rows per chunk in the streaming
                             # exact safety net
_HOST_DIST_BYTES = 1 << 29   # working-set bound for host distance blocks


def _pow2_floor(n: int) -> int:
    return 1 << (max(int(n), 1).bit_length() - 1)


class _PqCodesCore:
    """Shared PQ-codes machinery (mixin over FlatIndex): the uint8 code
    array and its device copy, the encode path, per-slot mutation stamps,
    the scan dispatch with query sub-batching and the exact re-rank.
    Concrete indexes provide ``train`` and ``_encode_slots``."""

    # -- shared state ---------------------------------------------------------

    def _pq_init(self, m: Optional[int], ksub: int, refine: int,
                 train_iters: int, auto_train_min: int, seed: int,
                 rotate: bool = False, rerank: str = "auto") -> None:
        self._want_mirrors = False
        if rerank not in ("auto", "device", "host"):
            raise ValueError(f"unknown rerank mode: {rerank!r}")
        self.rerank_mode = rerank
        if m is not None and m < 1:
            raise ValueError("m must be >= 1")
        if not 2 <= ksub <= 256:
            raise ValueError("ksub must be in [2, 256] (codes are uint8)")
        if refine < 1:
            raise ValueError("refine must be >= 1")
        self._m_arg = m
        self.ksub = int(ksub)
        # top-R candidate pool re-ranked exactly per query (the recall
        # knob; effective R = max(refine, k), rounded up to a pow2)
        self.refine = int(refine)
        self.train_iters = int(train_iters)
        self.auto_train_min = int(auto_train_min)
        self._seed = int(seed)
        self._rotate = bool(rotate)
        self._rot: Optional[np.ndarray] = None        # (d, d) f32
        self._rot_dev = None
        self._trained = False
        self._m = 0
        self._codebook: Optional[np.ndarray] = None   # (m, ksub, dsub) f32
        self._codebook_dev = None    # (m, ksub, dsub) f32 (bf16 values)
        self._cnorm_dev = None       # (m, ksub) codeword sq-norms
        self._codes: Optional[np.ndarray] = None      # uint8[capacity, m]
        self._codes_dev = None
        self._pq_valid_dev = None
        self._pq_valid_dirty = True
        # mesh: the codebook tables copied to each shard device
        self._pq_rep: Optional[dict] = None
        self._pq_dirty: set[int] = set()
        self._pq_full_reencode = False
        # per-slot mutation stamps: searches snapshot the tick at submit
        # and drop candidates whose slot mutated after it
        self._tick = 0
        self._slot_tick: Optional[np.ndarray] = None  # int64[capacity]

    # -- configuration --------------------------------------------------------

    @property
    def is_trained(self) -> bool:
        return self._trained

    def _resolve_m(self, d: int) -> int:
        if self._m_arg is not None:
            if d % self._m_arg:
                raise IndexOpError(
                    f"PQ m={self._m_arg} must divide dimension {d}")
            return self._m_arg
        for dsub in (8, 4, 2, 1):
            if d % dsub == 0:
                return d // dsub
        return d  # unreachable (dsub=1 always divides)

    @staticmethod
    def _fit_chunk(m: int, ksub: int, s: int) -> int:
        return min(_pow2_floor(s),
                   max(256, _pow2_floor(_SCORE_BYTES // (m * ksub * 4))))

    @staticmethod
    def _enc_chunk(m: int, ksub: int) -> int:
        return max(256, _pow2_floor(_SCORE_BYTES // (m * ksub * 4)))

    def _scan_chunk(self) -> int:
        cap = self._capacity
        if self._mesh is not None:
            # each shard streams its own block (pow2 / pow2 divides)
            cap //= len(self._shard_devices)
        chunk = min(_SCAN_CHUNK, _pow2_floor(cap),
                    max(256, _pow2_floor(_ONEHOT_BYTES
                                         // (self._m * self.ksub * 2))))
        return max(chunk, 1)

    def _fit_codebook(self, sample: np.ndarray, m: int,
                      rot: Optional[np.ndarray] = None) -> np.ndarray:
        """Batched subspace k-means over ``sample`` rows (wrap-padded to a
        chunk multiple) on the index's device, seeded from ``seed``."""
        from ..ops.pq import pq_fit
        chunk = self._fit_chunk(m, self.ksub, len(sample))
        pad = (-len(sample)) % chunk
        if pad:
            sample = np.concatenate([sample, sample[:pad]])
        gen = torch.Generator(device=self._device_t)
        gen.manual_seed(self._seed)
        cb = pq_fit(self._to_device(np.ascontiguousarray(sample, np.float32)),
                    gen, m=m, ksub=self.ksub, iters=self.train_iters,
                    chunk=chunk,
                    rot=None if rot is None else self._to_device(rot))
        return cb.cpu().numpy()

    # -- encoding -------------------------------------------------------------

    def _encode_rot(self):
        """Rotation ``pq_encode`` applies to encode inputs."""
        return self._rot_dev_arr()

    def _encode_rows(self, rows: np.ndarray) -> np.ndarray:
        """(n, d) f32 -> (n, m) uint8 through the one device encode
        program at every batch size (codes are then a function of the
        codebook, the row bytes and the device). Small batches pad to a
        fixed chunk, as in the JAX package."""
        from ..ops.pq import pq_encode
        n = len(rows)
        if n == 0:
            return np.empty((0, self._m), np.uint8)
        if self._codebook_dev is None:
            self._codebook_dev = self._to_device(self._codebook)
        chunk = self._enc_chunk(self._m, self.ksub)
        out = np.empty((n, self._m), np.uint8)
        for a in range(0, n, _ENC_SLAB):
            blk = np.ascontiguousarray(rows[a:a + _ENC_SLAB], np.float32)
            bn = len(blk)
            c = min(chunk, max(_ENC_CHUNK_MIN, _pow2_floor(bn)))
            pad = (-bn) % c
            if pad:
                blk = np.concatenate(
                    [blk, np.zeros((pad, blk.shape[1]), np.float32)])
            codes = pq_encode(self._to_device(blk), self._codebook_dev,
                              chunk=c, rot=self._encode_rot())
            out[a:a + bn] = codes[:bn].cpu().numpy()
        return out

    def _rot_dev_arr(self):
        if self._rot is None:
            return None
        if self._rot_dev is None:
            self._rot_dev = self._to_device(self._rot)
        return self._rot_dev

    def _encode_slots(self, slots: np.ndarray) -> np.ndarray:
        """Codes for the given slots (PqFlatIndex: the raw stored rows)."""
        return self._encode_rows(self._vectors[slots])

    def _install_codebook(self, codebook: np.ndarray,
                          rot: Optional[np.ndarray]) -> None:
        """Adopt a trained state (lock held): every live row re-encodes at
        the next search sync."""
        self._m = codebook.shape[0]
        self._codebook = codebook
        self._codebook_dev = None
        self._cnorm_dev = None
        self._rot = rot
        self._rot_dev = None
        self._codes = np.zeros((self._capacity, self._m), np.uint8)
        self._trained = True
        self._pq_dirty.clear()
        self._pq_full_reencode = True
        self._codes_dev = None
        self._pq_valid_dirty = True

    def _reencode_all(self) -> None:
        with annotate("vdb/pq.encode"):
            live = np.nonzero(self._valid)[0]
            for a in range(0, live.size, _ENC_SLAB):
                idx = live[a:a + _ENC_SLAB]
                self._codes[idx] = self._encode_slots(idx)

    # -- mutation hooks -------------------------------------------------------

    def _stamp(self, slot: int) -> None:
        self._tick += 1
        if self._slot_tick is not None:
            self._slot_tick[slot] = self._tick

    def _ensure_storage(self, dim: int, want_rows: int) -> None:
        old_cap = self._capacity
        super()._ensure_storage(dim, want_rows)
        if self._capacity != old_cap:
            nt = np.zeros(self._capacity, np.int64)
            if self._slot_tick is not None:
                nt[:old_cap] = self._slot_tick
            self._slot_tick = nt
            if self._trained:
                nc = np.zeros((self._capacity, self._m), np.uint8)
                nc[:old_cap] = self._codes
                self._codes = nc
                self._codes_dev = None
                self._pq_valid_dirty = True

    def _write_slot(self, slot: int, internal_id: int,
                    arr: np.ndarray) -> None:
        super()._write_slot(slot, internal_id, arr)
        self._stamp(slot)
        if self._trained:
            self._pq_dirty.add(slot)
            self._pq_valid_dirty = True

    def _clear_slot(self, slot: int) -> None:
        super()._clear_slot(slot)
        self._stamp(slot)
        if self._trained:
            self._pq_valid_dirty = True

    def _note_appended(self, slots: np.ndarray) -> None:
        # the seam the flat append path funnels through: stamp ticks / PQ
        # dirtiness for exactly the slots it touched
        if len(slots):
            self._tick += 1
            self._slot_tick[slots] = self._tick
            if self._trained:
                self._pq_dirty.update(slots.tolist())
                self._pq_valid_dirty = True

    def adopt_packed(self, vectors: np.ndarray, valid: np.ndarray,
                     id_of_slot: np.ndarray) -> None:
        """FlatIndex.adopt_packed plus the PQ bookkeeping of a bulk load:
        every slot stamped, a trained index re-encodes in full."""
        super().adopt_packed(vectors, valid, id_of_slot)
        with self._lock:
            self._slot_tick = np.zeros(self._capacity, np.int64)
            if self._trained:
                self._codes = np.zeros((self._capacity, self._m), np.uint8)
            self._after_bulk_load()

    def _after_bulk_load(self) -> None:
        self._tick += 1
        self._slot_tick[:self._capacity] = self._tick
        if self._trained:
            self._pq_dirty.clear()
            self._pq_full_reencode = True
            self._codes_dev = None
            self._pq_valid_dirty = True

    def bulk_load_matrix(self, ids: np.ndarray, mat: np.ndarray) -> None:
        super().bulk_load_matrix(ids, mat)
        with self._lock:
            self._after_bulk_load()

    def bulk_load_stream(self, n: int, dim: int, chunks) -> None:
        super().bulk_load_stream(n, dim, chunks)
        with self._lock:
            self._after_bulk_load()

    def bulk_attach_memmap(self, *args, **kwargs) -> None:
        super().bulk_attach_memmap(*args, **kwargs)
        with self._lock:
            # attach bypasses _ensure_storage: size the per-slot PQ arrays
            if (self._slot_tick is None
                    or len(self._slot_tick) != self._capacity):
                self._slot_tick = np.zeros(self._capacity, np.int64)
            if self._trained and len(self._codes) != self._capacity:
                self._codes = np.zeros((self._capacity, self._m), np.uint8)
            self._after_bulk_load()

    # -- device sync ----------------------------------------------------------

    def _pq_sync(self):
        """Bring the device codes, codebook tables and validity current
        (lock held). Returns (codes_dev, codebook_dev, cnorm_dev,
        valid_dev)."""
        # _cnorm_dev checked too: an encode (which installs _codebook_dev
        # alone via _encode_rows) may run before the first search sync
        if self._codebook_dev is None or self._cnorm_dev is None:
            self._codebook_dev = self._to_device(self._codebook)
            self._cnorm_dev = self._to_device(
                np.sum(self._codebook * self._codebook, axis=-1,
                       dtype=np.float32))
            self._pq_rep = None
        if self._pq_full_reencode:
            self._reencode_all()
            self._pq_full_reencode = False
            self._pq_dirty.clear()
            self._codes_dev = None
        if self._pq_dirty:
            slots = np.fromiter(self._pq_dirty, np.int64,
                                count=len(self._pq_dirty))
            self._pq_dirty.clear()
            with annotate("vdb/pq.encode"):
                self._codes[slots] = self._encode_slots(slots)
            if (self._mesh is None and self._codes_dev is not None
                    and len(slots) <= _SCATTER_MAX):
                # in place, or into a copy while a search still reads the
                # old buffer (ops/update.py)
                op = (scatter_rows if self._searches_in_flight == 0
                      else scatter_rows_copy)
                self._codes_dev = op(self._codes_dev, self._to_device(slots),
                                     self._to_device(self._codes[slots]))
            else:
                self._codes_dev = None
        if self._codes_dev is None:
            # a mesh re-puts every shard's codes wholesale (the JAX
            # package's policy for the sharded codes)
            self._codes_dev = self._pq_put(self._codes)
            self._pq_valid_dirty = True
        if self._pq_valid_dirty or self._pq_valid_dev is None:
            self._pq_valid_dev = self._pq_put(self._valid)
            self._pq_valid_dirty = False
        return (self._codes_dev, self._codebook_dev, self._cnorm_dev,
                self._pq_valid_dev)

    def _pq_put(self, arr: np.ndarray):
        """A per-slot host array on the device, or its shard blocks on
        the mesh's devices (a list of tensors)."""
        if self._mesh is None:
            return self._to_device(arr)
        return [self._to_device(arr[lo:hi], dev) for dev, (lo, hi) in zip(
            self._shard_devices,
            map(self._shard_range, range(len(self._shard_devices))))]

    def _pq_mask(self, valid, mask: np.ndarray):
        """``valid`` AND a host slot mask (per shard on a mesh)."""
        if self._mesh is None:
            return valid & self._to_device(mask)
        return [v & self._to_device(mask[lo:hi], v.device)
                for v, (lo, hi) in zip(valid, map(self._shard_range,
                                                  range(len(valid))))]

    # -- scan dispatch hooks --------------------------------------------------

    def _scan_state(self) -> dict:
        """Device tensors the scan needs (lock held)."""
        codes, cb, cnorm, valid = self._pq_sync()
        if self._mesh is not None:
            if self._pq_rep is None:
                from ..parallel.distributed import replicate
                devs = self._shard_devices
                cnorm_h = np.sum(self._codebook * self._codebook, axis=-1,
                                 dtype=np.float32)
                self._pq_rep = {
                    "codebook": {d: t.to(torch.bfloat16) for d, t in
                                 replicate(self._codebook, devs).items()},
                    "cnorm": replicate(cnorm_h, devs),
                    "rot": (None if self._rot is None
                            else replicate(self._rot, devs))}
            return {"codes": codes, "codebook": self._pq_rep["codebook"],
                    "cnorm": self._pq_rep["cnorm"], "valid": valid}
        # the codewords are bf16 values (pq_fit rounds them): exact cast
        return {"codes": codes, "codebook": cb.to(torch.bfloat16),
                "cnorm": cnorm, "valid": valid}

    def _scan_pool_cols(self, r: int) -> int:
        """Stacked-candidate columns per query (bounds the per-dispatch
        query count)."""
        return max(self._capacity // self._scan_chunk(), 1) * r

    def _scan_bytes_per_query(self, r: int) -> int:
        return self._scan_pool_cols(r) * 8

    def _scan_call(self, state: dict, qb: torch.Tensor, r: int):
        """One scan dispatch -> (scores (Qb, r), slots (Qb, r)) tensors.
        With a mesh: the per-shard scan and the exact merged top-r
        (parallel/distributed.make_sharded_pq_scan)."""
        if self._mesh is not None:
            rot = self._pq_rep["rot"]
            fn = self._sharded_pq_scanner(r, rot is not None)
            return fn(qb, state["codes"], state["codebook"], state["cnorm"],
                      state["valid"], *(() if rot is None else (rot,)))
        from ..ops.pq import pq_scan_topr
        return pq_scan_topr(qb, state["codes"], state["codebook"],
                            state["cnorm"],
                            state["valid"], self._metric, r=r,
                            chunk=self._scan_chunk(),
                            rot=self._rot_dev_arr())

    def _sharded_pq_scanner(self, r: int, with_rot: bool):
        key = ("pqscan", r, self._capacity, with_rot)
        fn = self._sharded_search_cache.get(key)
        if fn is None:
            from ..parallel.distributed import make_sharded_pq_scan
            fn = make_sharded_pq_scan(
                self._mesh, self._metric, r, self._scan_chunk(),
                self._capacity // len(self._shard_devices), self._row_axis,
                with_rot=with_rot)
            self._sharded_search_cache[key] = fn
        return fn

    def _scan_r_max(self) -> int:
        """Largest refine pool the scan program supports."""
        return min(self._scan_chunk(), _MAX_REFINE)

    def _rerank_venue(self) -> str:
        """Where the exact re-rank runs (lock held): a deterministic
        function of (config, capacity, device) — see the module
        docstring. The JAX package keys "auto" on the TPU backend; the port
        keys it on the index's device."""
        if self.rerank_mode == "host":
            return "host"
        if self._mesh is not None:
            # the merged pool is on the first device, the rows on the host
            if self.rerank_mode == "device":
                raise IndexOpError(
                    "rerank='device' is single-device only (the sharded "
                    "path re-ranks on the host after the shard merge)")
            return "host"
        if (self._host_backing is not None
                or self._capacity * (self._dim or 0) * 4
                > _RERANK_DEV_ROW_BYTES):
            return "gathered" if self.rerank_mode == "device" else "host"
        if self.rerank_mode == "device":
            return "mirror"
        return "mirror" if self._device_t.type == "cuda" else "host"

    def _device_rerank_active(self) -> bool:
        return self._rerank_venue() == "mirror"

    # -- search ---------------------------------------------------------------

    def search_batch_submit(self, queries: np.ndarray, k: int,
                            slot_mask: Optional[np.ndarray] = None,
                            mask_layout_version: Optional[int] = None):
        """The scan + re-rank pipeline is synchronous (the re-rank needs
        the candidates), so the async contract is served eagerly —
        inheriting FlatIndex's launcher would swap the PQ lane for a full
        exact scan."""
        return SearchBatchHandle.ready(self._search_hits(
            queries, k, slot_mask, None, mask_layout_version))

    def search_batch(self, queries: np.ndarray, k: int,
                     slot_mask: Optional[np.ndarray] = None,
                     refine: Optional[int] = None,
                     mask_layout_version: Optional[int] = None
                     ) -> List[List[Tuple[int, float]]]:
        return self._search_hits(queries, k, slot_mask, refine,
                                 mask_layout_version).rows()

    def _search_hits(self, queries: np.ndarray, k: int,
                     slot_mask: Optional[np.ndarray],
                     refine: Optional[int],
                     mask_layout_version: Optional[int]) -> HitColumns:
        """``search_batch``'s hits, from every venue and fallback. The exact
        scan serves while the index is untrained and for an r past the
        scan's envelope."""
        if slot_mask is not None:
            # no auto-train on a filtered query (the JAX package's policy)
            with self._lock:
                trained = self._trained
            if not trained:
                return self._exact_hits(queries, k, slot_mask,
                                        mask_layout_version)
            return self._pq_search(queries, k, refine, slot_mask,
                                   mask_layout_version)
        with self._lock:
            if (not self._trained
                    and self._len >= max(self.auto_train_min, self.ksub)):
                self.train()
            trained = self._trained
        if not trained:
            return self._exact_hits(queries, k)
        return self._pq_search(queries, k, refine, None, None)

    def _pq_search(self, queries: np.ndarray, k: int,
                   refine: Optional[int],
                   slot_mask: Optional[np.ndarray],
                   mask_layout_version: Optional[int]) -> HitColumns:
        from ..ops.topk import next_pow2
        fb: dict = ({} if slot_mask is None else
                    {"slot_mask": slot_mask,
                     "mask_layout_version": mask_layout_version})
        queries = np.asarray(queries, dtype=np.float32)
        if queries.ndim != 2:
            from ..errors import InvalidVectorError
            raise InvalidVectorError("queries must be a (Q, d) array")
        with self._lock:
            if (mask_layout_version is not None
                    and mask_layout_version != self.slot_layout_version):
                from ..errors import StaleSlotMaskError
                raise StaleSlotMaskError(mask_layout_version,
                                         self.slot_layout_version)
            if self._len == 0 or k <= 0:
                return HitColumns.from_rows([[]] * queries.shape[0])
            if queries.shape[1] != self._dim:
                from ..errors import DimensionMismatchError
                raise DimensionMismatchError(self._dim, queries.shape[1])
            if self._metric is DistanceMetric.COSINE:
                qn = np.sqrt(np.sum(queries * queries, axis=1))
                validate_cosine_operands(self._metric,
                                         float(qn.min(initial=np.inf)),
                                         self._zero_norm_live)
            k_req = min(int(k), self._len)
            r_eff = max(int(refine if refine is not None else self.refine),
                        k_req)
            r = next_pow2(min(r_eff, self._capacity), floor=1)
            if r > self._scan_r_max():
                # huge k / tiny index: the exact scan is the better
                # program than a multi-thousand-row re-rank
                return self._exact_hits(queries, k, **fb)
            state = self._scan_state()
            mk = None
            exact_args = None
            if slot_mask is not None:
                cap = (self._capacity if self._mesh is not None
                       else int(state["valid"].shape[0]))
                mk = np.asarray(slot_mask, dtype=bool)
                if mk.shape[0] < cap:
                    mk = np.concatenate(
                        [mk, np.zeros(cap - mk.shape[0], bool)])
                mk = mk[:cap]
                ne = min(cap, self._capacity)
                elig = np.nonzero(mk[:ne] & self._valid[:ne])[0]
                if elig.size == 0:
                    return HitColumns.from_rows([[]] * queries.shape[0])
                if elig.size <= max(r, _MASKED_EXACT_MAX):
                    # selective filter: one re-rank's worth of rows —
                    # scan nothing and answer exactly from a consistent
                    # snapshot gathered under the lock
                    exact_args = (
                        np.ascontiguousarray(self._vectors[elig],
                                             np.float32),
                        self._id_of_slot[elig].copy())
                else:
                    state = dict(state)
                    state["valid"] = self._pq_mask(state["valid"], mk)
            # bound the stacked per-query device footprint per dispatch
            max_q = max(256, _pow2_floor(
                _CAND_BYTES // max(self._scan_bytes_per_query(r), 1)))
            tick0 = self._tick
            lv0 = self.slot_layout_version
            rr_rows = None
            if exact_args is None:
                if self._device_rerank_active():
                    # the f32 rows synced under the SAME lock hold as the
                    # codes: rows and candidacy form one snapshot
                    rr_rows = self._sync_device()["db"]
                self._searches_in_flight += 1
        if exact_args is not None:
            return self._masked_exact_host(queries, k_req, *exact_args)
        try:
            from ..ops.pq import pq_rerank_topk
            q = queries.shape[0]
            svs, sls = [], []
            dev_out = []
            with annotate("vdb/pq.scan"):
                for a in range(0, q, max_q):
                    qb_dev = self._to_device(queries[a:a + max_q])
                    sv, sl = self._scan_call(state, qb_dev, r)
                    got = qb_dev.shape[0]
                    if rr_rows is not None:
                        with annotate("vdb/pq.rerank_dev"):
                            # state["valid"] already carries the filter
                            dv, ds = pq_rerank_topk(
                                qb_dev, rr_rows, sl, sv, state["valid"],
                                self._metric, k_req)
                        dev_out.append((dv.cpu().numpy(), ds.cpu().numpy(),
                                        sv, sl, got))
                    else:
                        svs.append(sv.cpu().numpy())
                        sls.append(sl.cpu().numpy())
        finally:
            with self._lock:
                self._searches_in_flight -= 1
        if rr_rows is not None:
            with annotate("vdb/pq.collect"):
                res = self._collect_device_rerank(queries, dev_out, k_req,
                                                  tick0, lv0, mk)
        else:
            scan_scores = np.concatenate(svs)
            slots = np.concatenate(sls).astype(np.int64)
            with annotate("vdb/pq.rerank"):
                if self._rerank_venue() == "gathered":
                    res = self._rerank_gathered(queries, scan_scores,
                                                slots, k_req, tick0, lv0,
                                                slot_mask=mk)
                else:
                    res = self._rerank(queries, scan_scores, slots,
                                       k_req, tick0, lv0, slot_mask=mk)
        if res is not None and mk is not None:
            res = self._fill_masked_short(res, queries, k_req, mk, lv0)
        if res is not None:
            return res
        # the slot layout changed mid-flight: the candidate slots address
        # the old packing (PqFlatIndex never repacks; the check keeps the
        # contract for subclasses that do)
        if slot_mask is not None:
            from ..errors import StaleSlotMaskError
            raise StaleSlotMaskError(mask_layout_version,
                                     self.slot_layout_version)
        return self._pq_search(queries, k, refine, None, None)

    def _collect_device_rerank(self, queries: np.ndarray, dev_out,
                               k_req: int, tick0: int, lv0: int,
                               slot_mask: Optional[np.ndarray]
                               ) -> Optional[HitColumns]:
        """Map the device re-rank's (Q, k) results to ids, as HitColumns:
        each row stops at its first non-finite distance. Distances were
        computed over the snapshot rows; slots mutated after ``tick0`` are
        dropped, and a query that lost results that way is re-answered by
        the host re-rank over its full candidate pool, which the dispatch
        loop kept on the device for this repair; its row is written into
        the columns."""
        parts: List[HitColumns] = []
        a = 0
        for dv, ds, sv_dev, sl_dev, got in dev_out:
            sl = ds.astype(np.int64)
            with self._lock:
                if self.slot_layout_version != lv0:
                    return None
                ok = self._slot_tick[sl] <= tick0
                ok &= self._valid[sl]
                if slot_mask is not None:
                    ok &= slot_mask[sl]
                ids = self._id_of_slot[sl]
            finite = np.isfinite(dv)
            hits = HitColumns.cut(ids, dv, finite, k_req)
            dropped = finite & ~ok
            if dropped.any():
                qidx = np.nonzero(dropped.any(axis=1))[0]
                sv_h = sv_dev.cpu().numpy()
                sl_h = sl_dev.cpu().numpy().astype(np.int64)
                fixed = self._rerank(
                    np.ascontiguousarray(queries[a + qidx]),
                    sv_h[qidx], sl_h[qidx], k_req, tick0, lv0,
                    slot_mask=slot_mask)
                if fixed is None:
                    return None
                hits = hits.put(qidx, fixed)
            parts.append(hits)
            a += got
        return HitColumns.concat(parts)

    def _rerank_gathered(self, queries: np.ndarray,
                         scan_scores: np.ndarray, slots: np.ndarray,
                         k_req: int, tick0: int, lv0: int,
                         slot_mask: Optional[np.ndarray] = None
                         ) -> Optional[HitColumns]:
        """Venue "gathered": per query block the host gathers the
        candidate rows and the consistency mask under the lock, the device
        computes exact distances + top-k (ops/pq.pq_rerank_gathered), and
        the next block is gathered while the device works. Same contract
        as ``_rerank``; returns None if the slot layout changed."""
        from ..ops.pq import pq_rerank_gathered
        metric = self._metric
        out: List[HitColumns] = []
        pending: list = []            # (dists_dev, pos_dev, ids)

        def collect_one(entry) -> None:
            dv_dev, pos_dev, ids = entry
            dv = dv_dev.cpu().numpy()
            out.append(HitColumns.cut(
                np.take_along_axis(ids, pos_dev.cpu().numpy(), axis=1), dv,
                np.isfinite(dv), k_req))

        blk = _RERANK_QBLOCK
        for a in range(0, queries.shape[0], blk):
            qb = queries[a:a + blk]
            sl = slots[a:a + blk]
            with self._lock:
                if self.slot_layout_version != lv0:
                    return None
                ok = np.isfinite(scan_scores[a:a + blk])
                ok &= self._slot_tick[sl] <= tick0
                ok &= self._valid[sl]
                if slot_mask is not None:
                    ok &= slot_mask[sl]
                rows = np.ascontiguousarray(self._vectors[sl], np.float32)
                ids = self._id_of_slot[sl]
            dv_dev, pos_dev = pq_rerank_gathered(
                self._to_device(qb), self._to_device(rows),
                self._to_device(ok), metric, k_req)
            pending.append((dv_dev, pos_dev, ids))
            if len(pending) >= 2:     # depth-2: one block in flight
                collect_one(pending.pop(0))
        for entry in pending:
            collect_one(entry)
        return HitColumns.concat(out)

    def _rerank(self, queries: np.ndarray, scan_scores: np.ndarray,
                slots: np.ndarray, k_req: int, tick0: int, lv0: int,
                slot_mask: Optional[np.ndarray] = None
                ) -> Optional[HitColumns]:
        """Exact f32 host re-rank of the candidate slots on the true
        stored rows (venue "host"). Candidates whose slot mutated after
        the snapshot (stamp > tick0) are dropped; ``slot_mask`` re-applies
        the filter per slot. The lock is held per block for the gather
        only; returns None if the slot layout changed mid-rerank."""
        out: List[HitColumns] = []
        metric = self._metric
        for a in range(0, queries.shape[0], _RERANK_QBLOCK):
            qb = queries[a:a + _RERANK_QBLOCK]
            sl = slots[a:a + _RERANK_QBLOCK]
            with self._lock:
                if self.slot_layout_version != lv0:
                    return None
                ok = np.isfinite(scan_scores[a:a + _RERANK_QBLOCK])
                ok &= self._slot_tick[sl] <= tick0
                ok &= self._valid[sl]
                if slot_mask is not None:
                    ok &= slot_mask[sl]
                rows = self._vectors[sl]                  # (qb, r, d) copy
                ids = self._id_of_slot[sl]
            # distances from the gathered row values only, in the direct
            # forms (difference form for euclidean: no cancellation)
            if metric is DistanceMetric.EUCLIDEAN:
                diff = rows - qb[:, None, :]
                dist = np.sqrt(np.einsum("qrd,qrd->qr", diff, diff,
                                         optimize=True))
            elif metric is DistanceMetric.DOT_PRODUCT:
                dist = -np.einsum("qrd,qd->qr", rows, qb, optimize=True)
            else:
                dots = np.einsum("qrd,qd->qr", rows, qb, optimize=True)
                qn = np.sqrt(np.sum(qb * qb, axis=1))[:, None]
                xn = np.sqrt(np.einsum("qrd,qrd->qr", rows, rows,
                                       optimize=True))
                denom = np.maximum(qn * xn, 1e-30)
                dist = 1.0 - np.clip(dots / denom, -1.0, 1.0)
            dist = np.where(ok, dist, np.inf).astype(np.float32)
            order = np.argsort(dist, axis=1, kind="stable")[:, :k_req]
            dist = np.take_along_axis(dist, order, axis=1)
            out.append(HitColumns.cut(np.take_along_axis(ids, order, axis=1),
                                      dist, np.isfinite(dist), k_req))
        return HitColumns.concat(out)

    def _host_dists(self, qb: np.ndarray, rows: np.ndarray) -> np.ndarray:
        """(q, d) x (c, d) -> (q, c) exact f32 distances in the re-rank's
        direct forms. Callers bound q*c*d to _HOST_DIST_BYTES."""
        metric = self._metric
        if metric is DistanceMetric.EUCLIDEAN:
            diff = rows[None, :, :] - qb[:, None, :]
            return np.sqrt(np.einsum("qcd,qcd->qc", diff, diff,
                                     optimize=True)).astype(np.float32)
        if metric is DistanceMetric.DOT_PRODUCT:
            return (-(qb @ rows.T)).astype(np.float32)
        dots = qb @ rows.T
        qn = np.sqrt(np.sum(qb * qb, axis=1))[:, None]
        xn = np.sqrt(np.einsum("cd,cd->c", rows, rows))[None, :]
        denom = np.maximum(qn * xn, 1e-30)
        return (1.0 - np.clip(dots / denom, -1.0, 1.0)).astype(np.float32)

    def _masked_exact_host(self, queries: np.ndarray, k_req: int,
                           rows: np.ndarray, ids: np.ndarray
                           ) -> HitColumns:
        """Exact host k-NN over a SMALL eligible row set (selective
        filters), gathered under the lock by the caller. Every row is
        eligible and live, so no hit is dead."""
        out: List[HitColumns] = []
        c, d = rows.shape
        qblk = max(1, min(_RERANK_QBLOCK,
                          _HOST_DIST_BYTES // max(c * d * 4, 1)))
        kk = min(k_req, c)
        for a in range(0, len(queries), qblk):
            dist = self._host_dists(queries[a:a + qblk], rows)
            order = np.argsort(dist, axis=1, kind="stable")[:, :kk]
            out.append(HitColumns.cut(ids[order],
                                      np.take_along_axis(dist, order, axis=1),
                                      np.ones(order.shape, bool), kk))
        return HitColumns.concat(out)

    def _fill_masked_short(self, res: HitColumns, queries: np.ndarray,
                           k_req: int, mk: np.ndarray, lv0: int
                           ) -> Optional[HitColumns]:
        """Safety net for masked scans: a query that came back with fewer
        than k results is re-answered by an exact host stream over the
        eligible slots. Returns None when the slot layout changed."""
        short = np.nonzero(res.counts < k_req)[0]
        if not short.size:
            return res
        with self._lock:
            if self.slot_layout_version != lv0:
                return None
            ne = min(mk.shape[0], self._capacity)
            elig = np.nonzero(mk[:ne] & self._valid[:ne])[0]
            if elig.size == 0:
                return res
            fixed = self._masked_exact_stream(
                np.ascontiguousarray(queries[short]), k_req, elig)
        better = fixed.counts > res.counts[short]
        return res.put(short[better], HitColumns(
            fixed.ids[better], fixed.dists[better], fixed.counts[better]))

    def _masked_exact_stream(self, qs: np.ndarray, k_req: int,
                             elig: np.ndarray) -> HitColumns:
        """Exact host k-NN streamed over a LARGE eligible slot set with a
        running top-k (lock held by the caller: the gather and the result
        are one snapshot). Each row holds its finite distances ordered by
        (distance, id)."""
        q = len(qs)
        best_d = np.full((q, k_req), np.inf, np.float32)
        best_i = np.full((q, k_req), -1, np.int64)
        for a in range(0, elig.size, _MASKED_STREAM_CHUNK):
            sl = elig[a:a + _MASKED_STREAM_CHUNK]
            rows = np.ascontiguousarray(self._vectors[sl], np.float32)
            ids = self._id_of_slot[sl]
            qblk = max(1, _HOST_DIST_BYTES // max(rows.size * 4, 1))
            for b in range(0, q, qblk):
                dist = self._host_dists(qs[b:b + qblk], rows)
                cat_d = np.concatenate([best_d[b:b + qblk], dist], axis=1)
                cat_i = np.concatenate(
                    [best_i[b:b + qblk],
                     np.broadcast_to(ids, dist.shape)], axis=1)
                sel = np.argpartition(cat_d, k_req - 1, axis=1)[:, :k_req]
                best_d[b:b + qblk] = np.take_along_axis(cat_d, sel, axis=1)
                best_i[b:b + qblk] = np.take_along_axis(cat_i, sel, axis=1)
        fin = np.isfinite(best_d)
        order = np.lexsort((best_i, np.where(fin, best_d, np.inf)), axis=1)
        return HitColumns.cut(np.take_along_axis(best_i, order, axis=1),
                              np.take_along_axis(best_d, order, axis=1),
                              np.take_along_axis(fin, order, axis=1), k_req)

    def calibrate_refine(self, target_recall: float, *, k: int = 10,
                         sample: int = 256,
                         candidates=(16, 32, 64, 128, 256, 512),
                         queries: Optional[np.ndarray] = None,
                         set_default: bool = True, seed: int = 0) -> dict:
        """The smallest refine pool whose measured recall@k meets
        ``target_recall``, ground-truthed by an exact host stream over the
        live rows. Probe queries default to a random sample of stored rows
        (slightly optimistic). Returns ``{"refine", "recall", "curve"}``;
        ``set_default`` installs the winner."""
        if not 0.0 < float(target_recall) <= 1.0:
            raise IndexOpError("target_recall must be in (0, 1]")
        with self._lock:
            if not self._trained:
                if self._len < self.ksub:
                    raise IndexOpError(
                        "calibrate_refine needs a trained index "
                        f"(or >= ksub={self.ksub} rows to train one)")
                self.train()
        rng = np.random.default_rng(seed)
        with self._lock:
            live = np.flatnonzero(self._valid[:self._capacity])
            if queries is None:
                take = min(int(sample), live.size)
                sel = np.sort(rng.choice(live.size, size=take,
                                         replace=False))
                queries = np.ascontiguousarray(
                    self._vectors[live[sel]], np.float32)
            else:
                queries = np.ascontiguousarray(queries, np.float32)
            k_eff = min(int(k), self._len)
            truth = self._masked_exact_stream(queries, k_eff, live).rows()
        truth_sets = [set(i for i, _ in row) for row in truth]
        curve: dict = {}
        chosen = None
        rmax = self._scan_r_max()
        for cand in sorted({max(1, min(int(c), rmax))
                            for c in candidates}):
            got = self.search_batch(queries, k_eff, refine=cand)
            hits = sum(len(ts & {i for i, _ in row}) / max(len(ts), 1)
                       for ts, row in zip(truth_sets, got))
            curve[cand] = recall = hits / max(len(truth_sets), 1)
            if recall >= float(target_recall):
                chosen = cand
                break
        if chosen is None:
            chosen = max(curve)
        if set_default:
            self.refine = int(chosen)
        return {"refine": int(chosen), "recall": curve[chosen],
                "curve": curve}

    def search_with_refine(self, query, k: int,
                           refine: int) -> List[Tuple[int, float]]:
        """Per-call recall/latency knob: re-rank the top ``refine`` PQ
        candidates exactly (passed through, never stored: mutating
        self.refine would race concurrent searches)."""
        from ..vector import as_f32_array
        return self.search_batch(as_f32_array(query).reshape(1, -1), k,
                                 refine=int(refine))[0]


class PqFlatIndex(_PqCodesCore, FlatIndex):
    """Product-quantized flat index with an exact re-rank."""

    def __init__(self, metric: DistanceMetric, m: Optional[int] = None,
                 ksub: int = 256, refine: int = 64, train_iters: int = 15,
                 auto_train_min: int = 8192, seed: int = 0,
                 host_backing: Optional[str] = None,
                 scan_recall: float = 0.85, rotate: bool = True,
                 mesh=None, row_axis: str = "shard", rerank: str = "auto",
                 device="cuda"):
        # host_backing: the f32 rows in a disk-backed memmap (the device
        # holds m bytes a row of codes); scan_recall: the JAX scan's
        # approx_min_k target, checked and kept, changes nothing (the
        # selection is exact); rotate: learn an OPQ pre-rotation at train
        # time; mesh / row_axis: shard the codes over the mesh (module
        # docstring); rerank: venue of the exact candidate re-rank;
        # device: where the codes, the scan and the "mirror" re-rank live
        # (the mesh's devices, when one is given)
        if not 0.0 < scan_recall <= 1.0:
            raise ValueError("scan_recall must be in (0, 1]")
        self.scan_recall = float(scan_recall)
        super().__init__(metric, search_mode="exact", storage="f32",
                         mesh=mesh, row_axis=row_axis, device=device,
                         host_backing=host_backing)
        self._pq_init(m, ksub, refine, train_iters, auto_train_min, seed,
                      rotate=rotate, rerank=rerank)

    # -- training -------------------------------------------------------------

    def train(self) -> None:
        """Fit the subspace codebooks on the live rows (a seeded sample of
        at most _TRAIN_SAMPLE_MAX) and mark every row for encoding. Never
        repacks slots, so filter masks and slot ids stay valid."""
        with self._lock:
            n = self._len
            if n < self.ksub:
                raise IndexOpError(
                    f"need at least ksub={self.ksub} vectors to train PQ")
            d = self._dim
            m = self._resolve_m(d)
            live = np.nonzero(self._valid)[0]
            smax = min(live.size, _TRAIN_SAMPLE_MAX)
            if live.size > smax:
                sel = np.random.default_rng(self._seed).choice(
                    live, smax, replace=False)
                sample = self._vectors[np.sort(sel)]
            elif live.size == n and n and int(live[-1]) == n - 1:
                sample = self._vectors[:n]      # contiguous prefix: a view
            else:
                sample = self._vectors[live]
            rot = None
            if self._rotate:
                from ..ops.pq import fit_opq_rotation
                rot = fit_opq_rotation(sample, m)
            codebook = self._fit_codebook(sample, m, rot)
            self._install_codebook(codebook, rot)

    # -- trained state --------------------------------------------------------

    def export_trained_state(self) -> Optional[dict]:
        """The codebook (and rotation) is the whole trained state: codes
        are a deterministic function of (codebook, rows, device), so a
        reader re-encodes instead of carrying them."""
        with self._lock:
            if not self._trained:
                return None
            state = {"codebook": self._codebook.copy(),
                     "ksub": np.int64(self.ksub)}
            if self._rot is not None:
                state["rotation"] = self._rot.copy()
            return state

    def import_trained_state(self, tables: dict) -> None:
        """Install an exported state (this package's or the JAX
        package's). The codebook is rounded to bf16 values with torch's
        round-to-nearest-even cast, as the JAX package rounds with
        ml_dtypes: idempotent for pq_fit output, and it keeps the decode
        exact for hand-built codebooks."""
        from .flat import _quantize_bf16
        with self._lock:
            cb = _quantize_bf16(np.asarray(tables["codebook"], np.float32))
            if cb.ndim != 3:
                raise IndexOpError("pq state: codebook must be 3-D")
            m, ksub, dsub = cb.shape
            if self._dim is not None and m * dsub != self._dim:
                raise IndexOpError(
                    f"pq state: codebook covers {m * dsub} dims, index "
                    f"holds {self._dim}")
            rot = tables.get("rotation")
            if rot is not None:
                rot = np.ascontiguousarray(rot, np.float32)
                if rot.shape != (m * dsub, m * dsub):
                    raise IndexOpError(
                        f"pq state: rotation shape {rot.shape} does not "
                        f"match dimension {m * dsub}")
            self.ksub = ksub
            # self._rotate (the preference for FUTURE trains) is kept
            self._install_codebook(cb, rot)

    def adopt_codes(self, codes: np.ndarray) -> None:
        """Take over per-slot codes computed elsewhere (a trained index
        only): ``codes`` (capacity, m) uint8 in this index's slot layout,
        e.g. the JAX package's ``_codes`` carried across with the same
        slots (convert.pq_store_from_reference). Dead slots' codes are
        masked by validity; later writes re-encode here."""
        with self._lock:
            if not self._trained:
                raise IndexOpError("adopt_codes needs a trained index")
            codes = np.asarray(codes)
            if codes.shape != (self._capacity, self._m):
                raise IndexOpError(
                    f"codes shape {codes.shape} != "
                    f"({self._capacity}, {self._m})")
            if codes.size and int(codes.max()) >= self.ksub:
                raise IndexOpError(
                    f"code {int(codes.max())} out of range for "
                    f"ksub={self.ksub}")
            self._codes = np.ascontiguousarray(codes, np.uint8).copy()
            self._pq_full_reencode = False
            self._pq_dirty.clear()
            self._codes_dev = None
            self._pq_valid_dirty = True

    def __repr__(self) -> str:
        where = (f"mesh={self._mesh.shape}" if self._mesh is not None
                 else f"device={self._device_t}")
        return (f"PqFlatIndex(metric={self._metric.value}, len={self._len}, "
                f"dim={self._dim}, m={self._m or self._m_arg}, "
                f"ksub={self.ksub}, trained={self._trained}, {where})")


__all__ = ["PqFlatIndex"]
