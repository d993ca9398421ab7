"""IVF-PQ: the inverted-file layout with product-quantized RESIDUAL codes.

Port of ``vectordb_tpu/index/ivfpq.py``. Plain PQ (index/pq.py) codes raw
rows: the rows of a tight cluster differ only by deviations below the
global quantization's resolution, so their codes tie and recall stops
growing with ``refine``. IVF-PQ codes each row as ``x ~= c + r_hat``,
``c`` the centroid of its IVF cluster and ``r_hat`` the PQ-decoded
residual, so the codebook resolves exactly those deviations.

Composition, as in the JAX package:
  * ``IvfFlatIndex`` (index/ivf.py): training (k-means, balanced
    assignment), the cluster-contiguous slot repack, post-train write
    routing (cluster free slots, then the spill, then a retrain) and the
    trained-layout state;
  * ``_PqCodesCore`` (index/pq.py): code storage and device sync, the
    encode path, mutation stamps, the scan dispatch and the exact re-rank
    (returned distances are exact f32 over the stored rows; ``refine`` is
    the recall knob);
  * ``ops/pq.ivfpq_scan_topr``: the streaming residual scan (kernel K8
    decodes each chunk; one (Q, nlist) pair of products gives every
    cluster's ``q . c``).

Search scans every cluster, so ``nprobe`` does not apply; training repacks
slots (``slot_layout_version`` bumps) and a search that races a retrain
re-runs over the new layout. Untrained, and for a refine past the scan's
pool, the exact flat path runs over the layout (K4 + K2 over the f32
device rows, K5 in tier 2).

The centroids and, under OPQ, the rotated centroid table are rounded to
bf16 values with torch's round-to-nearest-even cast, as the JAX package
rounds with ml_dtypes. ``device`` (the port's own parameter, last) is
where the codes, the scan and the "mirror" re-rank live. ``scan_recall``
is kept for the JAX signature: selection is exact here, so it changes
nothing.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..distance import DistanceMetric
from ..errors import IndexOpError
from ..utils.profiling import annotate
from .flat import _quantize_bf16
from .ivf import SUB, IvfFlatIndex
from .pq import (_MAX_REFINE, _ONEHOT_BYTES, _SCAN_CHUNK, _TRAIN_SAMPLE_MAX,
                 _PqCodesCore)

# host-vs-device threshold for the nearest-centroid search (rows * nlist *
# d): single-row writes stay on the host, bulk goes to the device
_NEAREST_HOST_MAX = 1 << 28
_NEAREST_CHUNK = 1 << 16


class IvfPqIndex(_PqCodesCore, IvfFlatIndex):
    """IVF-repacked layout + PQ residual codes + exact re-rank."""

    # the scan streams every cluster: no nprobe. The store's knob
    # validation keys off these attributes
    search_with_nprobe = None
    calibrate_nprobe = None

    def __init__(self, metric: DistanceMetric, nlist: Optional[int] = None,
                 m: Optional[int] = None, ksub: int = 256,
                 refine: int = 64, train_iters: int = 12,
                 spill_frac: float = 0.02, auto_train_min: int = 8192,
                 seed: int = 0, scan_recall: float = 0.85,
                 assign_mode: str = "auto",
                 balance_slack: float = 1.5, rotate: bool = True,
                 rerank: str = "auto", device="cuda"):
        # rotate: learn an OPQ pre-rotation on the RESIDUAL sample and run
        # the whole scan in the rotated space (codes approximate rotated
        # residuals against the rotated bf16 centroid table; queries
        # rotate at scan entry); the exact re-rank uses the true rows
        super().__init__(metric, nlist=nlist, train_iters=train_iters,
                         spill_frac=spill_frac,
                         auto_train_min=auto_train_min, seed=seed,
                         storage="f32", assign_mode=assign_mode,
                         balance_slack=balance_slack, device=device)
        self._pq_init(m, ksub, refine, train_iters, auto_train_min, seed,
                      rotate=rotate, rerank=rerank)
        if not 0.0 < scan_recall <= 1.0:
            raise ValueError("scan_recall must be in (0, 1]")
        self.scan_recall = float(scan_recall)
        # nearest-centroid ids of the SPILL slots (their residuals are
        # taken against it); -1 = unresolved, filled at encode time
        self._spill_cid: Optional[np.ndarray] = None
        self._cid_sp_dev = None
        self._cid_sp_dirty = True
        self._cents_scan_host: Optional[np.ndarray] = None
        self._cents_scan_dev = None
        self._csq_dev = None

    # -- geometry -------------------------------------------------------------

    def _scan_cents(self) -> np.ndarray:
        """The centroid table the scan reconstructs against: the rotated
        centroids rounded to bf16 under OPQ, the (bf16) centroids
        otherwise. Residuals are taken against THIS table, so ``x_hat =
        c_scan + decode(code)`` carries no per-cluster rounding bias. A
        function of (centroids, rotation): recovery rebuilds it."""
        if self._cents_scan_host is None:
            c = self._centroids
            if self._rot is not None:
                c = _quantize_bf16(c.astype(np.float32) @ self._rot)
            self._cents_scan_host = np.ascontiguousarray(c, np.float32)
        return self._cents_scan_host

    def _encode_rot(self):
        # residuals are rotated on the host against the scan's table: the
        # encode must not rotate again
        return None

    @property
    def _span(self) -> int:
        return self._t_c * SUB

    @property
    def _spill_base(self) -> int:
        return self._nlist * self._span

    def _nearest_cids(self, rows: np.ndarray) -> np.ndarray:
        """Nearest (rounded) centroid of each row: host BLAS for small
        batches, the device's assignment scores in bulk."""
        n = len(rows)
        c = self._centroids
        if n * c.shape[0] * c.shape[1] <= _NEAREST_HOST_MAX:
            csq = np.sum(c * c, axis=1)
            out = np.empty(n, np.int32)
            for a in range(0, n, 8192):
                blk = np.ascontiguousarray(rows[a:a + 8192], np.float32)
                sc = csq[None, :] - 2.0 * (blk @ c.T)
                out[a:a + len(blk)] = np.argmin(sc, axis=1)
            return out
        from ..ops.ivf import _assign_topk_chunk
        if self._centroids_dev is None:
            self._centroids_dev = self._to_device(self._centroids)
        out = np.empty(n, np.int32)
        for a in range(0, n, _NEAREST_CHUNK):
            blk = self._to_device(np.ascontiguousarray(
                rows[a:a + _NEAREST_CHUNK], np.float32))
            out[a:a + len(blk)] = _assign_topk_chunk(
                blk, self._centroids_dev, 1)[:, 0].cpu().numpy()
        return out

    # -- training -------------------------------------------------------------

    def train(self) -> None:
        """IVF repack (cluster-contiguous slots) + the residual codebook
        fit, so ``_trained`` means layout AND codebook. If the codebook
        fit fails the index stays correct: searches take the exact flat
        path over the repacked layout. IVF's stages are followed by the
        spans ``vdb/pq.spill_cids`` (the spill rows' centroid search),
        ``vdb/pq.opq`` (the sample's residuals and the OPQ fit) and
        ``vdb/pq.codebook``; the codes encode at the next search sync."""
        with self._lock:
            IvfFlatIndex.train(self)          # repack; bumps layout_version
            self._trained = False             # not PQ-searchable yet
            # bf16 centroids make the scan's centroid terms exact in bf16
            # arithmetic, as the codewords are
            self._centroids = _quantize_bf16(self._centroids)
            self._centroids_dev = None
            self._cents_scan_dev = None
            self._cents_scan_host = None
            # the repack rewrote every slot: fresh stamps at a new tick, so
            # searches in flight drop every stale candidate
            self._tick += 1
            self._slot_tick = np.full(self._capacity, self._tick, np.int64)

            with annotate("vdb/pq.spill_cids"):
                m = self._resolve_m(self._dim)
                live = np.nonzero(self._valid)[0]
                sb = self._spill_base
                self._spill_cid = np.full(self._capacity - sb, -1, np.int32)
                self._cid_sp_dirty = True
                sp_live = live[live >= sb]
                if sp_live.size:
                    self._spill_cid[sp_live - sb] = self._nearest_cids(
                        self._vectors[sp_live])

            with annotate("vdb/pq.opq"):
                smax = min(live.size, _TRAIN_SAMPLE_MAX)
                if live.size > smax:
                    sel = np.sort(np.random.default_rng(self._seed).choice(
                        live, smax, replace=False))
                else:
                    sel = live
                rows = self._vectors[sel].astype(np.float32)
                cids = np.where(sel < sb, sel // self._span,
                                0).astype(np.int64)
                sp = sel >= sb
                if sp.any():
                    cids[sp] = self._spill_cid[sel[sp] - sb]
                res = rows - self._centroids[cids]
                rot = None
                if self._rotate:
                    # OPQ on the residuals: their energy is what the
                    # subspaces must balance
                    from ..ops.pq import fit_opq_rotation
                    rot = fit_opq_rotation(res, m)
                self._rot = rot
                self._rot_dev = None
                self._cents_scan_host = None
                if rot is not None:
                    # fit (and later encode) in the scan's basis: rotated
                    # rows minus the rotated bf16 centroid table
                    res = rows @ rot - self._scan_cents()[cids]
            with annotate("vdb/pq.codebook"):
                self._install_codebook(self._fit_codebook(res, m), rot)

    # -- encoding (residuals) -------------------------------------------------

    def _encode_slots(self, slots: np.ndarray) -> np.ndarray:
        slots = np.asarray(slots, np.int64)
        sb = self._spill_base
        cids = np.where(slots < sb, slots // self._span, 0).astype(np.int64)
        sp = np.nonzero(slots >= sb)[0]
        if sp.size:
            spi = slots[sp] - sb
            unknown = self._spill_cid[spi] < 0
            if unknown.any():
                self._spill_cid[spi[unknown]] = self._nearest_cids(
                    self._vectors[slots[sp[unknown]]])
                self._cid_sp_dirty = True
            cids[sp] = self._spill_cid[spi]
        rows = self._vectors[slots].astype(np.float32)
        if self._rot is not None:
            # the scan's basis (_scan_cents): rotate, then subtract the
            # table the scan adds back
            res = rows @ self._rot - self._scan_cents()[cids]
        else:
            res = rows - self._centroids[cids]
        return self._encode_rows(res)

    # -- mutation hooks (spill-cid hygiene) -----------------------------------

    def _write_slot(self, slot: int, internal_id: int,
                    arr: np.ndarray) -> None:
        if self._trained and slot >= self._spill_base:
            self._spill_cid[slot - self._spill_base] = -1
            self._cid_sp_dirty = True
        super()._write_slot(slot, internal_id, arr)

    def _clear_slot(self, slot: int) -> None:
        if self._trained and slot >= self._spill_base:
            self._spill_cid[slot - self._spill_base] = -1
            self._cid_sp_dirty = True
        super()._clear_slot(slot)

    # -- device sync ----------------------------------------------------------

    def _pq_sync(self):
        out = super()._pq_sync()
        if self._cents_scan_dev is None:
            # _scan_cents: the one table the encode's residuals and the
            # scan's reconstruction share
            cents = self._scan_cents()
            self._cents_scan_dev = self._to_device(cents)
            self._csq_dev = self._to_device(np.sum(cents * cents, axis=1,
                                                   dtype=np.float32))
        if self._cid_sp_dirty or self._cid_sp_dev is None:
            self._cid_sp_dev = self._to_device(self._spill_cid)
            self._cid_sp_dirty = False
        return out

    # -- scan dispatch --------------------------------------------------------

    def _scan_cpc(self) -> int:
        """Clusters per scan chunk: ~_SCAN_CHUNK rows, bounded by the JAX
        package's one-hot budget (kept: it fixes the chunk boundaries and
        the pool's width, which the two packages share)."""
        budget_rows = max(1, _ONEHOT_BYTES // (self._m * self.ksub * 2))
        cpc = max(1, min(_SCAN_CHUNK, budget_rows) // self._span)
        return min(cpc, self._nlist)

    def _scan_r_max(self) -> int:
        return min(self._scan_cpc() * self._span, _MAX_REFINE)

    def _scan_pool_cols(self, r: int) -> int:
        nchunks = -(-self._nlist // self._scan_cpc())     # main + tail
        return (nchunks + 1) * r                          # + spill

    def _scan_bytes_per_query(self, r: int) -> int:
        s_rows = self._capacity - self._spill_base
        # stacked candidates + the (Q, nlist) q.c table + the dense (Q, S)
        # spill score block
        return self._scan_pool_cols(r) * 8 + (self._nlist + s_rows) * 4

    def _scan_state(self) -> dict:
        state = super()._scan_state()
        state.update(cents=self._cents_scan_dev, csq=self._csq_dev,
                     cid_sp=self._cid_sp_dev, span=self._span,
                     nlist=self._nlist, cpc=self._scan_cpc())
        return state

    def _scan_call(self, state: dict, qb: torch.Tensor, r: int):
        from ..ops.pq import ivfpq_scan_topr
        return ivfpq_scan_topr(qb, state["codes"], state["codebook"],
                               state["cnorm"], state["valid"],
                               state["cents"], state["csq"],
                               state["cid_sp"], self._metric, r=r,
                               cpc=state["cpc"], span=state["span"],
                               nlist=state["nlist"],
                               rot=self._rot_dev_arr())

    # -- trained-state persistence (engine checkpoint / recovery) -------------

    def export_trained_state(self) -> Optional[dict]:
        """The IVF layout tables + the residual codebook + the spill rows'
        nearest-centroid ids (+ the rotation). Codes are a function of
        these and the rows, so recovery re-encodes instead of carrying
        them; the spill ids are kept because the host and device nearest
        searches may break distance ties differently."""
        with self._lock:
            if not self._trained:
                return None
            tables = IvfFlatIndex.export_trained_state(self)
            tables["codebook"] = self._codebook.copy()
            tables["ksub"] = np.int64(self.ksub)
            tables["spill_cid"] = self._spill_cid.copy()
            if self._rot is not None:
                tables["rotation"] = self._rot.copy()
            return tables

    def import_trained_state(self, tables: dict,
                             rows_by_id: dict, dim: int) -> None:
        """Install an exported state (this package's or the JAX
        package's) over ``rows_by_id`` (internal id -> f32 row): no
        retrain; every row re-encodes at the next search."""
        with self._lock:
            IvfFlatIndex.import_trained_state(self, tables, rows_by_id,
                                              dim)
            self._trained = False
            self._centroids = _quantize_bf16(self._centroids)
            self._centroids_dev = None
            self._cents_scan_dev = None
            self._tick += 1
            self._slot_tick = np.full(self._capacity, self._tick, np.int64)

            cb = _quantize_bf16(np.asarray(tables["codebook"], np.float32))
            if cb.ndim != 3:
                raise IndexOpError("ivfpq state: codebook must be 3-D")
            m, ksub, dsub = cb.shape
            if m * dsub != dim:
                raise IndexOpError(
                    f"ivfpq state: codebook covers {m * dsub} dims, "
                    f"snapshot holds {dim}")
            spill_cid = np.asarray(tables["spill_cid"], np.int32).copy()
            if spill_cid.shape[0] != self._capacity - self._spill_base:
                raise IndexOpError(
                    "ivfpq state: spill_cid/layout size mismatch")
            rot = tables.get("rotation")
            if rot is not None:
                rot = np.ascontiguousarray(rot, np.float32)
                if rot.shape != (dim, dim):
                    raise IndexOpError(
                        f"ivfpq state: rotation shape {rot.shape} does "
                        f"not match dimension {dim}")
            # self._rotate (the preference for FUTURE trains) is kept: a
            # rotation-less state must not drop OPQ from later retrains
            self._cents_scan_host = None      # rebuilt from the new state
            self._spill_cid = spill_cid
            self._cid_sp_dirty = True
            self.ksub = ksub
            self._install_codebook(cb, rot)


__all__ = ["IvfPqIndex"]
