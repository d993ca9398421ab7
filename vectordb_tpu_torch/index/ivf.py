"""IVF-Flat: an inverted-file index with exact per-candidate refine.

Port of ``vectordb_tpu/index/ivf.py``. Training fits k-means centroids
(Lloyd iterations are matrix products on the device) and repacks the rows
by cluster; search probes each query's nprobe nearest clusters and refines
their rows exactly in f32 (kernel K2), so returned distances are exact and
recall depends on nprobe (tunable per query batch).

Storage reuses FlatIndex wholesale (packed arrays, slot allocator,
validity mask, device sync, exact masked search). Training reorders the
packed rows so cluster c owns the contiguous SUB-row tiles
[c*t_c, (c+1)*t_c), every cluster padded to the same t_c with dead slots
(a greedy balanced assignment caps the skew), plus a shared spill region
that every search scans; post-train inserts go to their cluster's free
slots, then the spill, and the index retrains itself when the spill
fills.

Filtered searches go through the probed path with the mask folded into
the validity array; a query the probed clusters cannot fill re-runs
through the exact flat path, so filters stay exact on this approximate
index. ``calibrate_nprobe`` and that fallback use the inherited certified
exact search over the trained layout (the flat index's kernels: K4 + K2
over f32 rows, K1 + K2 over bf16 rows, K7 + K2 over int8 codes).

Host rows stay f32 whatever the storage (the values quantize at insert):
training and the repack read and write them as f32. The device state of
an f32 store carries the f32-source flag of the coarse ladder (no mirror
copies), and the device rows are padded with dead slots to whole
256-row super-tiles, which the coarse kernels need; the slot layout, the
exported state and every answer are the JAX package's.

``device`` (the port's own parameter, last) is where the device state
lives, as for FlatIndex. ``seed`` seeds a ``torch.Generator``: the JAX
package's ``jax.random`` stream cannot be reproduced, so the two packages
train different centroids from one seed; ``export_trained_state`` /
``import_trained_state`` carry a trained layout across, byte for byte.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..distance import DistanceMetric
from ..errors import IndexOpError
from ..ops import coarse_kernel
from ..utils.profiling import annotate
from ..vector import Vector, as_f32_array
from .base import HitColumns, SearchBatchHandle
from .flat import FlatIndex

SUB = 16                    # rows per tile (matches ops/coarse_kernel.SUB)
# Above this many gathered candidate rows per query the probed path is
# slower than a full scan.
_MAX_CANDIDATES = 1 << 16
_TRAIN_SAMPLE_MAX = 1 << 18
_BALANCE_SLACK = 1.5        # cluster capacity = mean size * slack
_CANDIDATE_CLUSTERS = 16    # per-row alternatives for balanced assignment
# device rows are padded to whole super-tiles of the coarse kernels
_SUPER_ROWS = coarse_kernel.SUB * coarse_kernel.SUPER


def _hier_seed(seed: int) -> int:
    """The hierarchy's k-means seed, apart from the centroids' own."""
    return int(np.random.SeedSequence([seed, 1]).generate_state(1)[0])


class IvfFlatIndex(FlatIndex):
    """Inverted-file index with exact per-candidate refine."""

    # nlist at/above which auto assignment uses the two-level hierarchy
    # (ops/ivf.assign_preferences_hier)
    _HIER_AUTO_NLIST = 8192

    def __init__(self, metric: DistanceMetric, nlist: Optional[int] = None,
                 nprobe: int = 8, train_iters: int = 10,
                 spill_frac: float = 0.02, auto_train_min: int = 4096,
                 seed: int = 0, storage: str = "f32",
                 assign_mode: str = "auto",
                 balance_slack: float = _BALANCE_SLACK,
                 kmeans_balance: float = 0.0, device="cuda"):
        # storage="bf16" / "int8": vectors quantize at insert; the host
        # keeps the stored values as f32 (training and the repack are
        # unchanged); the device holds bf16 rows or int8 codes + pow2 row
        # scales, and the probed refine is exact over the stored values
        super().__init__(metric, search_mode="exact", storage=storage,
                         device=device)
        self._host_dtype = np.dtype(np.float32)
        self._want_mirrors = False
        if nlist is not None and nlist < 2:
            raise ValueError("nlist must be >= 2")
        self._nlist_arg = nlist
        self.nprobe = int(nprobe)
        self.train_iters = int(train_iters)
        self.spill_frac = float(spill_frac)
        self.auto_train_min = int(auto_train_min)
        if assign_mode not in ("auto", "flat", "hier"):
            raise ValueError(f"unknown assign_mode: {assign_mode!r}")
        self.assign_mode = assign_mode
        # cluster capacity = mean size * slack: lower slack shrinks the
        # repacked capacity at the cost of more rows in the spill region
        if balance_slack < 1.0:
            raise ValueError("balance_slack must be >= 1.0")
        self.balance_slack = float(balance_slack)
        # size-penalized Lloyd (ops/ivf.kmeans_fit); off by default
        if kmeans_balance < 0.0:
            raise ValueError("kmeans_balance must be >= 0")
        self.kmeans_balance = float(kmeans_balance)
        self._seed = int(seed)
        self._layout_version = 0
        # trained state
        self._trained = False
        self._nlist = 0
        self._t_c = 0                    # tiles per cluster
        self._s_t = 0                    # spill tiles
        self._centroids: Optional[np.ndarray] = None
        self._centroids_dev = None
        self._cluster_free: List[List[int]] = []
        self._spill_free: List[int] = []
        self._slot_cluster: Optional[np.ndarray] = None

    # -- device state ---------------------------------------------------------

    def _build_device_full(self) -> dict:
        """The flat device state, plus the f32-source tier of the coarse
        ladder for f32 rows, padded with dead slots to whole super-tiles
        (the trained layout's capacity is any multiple of SUB)."""
        dev = super()._build_device_full()
        if self.storage == "f32":
            dev.update(coarse_f32=True,
                       elo_max=coarse_kernel.residual_max_norm_f32(
                           dev["db"]))
        pad = (-self._capacity) % _SUPER_ROWS
        if pad:
            for key in ("db", "sq_norms", "norms", "valid", "scales"):
                if key in dev:
                    t = dev[key]
                    dev[key] = torch.cat(
                        [t, t.new_zeros((pad,) + tuple(t.shape[1:]))])
            if "hi" in dev:
                dev["hi"] = dev["db"]    # bf16 storage: db is its own hi
        return dev

    # -- training ------------------------------------------------------------

    @property
    def is_trained(self) -> bool:
        return self._trained

    @property
    def slot_layout_version(self) -> int:
        return self._layout_version

    def _auto_nlist(self, n: int) -> int:
        if self._nlist_arg:
            return self._nlist_arg
        # ~128 rows a cluster
        return max(8, min(1 << 15, n // 128))

    def train(self) -> None:
        """Fit centroids on the live rows and repack by cluster; its stages
        are the spans ``vdb/ivf.kmeans``, ``vdb/ivf.assign`` and
        ``vdb/ivf.repack``."""
        from ..ops.ivf import (assign_preferences, assign_preferences_hier,
                               kmeans_fit)
        with self._lock:
            n = self._len
            if n < 32:
                raise IndexOpError("need at least 32 vectors to train IVF")
            with annotate("vdb/ivf.kmeans"):
                nlist = min(self._auto_nlist(n), n // 4,
                            min(n, _TRAIN_SAMPLE_MAX))
                nlist = max(nlist, 2)
                live = np.nonzero(self._valid)[0]
                if live.size == n and n and int(live[-1]) == n - 1:
                    # contiguous prefix (fresh bulk load): a view, not a copy
                    rows = self._vectors[:n]
                else:
                    rows = self._vectors[live]                 # (n, d) f32
                d = rows.shape[1]

                # everything big stays on the device: the buffer the index
                # already syncs for search
                dev_state = self._sync_device()
                cap = self._capacity
                dev_db = dev_state["db"][:cap]
                dev_scales = dev_state.get("scales")      # int8 storage only
                if dev_scales is not None:
                    dev_scales = dev_scales[:cap]
                dev = dev_db.device
                if n > _TRAIN_SAMPLE_MAX:
                    sel = torch.from_numpy(np.random.default_rng(
                        self._seed).choice(live, _TRAIN_SAMPLE_MAX,
                                           replace=False)).to(dev)
                    sample = dev_db[sel]
                    s_smp = None if dev_scales is None else dev_scales[sel]
                elif n == cap:
                    sample = dev_db
                    s_smp = dev_scales
                else:
                    sel = torch.from_numpy(live).to(dev)
                    sample = dev_db[sel]
                    s_smp = None if dev_scales is None else dev_scales[sel]
                if s_smp is not None:
                    # dequantize the (bounded) sample: codes x pow2 scale is
                    # exact, and k-means wants real magnitudes
                    sample = sample.float() * s_smp[:, None]
                centroids_dev = kmeans_fit(sample, self._seed, nlist,
                                           self.train_iters,
                                           balance_weight=self.kmeans_balance)
                centroids = centroids_dev.cpu().numpy()

            with annotate("vdb/ivf.assign"):
                # -- balanced assignment (host logic, device scoring) --------
                cand = min(_CANDIDATE_CLUSTERS, nlist)
                chunk = max(256, min(1 << 16, (1 << 28) // max(nlist, 1)))
                use_hier = (self.assign_mode == "hier"
                            or (self.assign_mode == "auto"
                                and nlist >= self._HIER_AUTO_NLIST))
                if use_hier:
                    pref_all = assign_preferences_hier(
                        dev_db, centroids_dev, cand, chunk,
                        _hier_seed(self._seed), scales=dev_scales)
                else:
                    pref_all = assign_preferences(dev_db, centroids_dev, cand,
                                                  chunk, scales=dev_scales)
                pref = pref_all[live]
            with annotate("vdb/ivf.repack"):
                cap_rows = int(math.ceil(n / nlist * self.balance_slack))
                t_c = max(1, math.ceil(cap_rows / SUB))
                cap_rows = t_c * SUB
                # vectorized greedy balance: round r offers every unassigned
                # row its r-th preference; each cluster takes rows up to its
                # remaining capacity (grouped positional ranks via argsort)
                counts = np.zeros(nlist, dtype=np.int64)
                assign = np.full(n, -1, dtype=np.int64)
                for r in range(cand):
                    un = np.nonzero(assign < 0)[0]
                    if un.size == 0:
                        break
                    pc = pref[un, r]
                    order = np.argsort(pc, kind="stable")
                    rows_s, c_s = un[order], pc[order]
                    first = np.r_[True, c_s[1:] != c_s[:-1]]
                    grp_start = np.maximum.accumulate(
                        np.where(first, np.arange(c_s.size), 0))
                    pos = np.arange(c_s.size) - grp_start
                    take = pos < (cap_rows - counts[c_s])
                    assign[rows_s[take]] = c_s[take]
                    counts += np.bincount(c_s[take], minlength=nlist)
                # rows whose preferred clusters were all full go to the spill
                # region, which every search scans (recall-safe)
                spill_rows = np.nonzero(assign < 0)[0]

                s_t = max(2, math.ceil(n * self.spill_frac / SUB),
                          math.ceil(len(spill_rows) / SUB) + 1)

                # -- repack --------------------------------------------------
                new_cap = (nlist * t_c + s_t) * SUB
                nv = np.zeros((new_cap, d), np.float32)
                nvalid = np.zeros(new_cap, bool)
                nsq = np.zeros(new_cap, np.float32)
                nnorm = np.zeros(new_cap, np.float32)
                nids = np.full(new_cap, -1, np.int64)
                slot_cluster = np.full(new_cap, -1, np.int32)
                cluster_free: List[List[int]] = []
                new_slot = np.empty(n, dtype=np.int64)
                assigned = np.nonzero(assign >= 0)[0]
                order = np.argsort(assign[assigned], kind="stable")
                rows_s = assigned[order]
                c_s = assign[rows_s]
                first = np.r_[True, c_s[1:] != c_s[:-1]] if c_s.size else \
                    np.zeros(0, bool)
                grp_start = np.maximum.accumulate(
                    np.where(first, np.arange(c_s.size), 0)) if c_s.size else \
                    np.zeros(0, np.int64)
                rank = np.arange(c_s.size) - grp_start
                new_slot[rows_s] = c_s * (t_c * SUB) + rank
                fill = counts
                spill_base = nlist * t_c * SUB
                new_slot[spill_rows] = spill_base + np.arange(len(spill_rows))
                ns = new_slot
                nv[ns] = rows
                nvalid[ns] = True
                nsq[ns] = self._sq_norms[live]
                nnorm[ns] = self._norms[live]
                old_ids = self._id_of_slot[live]
                nids[ns] = old_ids
                for c in range(nlist):
                    base = c * t_c * SUB
                    slot_cluster[base:base + t_c * SUB] = c
                    cluster_free.append(
                        list(range(base + int(fill[c]), base + t_c * SUB)))
                slot_cluster[spill_base:] = nlist
                spill_free = list(range(spill_base + len(spill_rows), new_cap))

                self._vectors, self._valid = nv, nvalid
                self._sq_norms, self._norms = nsq, nnorm
                self._id_of_slot = nids
                self._slot_of_id = {int(old_ids[i]): int(ns[i])
                                    for i in range(n)}
                self._free_slots = []        # unused while trained
                self._capacity = new_cap
                self._device = None
                self._dirty_slots.clear()
                self._trained = True
                self._layout_version += 1   # slots reordered: slot-addressed
                self._nlist, self._t_c, self._s_t = nlist, t_c, s_t
                self._centroids = centroids
                self._centroids_dev = None
                self._cluster_free = cluster_free
                self._spill_free = spill_free
                self._slot_cluster = slot_cluster

    # -- mutation (post-training routing) ------------------------------------

    def _nearest_cluster(self, arr: np.ndarray) -> int:
        c = self._centroids
        return int(np.argmin(np.sum(c * c, axis=1) - 2.0 * (c @ arr)))

    def _ivf_release(self, slot: int) -> None:
        c = int(self._slot_cluster[slot])
        if c >= self._nlist:
            self._spill_free.append(slot)
        else:
            self._cluster_free[c].append(slot)

    def add(self, internal_id: int, vector: Vector) -> None:
        with self._lock:
            if not self._trained:
                super().add(internal_id, vector)
                return
            arr = as_f32_array(vector)
            if arr.shape[0] != self._dim:
                from ..errors import DimensionMismatchError
                raise DimensionMismatchError(self._dim, arr.shape[0])
            old = self._slot_of_id.get(internal_id)
            if old is not None:
                self._clear_slot(old)
                self._free_slots.clear()
                self._ivf_release(old)
            c = self._nearest_cluster(arr)
            if self._cluster_free[c]:
                slot = self._cluster_free[c].pop()
            elif self._spill_free:
                slot = self._spill_free.pop()
            else:
                # spill exhausted: retrain (rebuilds layout), then retry
                self.train()
                self.add(internal_id, vector)
                return
            self._write_slot(slot, internal_id, arr)

    def add_batch(self, items) -> None:
        """Bulk add. Untrained, the inherited packed bulk path; trained,
        every row takes cluster routing (FlatIndex.add_batch would place
        rows through the empty free-slot allocator, outside the trained
        layout)."""
        with self._lock:
            if not self._trained:
                super().add_batch(items)
                return
            for internal_id, vector in items:
                self.add(internal_id, vector)

    def bulk_append_matrix(self, ids, mat,
                           quantized: bool = False) -> None:
        """Untrained: the inherited packed fast path. Trained: every row
        takes cluster routing, one add a row (recovery of a trained
        layout goes through import_trained_state, not here)."""
        with self._lock:
            if not self._trained:
                super().bulk_append_matrix(ids, mat, quantized=quantized)
                return
            mat = np.ascontiguousarray(mat, dtype=np.float32)
            for j, internal_id in enumerate(np.asarray(ids, np.int64)):
                self.add(int(internal_id), mat[j])

    def remove(self, internal_id: int) -> None:
        with self._lock:
            if not self._trained:
                super().remove(internal_id)
                return
            slot = self._slot_of_id.get(internal_id)
            if slot is None:
                return
            self._clear_slot(slot)
            self._free_slots.clear()
            self._ivf_release(slot)

    # -- search --------------------------------------------------------------

    def search_batch_submit(self, queries: np.ndarray, k: int,
                            slot_mask: Optional[np.ndarray] = None,
                            mask_layout_version: Optional[int] = None):
        """The probed pipeline picks its probes on the device and ends in
        a top-k there, but its short queries re-run on the host's
        schedule, so the asynchronous contract is served eagerly: the
        search runs now and the handle is ready. (The inherited launcher
        would swap the probed lane for a full exact scan.)"""
        return SearchBatchHandle.ready(self._ivf_hits(
            queries, k, slot_mask, None, mask_layout_version))

    def search_batch(self, queries: np.ndarray, k: int,
                     slot_mask: Optional[np.ndarray] = None,
                     nprobe: Optional[int] = None,
                     mask_layout_version: Optional[int] = None
                     ) -> List[List[Tuple[int, float]]]:
        return self._ivf_hits(queries, k, slot_mask, nprobe,
                              mask_layout_version).rows()

    def _ivf_hits(self, queries: np.ndarray, k: int,
                  slot_mask: Optional[np.ndarray], nprobe: Optional[int],
                  mask_layout_version: Optional[int]) -> HitColumns:
        """``search_batch``'s hits: the probed search once trained, the
        exact scan before."""
        if slot_mask is not None:
            # exact filtered search through the probed path: the mask is
            # ANDed into the validity array. No auto-train here: the
            # caller compiled the mask against the current slot layout,
            # which a train would repack
            with self._lock:
                trained = self._trained
            if not trained:
                return self._exact_hits(queries, k, slot_mask,
                                        mask_layout_version)
            return self._probed_search(queries, k, nprobe, slot_mask,
                                       mask_layout_version)
        with self._lock:
            if not self._trained and self._len >= self.auto_train_min:
                self.train()
            trained = self._trained
        if not trained:
            return self._exact_hits(queries, k)
        return self._probed_search(queries, k, nprobe, None, None)

    def _probed_search(self, queries: np.ndarray, k: int,
                       nprobe: Optional[int],
                       slot_mask: Optional[np.ndarray],
                       mask_layout_version: Optional[int]) -> HitColumns:
        """Cluster-pruned search, masked or not. Each row stops at its
        first non-finite distance. Queries that come up short of k (sparse
        probed clusters, dead padding slots, or fewer than k eligible
        rows) re-run through the exact scan: the any-k contract and filter
        exactness are unconditional."""
        idx, dists, id_of_slot, k_req = self._probed_slots(
            queries, k, nprobe, slot_mask, mask_layout_version)
        queries = np.asarray(queries, dtype=np.float32)
        fb: dict = ({} if slot_mask is None else
                    {"slot_mask": slot_mask,
                     "mask_layout_version": mask_layout_version})
        if idx is None:
            if k_req is None:
                return HitColumns.from_rows([[]] * queries.shape[0])
            return self._exact_hits(queries, k, **fb)
        hits = HitColumns.cut(idx, dists, np.isfinite(dists), k_req,
                              id_of=id_of_slot)
        short = np.nonzero(hits.counts < k_req)[0]
        if short.size:
            hits = hits.put(short, self._exact_hits(
                np.ascontiguousarray(queries[short]), k, **fb))
        return hits

    def _probed_slots(self, queries, k: int, nprobe: Optional[int],
                      slot_mask, mask_layout_version):
        """The probed search's device half: (slots (Q, k) host int64,
        dists (Q, k) host f32, id_of_slot snapshot, k_req). (None, None,
        None, None) when there is nothing to search; (None, ..., k_req)
        when the pool cannot serve k (the caller takes the exact scan)."""
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
                return None, None, None, None
            if queries.shape[1] != self._dim:
                from ..errors import DimensionMismatchError
                raise DimensionMismatchError(self._dim, queries.shape[1])
            if self._metric is DistanceMetric.COSINE:
                # zero-vector semantics of the flat path
                from ..distance import validate_cosine_operands
                qn = np.sqrt(np.sum(queries * queries, axis=1))
                validate_cosine_operands(self._metric,
                                         float(qn.min(initial=np.inf)),
                                         self._zero_norm_live)
            np_eff = max(1, min(int(nprobe if nprobe is not None
                                    else self.nprobe), self._nlist))
            k_req = min(int(k), self._len)
            pool = np_eff * self._t_c * SUB
            if k_req > pool or pool > _MAX_CANDIDATES:
                # a pool smaller than k cannot honour the any-k contract;
                # one so large that its gather dwarfs a full scan
                return None, None, None, k_req
            dev = dict(self._sync_device())
            cap = self._capacity
            valid = dev["valid"][:cap]
            if slot_mask is not None:
                m = np.asarray(slot_mask, dtype=bool)
                if m.shape[0] < cap:
                    m = np.concatenate(
                        [m, np.zeros(cap - m.shape[0], bool)])
                valid = valid & self._to_device(m[:cap])
            if self._centroids_dev is None:
                self._centroids_dev = self._to_device(self._centroids)
            cdev = self._centroids_dev
            id_of_slot = self._id_of_slot.copy()
            t_c, s_t = self._t_c, self._s_t
            self._searches_in_flight += 1
        try:
            from ..ops.ivf import ivf_search
            from ..ops.topk import _queries_to
            scales = dev.get("scales")
            with annotate("vdb/ivf.probe"):
                dists, idx = ivf_search(
                    _queries_to(queries, valid.device), dev["db"][:cap],
                    dev["sq_norms"][:cap], dev["norms"][:cap], valid, cdev,
                    self._metric, k_req, np_eff, t_c, s_t,
                    scales=None if scales is None else scales[:cap])
                dists = dists.cpu().numpy()
                idx = idx.cpu().numpy()
        finally:
            with self._lock:
                self._searches_in_flight -= 1
        return idx, dists, id_of_slot, k_req

    # -- calibration ----------------------------------------------------------

    def calibrate_nprobe(self, target_recall: float, *, k: int = 10,
                         sample: int = 256,
                         candidates: Sequence[int] = (1, 2, 4, 8, 16, 32,
                                                      64),
                         queries: Optional[np.ndarray] = None,
                         set_default: bool = True, seed: int = 0) -> dict:
        """Pick the smallest nprobe whose measured recall@k meets
        ``target_recall``. Ground truth is this index's own exact scan
        over the trained layout; probe queries default to a random sample
        of stored rows (slightly optimistic: a row's own cluster always
        probes first). Returns ``{"nprobe", "recall", "curve"}``; when no
        candidate reaches the target, the largest with its recall.
        ``set_default`` installs the winner as the default nprobe."""
        if not 0.0 < float(target_recall) <= 1.0:
            raise IndexOpError("target_recall must be in (0, 1]")
        with self._lock:
            if not self._trained:
                if self._len < 32:
                    raise IndexOpError(
                        "calibrate_nprobe needs a trained index "
                        "(or >= 32 rows to train one)")
                self.train()
        if queries is None:
            rng = np.random.default_rng(seed)
            live = self._live_rows_snapshot()
            take = min(int(sample), len(live))
            queries = live[rng.choice(len(live), size=take, replace=False)]
        queries = np.ascontiguousarray(queries, dtype=np.float32)
        k_eff = min(int(k), self._len)
        truth = super().search_batch(queries, k_eff)   # exact scan
        truth_sets = [set(i for i, _ in row) for row in truth]
        curve: dict = {}
        chosen = None
        for cand in sorted(set(int(c) for c in candidates)):
            cand = min(cand, self._nlist) if self._nlist else cand
            if cand in curve:
                continue
            got = self._probed_search(queries, k_eff, cand, None, None).rows()
            hits = sum(len(ts & set(i for i, _ in row)) / max(len(ts), 1)
                       for ts, row in zip(truth_sets, got))
            curve[cand] = recall = hits / max(len(truth_sets), 1)
            if recall >= float(target_recall):
                chosen = cand
                break
        if chosen is None:
            chosen = max(curve)
        if set_default:
            self.nprobe = int(chosen)
        return {"nprobe": int(chosen), "recall": curve[chosen],
                "curve": curve}

    def _live_rows_snapshot(self) -> np.ndarray:
        """f32 matrix of the live stored rows: calibration's query pool."""
        with self._lock:
            slots = np.flatnonzero(self._valid[:self._capacity])
            return np.ascontiguousarray(self._vectors[slots],
                                        dtype=np.float32)

    # -- trained-state persistence (engine checkpoint/recovery) --------------

    def export_trained_state(self) -> Optional[dict]:
        """Everything needed to restore the trained layout without a
        retrain: centroids + the slot -> internal-id assignment (the rows
        live in the engine snapshot, keyed by internal id). None while
        untrained."""
        with self._lock:
            if not self._trained:
                return None
            return {
                "centroids": self._centroids.copy(),
                "id_of_slot": self._id_of_slot.copy(),
                "nlist": np.int64(self._nlist),
                "t_c": np.int64(self._t_c),
                "s_t": np.int64(self._s_t),
            }

    def import_trained_state(self, tables: dict,
                             rows_by_id: dict, dim: int) -> None:
        """Rebuild the trained layout from export_trained_state tables plus
        a {internal_id: f32 row} map of stored values. The caller
        guarantees the id sets match."""
        with self._lock:
            nlist = int(tables["nlist"])
            t_c = int(tables["t_c"])
            s_t = int(tables["s_t"])
            capacity = (nlist * t_c + s_t) * SUB
            id_of_slot = np.asarray(tables["id_of_slot"],
                                    dtype=np.int64).copy()
            if id_of_slot.shape[0] != capacity:
                raise IndexOpError("ivf state: id_of_slot/capacity mismatch")
            live = np.nonzero(id_of_slot >= 0)[0]
            nv = np.zeros((capacity, dim), np.float32)
            sq = np.zeros(capacity, np.float32)
            if live.size:
                # vectorized row assembly; squared norms per row by np.dot,
                # as the JAX package computes them here (a single
                # insert's sum): rows written by single inserts reopen
                # with their pre-crash distances bit for bit, rows loaded
                # in batches (einsum) move by f32 ulps (ROADMAP queue 3)
                packed = np.stack(
                    [rows_by_id[int(i)] for i in id_of_slot[live]])
                nv[live] = packed
                sq[live] = np.fromiter(
                    (np.dot(r, r) for r in packed), np.float32,
                    count=live.size)
            valid = np.zeros(capacity, bool)
            valid[live] = True
            spill_base = nlist * t_c * SUB
            slot_cluster = np.full(capacity, -1, np.int32)
            slot_cluster[:spill_base] = (
                np.arange(spill_base) // (t_c * SUB)).astype(np.int32)
            slot_cluster[spill_base:] = nlist
            free_c = np.nonzero(id_of_slot[:spill_base] < 0)[0]
            counts = np.bincount(free_c // (t_c * SUB), minlength=nlist)
            cluster_free = [s.tolist() for s in
                            np.split(free_c, np.cumsum(counts)[:-1])]
            spill_free = (spill_base
                          + np.nonzero(id_of_slot[spill_base:] < 0)[0]
                          ).tolist()

            self._dim = dim
            self._vectors, self._valid = nv, valid
            self._sq_norms = sq
            self._norms = np.sqrt(sq)
            self._id_of_slot = id_of_slot
            self._slot_of_id = {int(id_of_slot[s]): int(s) for s in live}
            self._free_slots = []
            self._capacity = capacity
            self._len = int(live.size)
            self._zero_norm_live = int((sq[live] == 0.0).sum())
            self._device = None
            self._dirty_slots.clear()
            self._trained = True
            self._layout_version += 1
            self._nlist, self._t_c, self._s_t = nlist, t_c, s_t
            self._centroids = np.asarray(tables["centroids"],
                                         np.float32).copy()
            self._centroids_dev = None
            self._cluster_free = cluster_free
            self._spill_free = spill_free
            self._slot_cluster = slot_cluster

    def search_with_nprobe(self, query: Vector, k: int,
                           nprobe: int) -> List[Tuple[int, float]]:
        """Per-call recall/latency knob (the IVF analogue of HNSW's
        search_with_ef), passed as an argument: mutating self.nprobe
        would race concurrent searches."""
        return self.search_batch(as_f32_array(query).reshape(1, -1), k,
                                 nprobe=int(nprobe))[0]


__all__ = ["IvfFlatIndex"]
