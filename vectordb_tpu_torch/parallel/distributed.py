"""Sharded flat scan with a distributed top-k merge.

Port of ``vectordb_tpu/parallel/distributed.py``. The database's row axis
is sharded over the mesh; queries are replicated (or split over an
optional batch axis). Each shard runs the single-device pipeline over its
row block on its own device and reduces it to a local top-k; only (k
distances, k global row ids) per shard leave it, and the merge is one
exact top-k over the S*k candidates on the mesh's first device.

The JAX package runs every shard under ``jax.shard_map`` inside one
``jit``. Here one process holds one tensor per shard, on that shard's
device (a sharded array is a list of S tensors, shard ``s`` owning rows
``[s*B, (s+1)*B)``), and a search:
  * launches every shard's work first, each under ``torch.cuda.device``
    of its shard on that device's current stream;
  * then copies the candidates, ids and flags to the first device,
    after an event recorded on each other device's stream that the first
    device's stream waits on;
  * then merges; the caller syncs once, when it reads the result.
On a mesh that repeats a device every shard runs on one stream, in
order, and the copies are no-ops.

Ties: ``torch.topk`` makes no promise of order among equal values
(``lax.top_k`` keeps the lower index). The merge is sound under any tie
order: every shard's k best are in the pool.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..distance import DistanceMetric
from ..errors import DimensionMismatchError
from ..ops.topk import (_queries_to, flat_search, flat_search_bf16,
                        flat_search_int8, next_pow2)


def _device_ctx(dev: torch.device):
    """Make ``dev`` current while its shard's work is launched."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def _on(x, dev: torch.device):
    """``x`` on ``dev``: a replicated table (a dict by device) gives its
    copy there, a tensor elsewhere is copied, a number passes."""
    if isinstance(x, dict):
        return x[dev]
    if isinstance(x, torch.Tensor) and x.device != dev:
        return x.to(dev, non_blocking=True)
    return x


def replicate(arr, devices) -> dict:
    """A small table (codebook, rotation) placed once on each distinct
    device of ``devices``: {device: tensor}."""
    src = torch.as_tensor(np.ascontiguousarray(arr))
    return {dev: src.to(dev, copy=True) for dev in dict.fromkeys(devices)}


def _gather(parts: List[torch.Tensor], dev0: torch.device):
    """The shards' outputs on ``dev0``. An output on another card is
    copied after an event recorded on its device's current stream, which
    ``dev0``'s current stream waits on, so no host sync is needed."""
    out = []
    for t in parts:
        if t.device != dev0:
            if t.is_cuda and dev0.type == "cuda":
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(t.device))
                torch.cuda.current_stream(dev0).wait_event(ev)
            with _device_ctx(dev0):
                t = t.to(dev0, non_blocking=True)
        out.append(t)
    return out


def _merge(vals: List[torch.Tensor], idx: List[torch.Tensor], k: int):
    """One exact top-k over the (Q, S*k_local) pool, shard-major as the
    JAX package lays it out."""
    flat_v = torch.cat(vals, dim=1)
    flat_i = torch.cat(idx, dim=1)
    k_final = min(k, flat_v.shape[1])
    v, pos = torch.topk(flat_v, k_final, dim=1, largest=False)
    return v, torch.gather(flat_i, 1, pos)


class _Cells:
    """The (row shard, batch block) cells of one search: their devices,
    each block's queries on each device, and the first device."""

    def __init__(self, mesh, row_axis: str, batch_axis: Optional[str],
                 queries):
        self.n_shards = mesh.shape[row_axis]
        self.n_blocks = mesh.shape[batch_axis] if batch_axis else 1
        self.dev = [[mesh.cell_device(row_axis, s, batch_axis, b)
                     for s in range(self.n_shards)]
                    for b in range(self.n_blocks)]
        self.dev0 = self.dev[0][0]
        q = queries.shape[0]
        if q % self.n_blocks:
            raise ValueError(f"{q} queries do not split over "
                             f"{self.n_blocks} batch blocks")
        step = q // self.n_blocks
        self._blocks = [queries[b * step:(b + 1) * step]
                        for b in range(self.n_blocks)]
        self._placed: dict = {}

    def queries(self, b: int, dev: torch.device) -> torch.Tensor:
        key = (b, dev)
        if key not in self._placed:
            self._placed[key] = _queries_to(self._blocks[b], dev)
        return self._placed[key]


def shard_rows(mesh, row_axis: str, *arrays, block_multiple: int = 1):
    """Pad the leading (row) axis to a multiple of the shard count (and of
    ``block_multiple`` rows per shard) and place each array's row blocks
    on the devices along ``row_axis``.

    Returns (padded_rows, sharded_arrays...), each sharded array a list of
    S tensors. Boolean arrays pad with False (so padding rows never
    match), numeric arrays pad with zeros. ``arrays`` are numpy arrays or
    CPU tensors (a bf16 tensor for bf16 rows). ``block_multiple=1024``
    makes every shard block whole super-tiles for the coarse kernels."""
    n_shards = mesh.shape[row_axis]
    devices = mesh.axis_devices(row_axis)
    n = arrays[0].shape[0]
    per_shard = (n + n_shards - 1) // n_shards
    per_shard = ((per_shard + block_multiple - 1)
                 // block_multiple) * block_multiple
    per_shard = max(per_shard, block_multiple)
    padded = per_shard * n_shards
    out = []
    for arr in arrays:
        if arr.shape[0] != n:
            raise ValueError("all arrays must share the row count")
        t = torch.as_tensor(arr)
        if padded != n:
            t = torch.cat([t, torch.zeros((padded - n,) + tuple(t.shape[1:]),
                                          dtype=t.dtype)])
        out.append([t[s * per_shard:(s + 1) * per_shard].to(dev, copy=True)
                    for s, dev in enumerate(devices)])
    return (padded, *out)


def make_sharded_search(mesh, metric: DistanceMetric, k: int,
                        block_rows: int, row_axis: str = "shard",
                        batch_axis: Optional[str] = None,
                        src: str = "f32"):
    """The distributed exact search for one mesh / shape.

    Returns fn(queries, db, sq_norms, norms, valid) -> (dists (Q,k),
    global row indices (Q,k)) tensors on the first device, ascending,
    +inf where fewer than k live rows. ``db`` and the row vectors are
    lists of per-shard tensors; ``block_rows`` is the rows per shard.
    Each shard runs the f32 scan at IEEE precision (never TF32) masked
    by ``valid``, then ``torch.topk``: bf16 rows widen exactly, and with
    ``src="int8"`` fn takes a trailing per-shard ``scales`` list and each
    shard dequantizes its block exactly (code x pow2 scale). This is the
    JAX package's XLA route: a plain matrix product, no kernel."""
    k_local = min(k, block_rows)

    def local_scan(q, db, sq, nrm, vld, scales=None):
        if scales is not None:
            return flat_search_int8(q, db, scales, sq, nrm, vld, metric,
                                    k_local)
        if db.dtype == torch.bfloat16:
            return flat_search_bf16(q, db, sq, nrm, vld, metric, k_local)
        return flat_search(q, db, sq, nrm, vld, metric, k_local)

    def search(queries, db, sq_norms, norms, valid, *rest):
        cells = _Cells(mesh, row_axis, batch_axis, queries)
        scales = rest[0] if src == "int8" else None
        outs = []
        for b in range(cells.n_blocks):
            vals, ids = [], []
            for s in range(cells.n_shards):
                dev = cells.dev[b][s]
                with _device_ctx(dev):
                    v, i = local_scan(
                        cells.queries(b, dev), _on(db[s], dev),
                        _on(sq_norms[s], dev), _on(norms[s], dev),
                        _on(valid[s], dev),
                        None if scales is None else _on(scales[s], dev))
                    vals.append(v)
                    ids.append(i + s * block_rows)
            outs.append(_merge(_gather(vals, cells.dev0),
                               _gather(ids, cells.dev0), k))
        return (torch.cat([o[0] for o in outs]),
                torch.cat([o[1] for o in outs]))

    return search


def make_sharded_search_coarse(mesh, metric: DistanceMetric, k: int,
                               block_rows: int, row_axis: str = "shard",
                               interpret: bool = False,
                               batch_axis: Optional[str] = None,
                               src: str = "f32"):
    """Sharded search through the 1-pass certified coarse pipeline.

    Each shard runs ops/coarse_kernel.coarse_search_1p over its row block
    with its own margin from its own row norms: ``src="f32"`` K4 over the
    f32 rows (no mirrors), ``"bf16"`` K1 over the stored bf16 block (its
    own hi mirror, elo_max 0), ``"int8"`` K7 over the codes (fn takes a
    trailing per-shard ``scales`` list); K2 refines every shard. The
    pool is ``_exact1p_pool(k_local, block_rows // SUB)``. The merged
    global k-th distance is <= every shard's local k-th, so if every shard
    certifies, no unrefined row anywhere can enter the top-k: the global
    certificate is the AND of the shard certificates. ``elo_max`` is the
    global residual bound (stale-high-safe).

    ``interpret`` has no counterpart (a CPU tensor runs the plain kernel
    versions) and is kept for the JAX package's positional order. With
    ``batch_axis``, each (row, batch) cell runs on its block of queries.

    Returns fn(queries, db, sq, norms, valid, elo_max[, scales]) ->
    (dists (Q,k), global idx (Q,k), certified (Q,)) tensors on the first
    device. Uncertified queries must be re-run by the caller through the
    sharded exact scan."""
    from ..ops import coarse_kernel as ck

    k_local = min(k, block_rows)

    def search(queries, db, sq_norms, norms, valid, elo_max, *rest):
        cells = _Cells(mesh, row_axis, batch_axis, queries)
        scales = rest[0] if src == "int8" else None
        outs = []
        for b in range(cells.n_blocks):
            vals, ids, certs = [], [], []
            for s in range(cells.n_shards):
                dev = cells.dev[b][s]
                with _device_ctx(dev):
                    d_, i_, c_ = ck.coarse_search_1p(
                        cells.queries(b, dev), _on(db[s], dev),
                        _on(sq_norms[s], dev), _on(norms[s], dev),
                        _on(valid[s], dev), None, _on(elo_max, dev),
                        metric, k_local,
                        scales=None if scales is None else _on(scales[s],
                                                               dev))
                    vals.append(d_)
                    ids.append(i_ + s * block_rows)
                    certs.append(c_)
            v, i = _merge(_gather(vals, cells.dev0),
                          _gather(ids, cells.dev0), k)
            cert = torch.stack(_gather(certs, cells.dev0)).all(dim=0)
            outs.append((v, i, cert))
        return tuple(torch.cat([o[j] for o in outs]) for j in range(3))

    return search


def make_sharded_pq_scan(mesh, metric: DistanceMetric, r: int,
                         chunk: int, block_rows: int,
                         row_axis: str = "shard",
                         recall_target: float = 0.85,
                         with_rot: bool = False):
    """Sharded streaming PQ scan: each shard runs ops/pq.pq_scan_topr
    (kernel K8 for every chunk) over its block of codes and emits its
    local top-r candidate rows; the merge is one exact top-r over the
    S*r pool. The scores' dropped per-query constants are the same on
    every shard, so cross-shard comparison is sound; the index's exact
    re-rank fixes ordering and distances.

    ``recall_target`` has no counterpart (selection is exact) and is kept
    for the JAX package's order. Returns fn(queries, codes, cb_bf, cnorm,
    valid[, rot]) -> (scores (Q, r) ascending, global slots (Q, r) int64)
    on the first device; ``codes`` and ``valid`` are per-shard lists, the
    tables a tensor or a {device: tensor} replica map."""
    from ..ops.pq import pq_scan_topr

    if block_rows % chunk:
        raise ValueError(f"block_rows {block_rows} not a multiple of "
                         f"chunk {chunk}")
    if r > chunk:
        raise ValueError(f"r={r} exceeds per-shard scan chunk {chunk}")

    def scan(queries, codes, cb_bf, cnorm, valid, *rot):
        cells = _Cells(mesh, row_axis, None, queries)
        vals, ids = [], []
        for s in range(cells.n_shards):
            dev = cells.dev[0][s]
            with _device_ctx(dev):
                sv, sl = pq_scan_topr(
                    cells.queries(0, dev), _on(codes[s], dev),
                    _on(cb_bf, dev), _on(cnorm, dev), _on(valid[s], dev),
                    metric, r=r, chunk=chunk,
                    rot=_on(rot[0], dev) if rot else None)
                vals.append(sv)
                ids.append(sl + s * block_rows)
        return _merge(_gather(vals, cells.dev0), _gather(ids, cells.dev0),
                      r)

    return scan


def sharded_coarse_supported(block_rows: int, d: int, k: int,
                             src: str = "f32") -> bool:
    from ..ops import coarse_kernel as ck
    if src == "int8":
        return ck.supports_1p_int8(block_rows, d, min(k, block_rows))
    return ck.supports_1p(block_rows, d, min(k, block_rows))


def _pad_rows(queries: np.ndarray, q_to: int) -> np.ndarray:
    q = queries.shape[0]
    if q_to == q:
        return queries
    return np.concatenate([queries, np.zeros((q_to - q, queries.shape[1]),
                                             np.float32)])


class DistributedFlatIndex:
    """A bulk-loaded, mesh-sharded exact index for large-scale serving:
    load N vectors once (sharded over the mesh), then serve batched exact
    k-NN with the distributed top-k. Row ids are positions.

    ``storage`` "bf16" rounds rows to bf16 at load (half the bytes per
    shard), "int8" to per-row pow2-scaled codes (a quarter); search is
    certified-exact over the stored values either way."""

    def __init__(self, mesh, metric: DistanceMetric,
                 row_axis: str = "shard", batch_axis: Optional[str] = None,
                 storage: str = "f32"):
        if storage not in ("f32", "bf16", "int8"):
            raise ValueError(f"unknown storage: {storage!r}")
        self.mesh = mesh
        self.metric = metric
        self.row_axis = row_axis
        self.batch_axis = batch_axis
        self.storage = storage
        self._n = 0
        self._dim: Optional[int] = None
        self._block_rows = 0
        self._device = None
        self._scales = None
        self._elo_max = None
        self._search_cache: dict = {}

    def load(self, vectors: np.ndarray) -> None:
        """Bulk-load N x d rows, sharding the row axis over the mesh."""
        from ..index.flat import (_bf16_bits, _int8_codes_scales,
                                  _quantize_bf16, _quantize_int8)
        from ..ops.coarse_kernel import residual_max_norm_f32
        vectors = np.asarray(vectors, dtype=np.float32)
        n, d = vectors.shape
        scales = None
        if self.storage == "bf16":
            stored = _quantize_bf16(vectors)   # norms see stored values
            rows = torch.from_numpy(_bf16_bits(vectors).view(np.int16)
                                    ).view(torch.bfloat16)
        elif self.storage == "int8":
            stored = _quantize_int8(vectors)
            rows, scales = _int8_codes_scales(stored)
        else:
            stored = rows = vectors
        sq = np.einsum("ij,ij->i", stored, stored).astype(np.float32)
        norms = np.sqrt(sq)
        valid = np.ones(n, dtype=bool)
        arrays = (rows, sq, norms, valid)
        if scales is not None:
            arrays = arrays + (scales,)
        # every shard block is whole super-tiles: the coarse route serves
        # on every device (the kernels, or their plain versions on a CPU)
        padded, db, sqs, nrm, vld, *rest = shard_rows(
            self.mesh, self.row_axis, *arrays, block_multiple=1024)
        self._n, self._dim = n, d
        self._block_rows = padded // self.mesh.shape[self.row_axis]
        self._device = (db, sqs, nrm, vld)
        # zero padding scales are safe: scales only multiply codes, and
        # padded slots are invalid with all-zero codes
        self._scales = rest[0] if rest else None
        if self.storage in ("bf16", "int8"):
            self._elo_max = torch.zeros((), dtype=torch.float32,
                                        device=db[0].device)
        else:
            # global residual bound; every shard's margin uses its own
            # norms but shares this (stale-high-safe) maximum
            self._elo_max = torch.stack(_gather(
                [residual_max_norm_f32(t) for t in db], db[0].device)).max()
        self._search_cache.clear()

    @property
    def num_rows(self) -> int:
        return self._n

    def _src(self) -> str:
        return self.storage if self.storage in ("bf16", "int8") else "f32"

    def _searcher(self, k: int):
        key = int(k)
        fn = self._search_cache.get(key)
        if fn is None:
            fn = make_sharded_search(
                self.mesh, self.metric, k, self._block_rows,
                self.row_axis, self.batch_axis,
                src="int8" if self.storage == "int8" else "f32")
            self._search_cache[key] = fn
        return fn

    def _coarse_searcher(self, k: int):
        key = ("coarse", int(k))
        fn = self._search_cache.get(key)
        if fn is None:
            fn = make_sharded_search_coarse(
                self.mesh, self.metric, int(k), self._block_rows,
                self.row_axis, batch_axis=self.batch_axis, src=self._src())
            self._search_cache[key] = fn
        return fn

    def search_batch(self, queries: np.ndarray,
                     k: int) -> List[List[Tuple[int, float]]]:
        """Exact k-NN for Q queries; returns (row_id, distance) ascending."""
        if self._device is None:
            return [[] for _ in range(len(queries))]
        queries = np.asarray(queries, dtype=np.float32)
        if queries.ndim != 2 or queries.shape[1] != self._dim:
            raise DimensionMismatchError(
                self._dim or 0,
                queries.shape[1] if queries.ndim == 2 else 0)
        # pad Q so a batch axis always divides evenly
        q = queries.shape[0]
        q_mult = self.mesh.shape[self.batch_axis] if self.batch_axis else 1
        queries = _pad_rows(queries, max(-(-q // q_mult) * q_mult, q_mult))

        k_true = min(int(k), max(self._n, 1))
        use_coarse = (self._elo_max is not None
                      # a pow2 batch-block count keeps the pow2-padded Q
                      # evenly divisible over the batch axis
                      and (q_mult & (q_mult - 1)) == 0
                      and sharded_coarse_supported(self._block_rows,
                                                   self._dim, k_true,
                                                   self._src()))
        if use_coarse:
            # pow2-pad Q, as the JAX package does (its jit signatures)
            cq = _pad_rows(queries, next_pow2(queries.shape[0], floor=1))
            extra = (self._scales,) if self._scales is not None else ()
            out = self._coarse_searcher(k_true)(cq, *self._device,
                                                self._elo_max, *extra)
            dists, idx, cert = (t.cpu().numpy()[:q] for t in out)
            bad = np.nonzero(~cert)[0]
            if bad.size:
                # rare: re-run uncertified queries through the exact scan
                sub_d, sub_i = self._search_xla(
                    np.ascontiguousarray(queries[bad]), k_true)
                dists = dists.copy()
                idx = idx.copy()
                dists[bad] = sub_d[:, : dists.shape[1]]
                idx[bad] = sub_i[:, : idx.shape[1]]
        else:
            dists, idx = self._search_xla(queries, k_true)
            dists, idx = dists[:q], idx[:q]

        out: List[List[Tuple[int, float]]] = []
        for qi in range(min(q, dists.shape[0])):
            row = []
            for j in range(dists.shape[1]):
                dist = float(dists[qi, j])
                if not np.isfinite(dist) or len(row) >= k:
                    break
                row.append((int(idx[qi, j]), dist))
            out.append(row)
        return out

    def _search_xla(self, queries: np.ndarray, k: int):
        """The sharded exact scan (the JAX package's XLA route)."""
        k_eff = min(next_pow2(k), max(self._n, 1))
        # a batch axis needs Q divisible by its block count: pad here so
        # the uncertified-query fallback (an arbitrary subset) divides
        q = queries.shape[0]
        q_mult = self.mesh.shape[self.batch_axis] if self.batch_axis else 1
        queries = _pad_rows(queries, max(-(-q // q_mult) * q_mult, q_mult))
        extra = (self._scales,) if self._scales is not None else ()
        dists, idx = self._searcher(k_eff)(queries, *self._device, *extra)
        return dists.cpu().numpy()[:q], idx.cpu().numpy()[:q]


__all__ = ["shard_rows", "make_sharded_search", "make_sharded_search_coarse",
           "make_sharded_pq_scan", "sharded_coarse_supported", "replicate",
           "DistributedFlatIndex"]
