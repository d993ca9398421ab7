"""Bulk HNSW construction on the device, over the flat index's kernels.

Port of ``vectordb_tpu/index/hnsw_build_device.py``. The sequential build
(reference src/hnsw/graph.rs:245-342, Algorithm 1) inserts one node at a
time: per layer a beam search with ef_construction collects candidates,
the top-m are linked, overfull back-edge lists are pruned. That is a
pointer chase on the host (tens of seconds for 16384 rows on one thread).

This builder re-expresses construction as a batched array program:

* a beam search at insert time only approximates "the ef_construction
  nearest already-inserted nodes present at this layer". The flat index's
  certified exact search computes that set EXACTLY: blocks of new nodes
  are searched against the packed database masked to ``level >= layer AND
  slot < block_start`` (``ops.topk.flat_search_batched_submit``: kernels
  K1 + K2 on the card, K3 as tier 2). Links take only the top-m of those
  candidates (select_neighbors_simple, graph.rs:202-204), so the graph is
  the one Algorithm 1 would build with a perfect beam search;
* same-block causality (node i links only to j < i) comes from a second,
  causally masked pairwise pass over the block (``_causal_topk_fn``: one
  IEEE f32 product, the causal mask, exact top-k);
* back-edge linking with keep-closest pruning (graph.rs:207-242) is
  order-free set semantics, so a whole block of edges is applied at once
  with vectorized grouped merges; forward distances are remembered so
  pruning never recomputes a distance;
* levels are pre-sampled with the reference's geometric law
  floor(-ln(U) * ml) capped at max_layers-1 (graph.rs:119-123), from the
  same numpy generator as the JAX package, so they are bit-equal; the
  entry point is the first node to attain the global max level.

The block queries are rows of the resident database: they are sliced (or
gathered) on the device, never sent again from the host, and each block's
prefix mask is built on the device. Blocks alternate between two CUDA
streams, so block i+1's device work runs while the host links block i.
``VDB_TPU_BUILD_TIMING`` prints the set-up, the wait and the host time per
layer, as in the JAX package.

The output is the padded structure-of-arrays tables of
``export_padded_tables``; import them into a ``NativeHnswGraph`` or
``HnswGraph`` and every consumer (host traversal, device traversal,
checkpoints) works unchanged.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..distance import DistanceMetric, pairwise_distances
from ..errors import InvalidVectorError
from ..vector import as_f32_array
from .hnsw_graph import HnswParams

# below this many rows the batched machinery is pure overhead; the auto
# path takes the host build (HnswIndex.build_batch)
MIN_DEVICE_BUILD = 256
# rows per block: the block's queries go through one flat submit
_DEFAULT_BLOCK = 4096


def _causal_topk_fn(metric: DistanceMetric, k: int, block: int):
    """(B, d) rows -> top-k over the causally masked in-block pairwise
    distances: row i sees only columns j < i (insertion order). One IEEE
    f32 product (TF32 is off wherever an index builds device state)."""
    def fn(rows):
        d = pairwise_distances(rows, rows, metric)
        ar = torch.arange(block, device=rows.device)
        d = torch.where(ar[None, :] < ar[:, None], d, float("inf"))
        return torch.topk(d, k, dim=1, largest=False)

    return fn


def _merge_topk(d_a, i_a, d_b, i_b, k):
    """Row-wise merge of two candidate sets by (distance, id) — the
    neighbor_queue total order (reference neighbor_queue.rs:36-43).
    +inf distances are padding and sort to the tail."""
    cd = np.concatenate([d_a, d_b], axis=1)
    ci = np.concatenate([i_a, i_b], axis=1)
    o1 = np.argsort(ci, axis=1, kind="stable")
    d1 = np.take_along_axis(cd, o1, axis=1)
    o2 = np.argsort(d1, axis=1, kind="stable")
    order = np.take_along_axis(o1, o2, axis=1)[:, :k]
    return (np.take_along_axis(cd, order, axis=1),
            np.take_along_axis(ci, order, axis=1))


def _apply_back_edges(nbr_l: np.ndarray, aux_d: np.ndarray,
                      tgt: np.ndarray, src: np.ndarray, dist: np.ndarray,
                      cap_l: int) -> None:
    """Apply a block of back-edges (tgt gains src at distance dist) with
    keep-closest-cap_l pruning, vectorized over all targets.

    Matches reference prune semantics (graph.rs:207-242: re-score all,
    keep the closest max_degree) without recomputing distances — the
    table carries each neighbor's distance in ``aux_d``. Targets whose
    list has room just append; overfull targets get the sorted merge.
    """
    if tgt.size == 0:
        return
    # sort edges by (tgt, dist, src); per target only the closest cap_l
    # arrivals can survive the merge, so the rest go
    order = np.lexsort((src, dist, tgt))
    tgt_s, src_s, d_s = tgt[order], src[order], dist[order]
    uniq, start, counts = np.unique(tgt_s, return_index=True,
                                    return_counts=True)
    A = uniq.shape[0]
    grp = np.repeat(np.arange(A), counts)
    pos = np.arange(tgt_s.shape[0]) - np.repeat(start, counts)
    keep = pos < cap_l
    grp, pos, src_k, d_k = grp[keep], pos[keep], src_s[keep], d_s[keep]
    arr_counts = np.minimum(counts, cap_l)
    # neighbor lists are left-packed (-1 tail): the live count is a sum
    ex_counts = (nbr_l[uniq, :cap_l] >= 0).sum(axis=1)
    fits = ex_counts + arr_counts <= cap_l

    fit_e = fits[grp]
    if fit_e.any():
        rows = uniq[grp[fit_e]]
        cols = ex_counts[grp[fit_e]] + pos[fit_e]
        nbr_l[rows, cols] = src_k[fit_e].astype(np.int32)
        aux_d[rows, cols] = d_k[fit_e]

    ov = np.nonzero(~fits)[0]
    if ov.size == 0:
        return
    ov_set = np.zeros(A, bool)
    ov_set[ov] = True
    ov_e = ov_set[grp]
    remap = np.cumsum(ov_set) - 1
    g2 = remap[grp[ov_e]]
    a_max = int(arr_counts[ov].max())
    arr_id = np.full((ov.size, a_max), -1, dtype=np.int64)
    arr_d = np.full((ov.size, a_max), np.inf, dtype=np.float32)
    arr_id[g2, pos[ov_e]] = src_k[ov_e]
    arr_d[g2, pos[ov_e]] = d_k[ov_e]
    t_ov = uniq[ov]
    comb_d = np.concatenate([aux_d[t_ov, :cap_l], arr_d], axis=1)
    comb_i = np.concatenate([nbr_l[t_ov, :cap_l].astype(np.int64),
                             arr_id], axis=1)
    # one stable sort by distance: existing entries win f32 ties
    o = np.argsort(comb_d, axis=1, kind="stable")[:, :cap_l]
    nbr_l[t_ov, :cap_l] = np.take_along_axis(comb_i, o, 1).astype(np.int32)
    aux_d[t_ov, :cap_l] = np.take_along_axis(comb_d, o, 1)


def sample_levels(n: int, params: HnswParams,
                  rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Geometric level sampling, reference graph.rs:119-123."""
    if rng is None:
        rng = np.random.default_rng(params.seed)
    u = np.maximum(rng.random(n), 1e-12)
    lv = np.floor(-np.log(u) * params.ml).astype(np.int32)
    return np.minimum(lv, params.max_layers - 1)


def build_device_tables(ids: np.ndarray, data: np.ndarray,
                        metric: DistanceMetric, params: HnswParams,
                        block: int = _DEFAULT_BLOCK,
                        progress=None, device="cuda") -> dict:
    """Build HNSW padded tables for ``data`` (N, d) with internal ids
    ``ids`` (N,) by exact batched candidate generation on ``device``.

    Returns the ``export_padded_tables`` dict (slot i == insertion
    order i). ``progress``, if given, is called as progress(done, total)
    after each layer-0 block.
    """
    from ..ops.topk import flat_search_batched_submit, next_pow2
    from .flat import FlatIndex

    timing = bool(os.environ.get("VDB_TPU_BUILD_TIMING"))
    t_setup0 = time.perf_counter()

    data = np.ascontiguousarray(data, dtype=np.float32)
    n, dim = data.shape
    if n == 0:
        raise ValueError("device build requires at least one row")
    ids = np.ascontiguousarray(ids, dtype=np.int64)
    if ids.shape[0] != n:
        raise ValueError("ids/data length mismatch")
    sq = np.einsum("ij,ij->i", data, data).astype(np.float32)
    if metric is DistanceMetric.COSINE and n > 1 and np.any(sq == 0.0):
        # every row takes part in distance evaluations during
        # construction: the error the sequential insert raises
        raise InvalidVectorError(
            "Cannot compute cosine distance with zero vector")

    params = params or HnswParams()
    levels = sample_levels(n, params)
    max_level = int(levels.max())
    entry = int(np.argmax(levels == max_level))
    m = params.m
    m_max0 = params.m_max0

    nbr = np.full((n, params.max_layers, m_max0), -1, dtype=np.int32)
    aux_d = np.empty((n, m_max0), dtype=np.float32)

    # the packed flat database: slots 0..n-1 in insertion order (a fresh
    # bulk load keeps order), searched with a per-block prefix mask
    flat = FlatIndex(metric, device=device)
    flat.bulk_load_matrix(ids, data)
    with flat._lock:
        base_dev = dict(flat._sync_device())
    db_dev = base_dev["db"]
    dev = db_dev.device
    cap_flat = int(db_dev.shape[0])
    levels_padded = np.full(cap_flat, -1, dtype=np.int32)
    levels_padded[:n] = levels
    levels_dev = torch.from_numpy(levels_padded).to(dev)

    # pow2 block: device-resident query slices pass straight through
    block = next_pow2(max(64, int(block)))
    causal = _causal_topk_fn(metric, min(m, block), block)
    iota = torch.arange(cap_flat, dtype=torch.int32, device=dev)
    k_pre = min(m, n)
    # one-deep pipeline: blocks alternate between two streams, so the
    # copies that collect block i wait for block i's work only, while
    # block i+1's runs on the other stream
    if dev.type == "cuda":
        streams = [torch.cuda.Stream(dev), torch.cuda.Stream(dev)]
        for s in streams:
            s.wait_stream(torch.cuda.current_stream(dev))
    else:
        streams = [None, None]
    if timing:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        print(f"  [build-timing] setup {time.perf_counter() - t_setup0:.1f}s"
              f" (flat load + device sync)", flush=True)
    t_wait = t_host = 0.0
    n_blocks = 0

    for layer in range(max_level, -1, -1):
        members = np.nonzero(levels >= layer)[0]
        if members.size == 0:
            continue
        cap_l = params.max_degree(layer)
        aux_d.fill(np.inf)
        base_valid_l = base_dev["valid"] & (levels_dev >= layer)
        contiguous = members.size == n  # layer 0: members are all slots

        def submit(lo, _members=members, _base_valid=base_valid_l,
                   _contig=contiguous):
            nonlocal n_blocks
            blk = _members[lo: lo + block]
            b = blk.shape[0]
            stream = streams[n_blocks % 2]
            n_blocks += 1
            ctx = (torch.cuda.stream(stream) if stream is not None
                   else contextlib.nullcontext())
            with ctx:
                if _contig and lo + block <= n:
                    qdev = db_dev[lo: lo + block]
                else:
                    pad_idx = np.zeros(block, np.int64)
                    pad_idx[:b] = blk
                    qdev = db_dev[torch.from_numpy(pad_idx).to(dev)]
                state = dict(base_dev)
                state["valid"] = _base_valid & (iota < int(blk[0]))
                handle = flat_search_batched_submit(qdev, state, metric,
                                                    k_pre, mode="exact")
                cd_loc, ci_loc = causal(qdev)
            return blk, b, handle, cd_loc, ci_loc, stream

        def process(blk, b, handle, cd_loc, ci_loc, stream, _layer=layer,
                    _cap_l=cap_l):
            # (1) exact top-m among earlier members OUTSIDE the block
            pre_d, pre_i = handle.collect()
            # (2) exact top-m among earlier members INSIDE the block
            ctx = (torch.cuda.stream(stream) if stream is not None
                   else contextlib.nullcontext())
            with ctx:
                cd_loc = cd_loc.cpu().numpy()[:b]
                ci_loc = ci_loc.cpu().numpy()[:b]
            pre_d = np.asarray(pre_d)[:b, :k_pre]
            pre_i = np.asarray(pre_i)[:b, :k_pre].astype(np.int64)
            # masked-out rows come back as +inf / arbitrary index
            pre_i = np.where(np.isfinite(pre_d), pre_i, -1)
            loc_d = np.where(np.isfinite(cd_loc), cd_loc, np.inf)
            # top-k indices on +inf-masked (padded) columns are
            # arbitrary; clip before the gather, isfinite discards them
            loc_i = np.where(np.isfinite(cd_loc),
                             blk[np.minimum(ci_loc, b - 1)], -1)
            sel_d, sel_i = _merge_topk(pre_d, pre_i, loc_d, loc_i, m)
            valid_sel = np.isfinite(sel_d) & (sel_i >= 0)
            sel_i = np.where(valid_sel, sel_i, -1)
            sel_d = np.where(valid_sel, sel_d, np.inf)
            # (3) forward lists: node -> top-m (select_neighbors_simple)
            nbr[blk, _layer, :m] = sel_i.astype(np.int32)
            aux_d[blk, :m] = sel_d.astype(np.float32)
            # (4) back-edges with keep-closest pruning
            src = np.repeat(blk.astype(np.int64), m)
            flat_sel = sel_i.reshape(-1)
            flat_d = sel_d.reshape(-1).astype(np.float32)
            live = flat_sel >= 0
            _apply_back_edges(nbr[:, _layer, :], aux_d,
                              flat_sel[live], src[live], flat_d[live],
                              _cap_l)

        done = 0
        t_layer0 = time.perf_counter()
        pending = submit(0)
        for lo in range(block, members.size + block, block):
            nxt = submit(lo) if lo < members.size else None
            if timing:
                t0 = time.perf_counter()
                pending[2].collect()
                if pending[5] is not None:
                    pending[5].synchronize()
                t1 = time.perf_counter()
                process(*pending)
                t2 = time.perf_counter()
                t_wait += t1 - t0
                t_host += t2 - t1
            else:
                process(*pending)
            done += pending[1]
            if progress is not None and layer == 0:
                progress(done, n)
            pending = nxt
        if timing:
            print(f"  [build-timing] layer {layer}: "
                  f"{time.perf_counter() - t_layer0:.1f}s "
                  f"(cum wait {t_wait:.1f}s, host {t_host:.1f}s)",
                  flush=True)

    if dev.type == "cuda":
        for s in streams:
            torch.cuda.current_stream(dev).wait_stream(s)
    return {
        "vectors": data,
        "norms": np.sqrt(sq),
        "neighbors": nbr,
        "levels": levels,
        "valid": np.ones(n, dtype=bool),
        "id_of_slot": ids,
        "entry": entry,
        "max_level": max_level,
    }


def build_graph_device(items: Sequence, metric: DistanceMetric,
                       params: Optional[HnswParams] = None,
                       block: int = _DEFAULT_BLOCK, native: bool = True,
                       progress=None, device="cuda"):
    """Build a ready-to-search HNSW graph from (internal_id, vector)
    pairs with the device bulk builder. Returns a ``NativeHnswGraph`` (or
    the pure-Python graph when the C++ core is unavailable or
    ``native=False``)."""
    params = params or HnswParams()
    ids = np.fromiter((int(i) for i, _ in items), dtype=np.int64,
                      count=len(items))
    if np.unique(ids).size != ids.size:
        raise ValueError("duplicate internal ids in device build")
    data = np.stack([as_f32_array(v).reshape(-1) for _, v in items])
    tables = build_device_tables(ids, data, metric, params, block=block,
                                 progress=progress, device=device)
    graph = None
    if native:
        from .hnsw_native import NativeHnswGraph, native_available
        if native_available():
            graph = NativeHnswGraph(metric, params)
    if graph is None:
        from .hnsw_graph import HnswGraph
        graph = HnswGraph(metric, params)
    graph.import_padded_tables(tables)
    return graph


__all__ = ["build_device_tables", "build_graph_device", "sample_levels",
           "MIN_DEVICE_BUILD"]
