"""Device-side IVF-Flat primitives: k-means training and cluster-pruned
search.

Port of ``vectordb_tpu/ops/ivf.py``. Training is Lloyd iterations (each a
(rows, d) x (d, nlist) product and a grouped sum) and a preference list of
the ``cand`` nearest centroids per row, flat or through a two-level
hierarchy of super-centroids. Search probes each query's nprobe nearest
clusters and refines their rows exactly in f32: returned distances are
exact, and recall depends only on which clusters are probed.

Every large matrix product here is an IEEE f32 ``torch.matmul`` (TF32 is
off wherever an index builds its device state; the JAX package computes
these products in XLA, outside Pallas), and every top-k is exact
``torch.topk``. The probed refine is the flat index's kernel K2
(``coarse_kernel._refine_dots``: ``cuda_kernels.refine_dots`` on the card,
its plain version on the CPU), since its shape is K2's: per query, lists
of 16-row tiles. The spill region, the same rows for every query, is one
shared (Q, spill_rows) product merged into each query's top-k.

Layout contract (built by index/ivf.py): the packed database is reordered
so cluster c owns tiles [c*T_c, (c+1)*T_c) of SUB rows each (every cluster
padded to the same tile count with dead slots), plus a shared spill
region of S_t tiles at the end that every search scans.

``key`` arguments are a ``torch.Generator`` or an int seed: the JAX
package's ``jax.random`` streams cannot be reproduced, so the two packages
train different centroids from one seed (parity tests carry the JAX
package's trained state across).
"""

from __future__ import annotations

import numpy as np
import torch

from ..distance import DistanceMetric
from . import coarse_kernel
from .coarse_kernel import SUB
from .topk import next_pow2

# Peak refine-gather bytes per query chunk of the probed refine (the JAX
# package's budget; the plain K2 gathers them, the kernel reads tiles in
# place)
_REFINE_BYTES = int(2.5e9)
# Max elements of one (rows, nlist) score block in training: the products
# are cut into row chunks of this size (1 GiB of f32)
_SCORE_ELEMS = 1 << 28

_HIER_N_SUPER = 256
_HIER_S_TOP = 12


def _generator(key) -> torch.Generator:
    if isinstance(key, torch.Generator):
        return key
    return torch.Generator().manual_seed(int(key))


def _row_chunks(s: int, width: int):
    step = max(1, _SCORE_ELEMS // max(width, 1))
    return [(a, min(a + step, s)) for a in range(0, s, step)]


def kmeans_fit(data, key, nlist: int, iters: int,
               balance_weight: float = 0.0, init=None):
    """Lloyd's k-means on the device. data (S, d) -> centroids (nlist, d)
    f32.

    Init: ``nlist`` distinct rows drawn by ``key`` (``init``, the port's
    own parameter, gives the initial centroids instead: the parity tests
    start both packages from the same ones). Each iteration assigns every
    row to its nearest centroid (argmin of -2 x.c + |c|^2) and moves each
    centroid to the mean of its rows; an empty cluster keeps its
    centroid. ``balance_weight`` > 0 adds ``weight * var(data) *
    prev_count / target`` to each cluster's score (size-penalized Lloyd,
    as the JAX package; it shapes the centroids only)."""
    data = data.float()
    s, d = data.shape
    dev = data.device
    if init is None:
        idx = torch.randperm(s, generator=_generator(key))[:nlist]
        centroids = data[idx.to(dev)]
    else:
        centroids = torch.as_tensor(init, dtype=torch.float32,
                                    device=dev).clone()
    chunks = _row_chunks(s, nlist)
    target = s / nlist
    if balance_weight:
        mu = data.mean(dim=0)
        scale = ((data - mu[None, :]) ** 2).sum(dim=1).mean()
        counts = torch.full((nlist,), target, dtype=torch.float32,
                            device=dev)
    for _ in range(iters):
        c_sq = (centroids * centroids).sum(dim=1)
        pen = ((balance_weight * scale) * (counts / target)
               if balance_weight else None)
        assign = torch.empty(s, dtype=torch.long, device=dev)
        for a, b in chunks:
            scores = (data[a:b] @ centroids.T) * -2.0 + c_sq[None, :]
            if pen is not None:
                scores = scores + pen[None, :]
            assign[a:b] = scores.argmin(dim=1)
        sums = torch.zeros((nlist, d), dtype=torch.float32, device=dev)
        sums.index_add_(0, assign, data)
        cnt = torch.bincount(assign, minlength=nlist).float()
        new = sums / torch.clamp(cnt, min=1.0)[:, None]
        centroids = torch.where(cnt[:, None] > 0.0, new, centroids)
        if balance_weight:
            counts = cnt
    return centroids


def kmeans_assign_scores(data, centroids, scales=None):
    """(S, nlist) anti-affinity scores (-2 x.c + |c|^2): a row's argmin is
    its nearest centroid. ``scales`` (int8 storage): per-row pow2 scales
    applied to the finished dots of the raw codes (exact)."""
    c_sq = (centroids * centroids).sum(dim=1)
    dots = data.float() @ centroids.T
    if scales is not None:
        dots = dots * scales[:, None]
    return dots * -2.0 + c_sq[None, :]


def _assign_topk_chunk(blk, centroids, cand: int, s_blk=None):
    scores = kmeans_assign_scores(blk, centroids, s_blk)
    return torch.topk(scores, cand, dim=1, largest=False)[1].to(
        torch.int32)


def kmeans_assign_topk_all(db, centroids, cand: int, chunk: int,
                           scales=None):
    """(cap, cand) int32 preference lists (the cand nearest centroids,
    nearest first) for every row of a device-resident database, in row
    chunks of ``chunk``, kept on the device."""
    cap = db.shape[0]
    out = torch.empty((cap, cand), dtype=torch.int32, device=db.device)
    for lo in range(0, cap, chunk):
        out[lo:lo + chunk] = _assign_topk_chunk(
            db[lo:lo + chunk], centroids, cand,
            None if scales is None else scales[lo:lo + chunk])
    return out


def assign_preferences(db, centroids, cand: int, chunk: int, scales=None):
    """Preference lists for every slot, as host numpy (cap, cand) int32."""
    return kmeans_assign_topk_all(db, centroids, cand, chunk,
                                  scales).cpu().numpy()


# -- two-level (hierarchical) assignment ------------------------------------
#
# Flat assignment scores every row against every centroid: N x nlist x d
# flops, the dominant training cost at large N x nlist. The two-level
# scheme clusters the centroids into n_super supers, routes each row to its
# nearest super (N x n_super), then scores the row only against the fine
# centroids of its super's s_top nearest supers. A row whose true nearest
# centroid lies outside that neighbourhood gets a slightly farther cluster
# (the error class the balanced placement already has); search still
# scores all centroids exactly.

def _score_vs_subset(rows, cents_sub, col_valid, cand: int, s_rows=None):
    """top-cand of rows (R, d) against a gathered centroid subset
    (nb, d); masked columns excluded. Returns LOCAL indices."""
    c_sq = (cents_sub * cents_sub).sum(dim=1)
    dots = rows.float() @ cents_sub.T
    if s_rows is not None:
        dots = dots * s_rows[:, None]
    scores = dots * -2.0 + c_sq[None, :]
    scores = torch.where(col_valid[None, :], scores, float("inf"))
    return torch.topk(scores, cand, dim=1, largest=False)[1]


def _top1_super(rows, supers, s_rows=None):
    s_sq = (supers * supers).sum(dim=1)
    dots = rows.float() @ supers.T
    if s_rows is not None:
        dots = dots * s_rows[:, None]
    scores = dots * -2.0 + s_sq[None, :]
    return scores.argmin(dim=1).to(torch.int32)


def assign_preferences_hier(db, centroids, cand: int, chunk: int,
                            key, n_super: int = 0,
                            s_top: int = _HIER_S_TOP,
                            iters: int = 8, scales=None):
    """Two-level preference lists (global centroid ids, (cap, cand) int32
    host numpy). ``n_super=0`` scales the super count with nlist; a
    hierarchy too small to pay takes the flat path."""
    cap = db.shape[0]
    nlist = centroids.shape[0]
    dev = db.device
    if not n_super:
        n_super = min(_HIER_N_SUPER, max(2, nlist // 16))
    s_top = min(s_top, n_super)
    if nlist < 4 * n_super or nlist < 4 * cand:
        return assign_preferences(db, centroids, cand, chunk, scales)

    # 1. supers = k-means over the fine centroids (tiny: nlist x d)
    supers = kmeans_fit(centroids, key, n_super, iters)

    # 2. host grouping of fine centroids by nearest super
    c2s = _top1_super(centroids, supers).cpu().numpy()
    members = [np.nonzero(c2s == s)[0] for s in range(n_super)]

    # 3. super neighbourhoods: s_top nearest supers per super (incl. self)
    sup_np = supers.cpu().numpy()
    ss = np.einsum("ij,ij->i", sup_np, sup_np)
    s_scores = ss[None, :] - 2.0 * (sup_np @ sup_np.T)
    hood = np.argsort(s_scores, axis=1)[:, :s_top]
    hood_ids = [np.concatenate([members[t] for t in hood[s]])
                for s in range(n_super)]

    # 4. route rows to their nearest super (row chunks on the device)
    row_super_dev = torch.empty(cap, dtype=torch.int32, device=dev)
    for lo in range(0, cap, chunk):
        row_super_dev[lo:lo + chunk] = _top1_super(
            db[lo:lo + chunk], supers,
            None if scales is None else scales[lo:lo + chunk])
    row_super = row_super_dev.cpu().numpy()

    # 5. per-super scoring against the neighbourhood's fine centroids.
    # Row blocks bound the gather and the (rows, neighbourhood) score
    # block; neighbourhoods are padded to pow2 widths by repeating the
    # last centroid, as the JAX package pads them, so a neighbourhood
    # smaller than cand fills the list the same way
    out = torch.empty((cap, cand), dtype=torch.int32, device=dev)
    order = np.argsort(row_super, kind="stable")
    bounds = np.searchsorted(row_super[order], np.arange(n_super + 1))
    score_block_elems = 1 << 26

    def _row_blk(nb: int) -> int:
        return int(max(2048, min(1 << 16, score_block_elems // nb)))

    def _put(rows_b, local_ids):
        out[torch.from_numpy(rows_b).to(dev)] = local_ids.to(torch.int32)

    for s in range(n_super):
        rows_s = order[bounds[s]: bounds[s + 1]]
        if rows_s.size == 0:
            continue
        ids = hood_ids[s]
        if ids.size == 0:
            # degenerate: the neighbourhood's supers captured no fine
            # centroid (dead k-means clusters): score against all of them
            row_blk = _row_blk(next_pow2(int(nlist)))
            for b0 in range(0, rows_s.size, row_blk):
                rows_b = rows_s[b0: b0 + row_blk]
                idx = torch.from_numpy(rows_b).to(dev)
                _put(rows_b, _assign_topk_chunk(
                    db[idx], centroids, cand,
                    None if scales is None else scales[idx]))
            continue
        nb_pad = next_pow2(max(int(ids.size), cand, 8))
        ids_pad = np.full(nb_pad, ids[-1], np.int64)
        ids_pad[: ids.size] = ids
        col_valid = np.zeros(nb_pad, bool)
        col_valid[: ids.size] = True
        if ids.size < cand:
            col_valid[:] = True
        ids_dev = torch.from_numpy(ids_pad).to(dev)
        cents_sub = centroids[ids_dev]
        col_valid_dev = torch.from_numpy(col_valid).to(dev)
        row_blk = _row_blk(nb_pad)
        for b0 in range(0, rows_s.size, row_blk):
            rows_b = rows_s[b0: b0 + row_blk]
            idx = torch.from_numpy(rows_b).to(dev)
            local = _score_vs_subset(db[idx], cents_sub, col_valid_dev,
                                     cand,
                                     None if scales is None else scales[idx])
            _put(rows_b, ids_dev[local])
    return out.cpu().numpy()


def _scores(metric: DistanceMetric, dots, qsq, qn, sq, nrm):
    """The refine's per-metric scores (ascending is better) from dots and
    the queries' (column) and rows' terms."""
    if metric is DistanceMetric.EUCLIDEAN:
        return qsq + sq - 2.0 * dots
    if metric is DistanceMetric.DOT_PRODUCT:
        return -dots
    qinv = torch.where(qn == 0.0, 0.0, 1.0 / qn)
    rinv = torch.where(nrm == 0.0, 0.0, 1.0 / nrm)
    return -(dots * qinv * rinv)


def ivf_search(queries, db, db_sq, db_norms, valid, centroids,
               metric: DistanceMetric, k: int, nprobe: int, t_c: int,
               s_t: int, scales=None):
    """Cluster-pruned search: (dists (Q, k), slots (Q, k)), +inf where
    missing. Probes the nprobe nearest clusters (t_c tiles each) plus the
    s_t spill tiles at the end of the slot space; exact f32 refine of the
    probed tiles through K2 (``scales``: int8 codes, the pow2 row scales
    multiply the finished dots, bit-identical to dequantized rows)."""
    qp, d = queries.shape
    n = db.shape[0]
    dev = db.device
    t_all = n // SUB
    k, nprobe, t_c, s_t = int(k), int(nprobe), int(t_c), int(s_t)
    qsq = (queries * queries).sum(dim=1)
    qn = torch.sqrt(qsq)

    # coarse: the metric's own affinity to each centroid
    cdots = queries @ centroids.T
    if metric is DistanceMetric.DOT_PRODUCT:
        cscore = -cdots
    elif metric is DistanceMetric.COSINE:
        cn = torch.sqrt((centroids * centroids).sum(dim=1))
        denom = torch.clamp(qn[:, None] * cn[None, :], min=1e-30)
        cscore = -(cdots / denom)
    else:
        c_sq = (centroids * centroids).sum(dim=1)
        cscore = c_sq[None, :] - 2.0 * cdots
    probe = torch.topk(cscore, nprobe, dim=1, largest=False)[1]

    offs_t = torch.arange(t_c, device=dev)
    tiles = (probe[:, :, None] * t_c + offs_t[None, None, :]).reshape(
        qp, nprobe * t_c)
    m_t = tiles.shape[1]
    offs = torch.arange(SUB, device=dev)
    cand_all = (tiles[:, :, None] * SUB + offs[None, None, :]).reshape(
        qp, m_t * SUB)

    # the probed refine, in query chunks under the JAX package's budget
    chunk = qp
    while chunk > 64 and chunk * m_t * SUB * d * 4 > _REFINE_BYTES:
        chunk //= 2
    sk_parts, pos_parts = [], []
    for a in range(0, qp, chunk):
        b = min(a + chunk, qp)
        cand = cand_all[a:b]
        dots = coarse_kernel._refine_dots(tiles[a:b].contiguous(),
                                          queries[a:b], db, m_t, scales)
        s2 = _scores(metric, dots, qsq[a:b, None], qn[a:b, None],
                     db_sq[cand], db_norms[cand])
        s2 = torch.where(valid[cand], s2, float("inf"))
        v, p = torch.topk(s2, k, dim=1, largest=False)
        sk_parts.append(v)
        pos_parts.append(p)
    sk = torch.cat(sk_parts)
    idx_out = torch.gather(cand_all, 1, torch.cat(pos_parts))

    if s_t:
        # the spill region: the SAME rows for every query, scanned once as
        # a shared (Q, spill_rows) product and merged into the top-k
        base = (t_all - s_t) * SUB
        dots = queries @ db[base:].float().T
        if scales is not None:
            dots = dots * scales[None, base:]
        s2 = _scores(metric, dots, qsq[:, None], qn[:, None],
                     db_sq[None, base:], db_norms[None, base:])
        s2 = torch.where(valid[None, base:], s2, float("inf"))
        v_sp, p_sp = torch.topk(s2, min(k, s_t * SUB), dim=1,
                                largest=False)
        all_sk = torch.cat([sk, v_sp], dim=1)
        all_idx = torch.cat([idx_out, p_sp + base], dim=1)
        sk, pos_m = torch.topk(all_sk, k, dim=1, largest=False)
        idx_out = torch.gather(all_idx, 1, pos_m)

    inf = float("inf")
    if metric is DistanceMetric.EUCLIDEAN:
        dists = torch.where(torch.isfinite(sk),
                            torch.sqrt(torch.clamp(sk, min=0.0)), inf)
    elif metric is DistanceMetric.DOT_PRODUCT:
        dists = sk
    else:
        dists = torch.where(torch.isfinite(sk),
                            1.0 + torch.clamp(sk, -1.0, 1.0), inf)
    return dists, idx_out


__all__ = ["kmeans_fit", "kmeans_assign_scores", "kmeans_assign_topk_all",
           "assign_preferences", "assign_preferences_hier", "ivf_search"]
