"""Two-phase exact flat search: streamed tile-min scan + refine.

Port of ``vectordb_tpu/ops/flat_kernel.py``, the first-generation exact
scan (the certified coarse ladder, ops/coarse_kernel.py, superseded it;
nothing in the index layer calls it):

Phase A (kernel K9, ``tile_minima``): per query, the minimum score of each
  ``tile_rows``-row tile of the database, in IEEE f32 — only (Q, T)
  minima leave the kernel. A CUDA tensor launches ``csrc/scan_min.cu``, a
  CPU tensor takes the plain version beside it; neither falls back to the
  other.
Phase B (torch): each query's k best tiles by minimum provably hold its
  exact top k (a row outside them would be beaten by k tile minima), so
  their rows are gathered and re-ranked with exact f32 dots.

Cosine ranks by normalized dots, and the final distances are restored
from the scores at the end, as in the JAX package.
"""

from __future__ import annotations

import torch

from ..distance import DistanceMetric
from . import cuda_kernels

# Penalty added to invalid slots: large enough to push them past any real
# distance, small enough to stay far from f32 inf arithmetic.
_INVALID_PENALTY = 1e30

DEFAULT_TILE_ROWS = 512
# plain version: rows per (Q, rows) score block
_PLAIN_ELEMS = 1 << 26
_REFINE_QCHUNK = 128     # queries per refine gather (as the JAX lax.map)


def _scores(dots, qaux, raux, invalidf, mode: str):
    """Scores of a (Q, rows) dot block, the kernel's operation order."""
    penalty = invalidf[None, :] * _INVALID_PENALTY
    if mode == "euclidean":
        d2 = (qaux[:, None] + raux[None, :]) - 2.0 * dots
        return torch.clamp(d2, min=0.0) + penalty
    if mode == "dot":
        return -dots + penalty
    denom = qaux[:, None] * raux[None, :]
    denom = torch.where(denom == 0.0, torch.ones_like(denom), denom)
    return -(dots / denom) + penalty


def _tile_minima_plain(queries, qaux, db, raux, invalidf, mode: str,
                       tile_rows: int = DEFAULT_TILE_ROWS):
    """Plain K9: (Q, T) per-tile score minima, f32 matmul (never TF32)."""
    q = queries.shape[0]
    n = db.shape[0]
    step = max(tile_rows,
               (_PLAIN_ELEMS // max(q, 1)) // tile_rows * tile_rows)
    parts = []
    for r0 in range(0, n, step):
        dots = queries @ db[r0:r0 + step].T
        s = _scores(dots, qaux, raux[r0:r0 + step],
                    invalidf[r0:r0 + step], mode)
        parts.append(s.reshape(q, -1, tile_rows).amin(dim=2))
    return torch.cat(parts, dim=1)


def tile_minima(queries, qaux, db, raux, invalidf, mode: str,
                tile_rows: int = DEFAULT_TILE_ROWS):
    """Phase A: (Q, T) per-tile distance minima (K9 on a CUDA tensor)."""
    n = db.shape[0]
    if n % tile_rows:
        raise ValueError("capacity must be a multiple of the tile size")
    if db.is_cuda:
        return cuda_kernels.scan_min(queries, qaux, db, raux, invalidf, mode,
                                     tile_rows)
    return _tile_minima_plain(queries, qaux, db, raux, invalidf, mode,
                              tile_rows)


def two_phase_search(queries, db, db_sq_norms, db_norms, valid,
                     metric_name: str, k: int,
                     tile_rows: int = DEFAULT_TILE_ROWS):
    """Exact (dists, idx) top-k via tile-min filter + refine.

    Same contract as ops.topk.flat_search: ascending distances, +inf for
    missing rows (fewer than k live rows); k' = min(k, kt*tile_rows)
    columns."""
    metric = DistanceMetric(metric_name)
    q, d = queries.shape
    n = db.shape[0]
    t = n // tile_rows
    invalidf = 1.0 - valid.float()
    dev = db.device

    if metric is DistanceMetric.EUCLIDEAN:
        mode = "euclidean"
        qaux = (queries * queries).sum(1)
        raux = db_sq_norms
    elif metric is DistanceMetric.DOT_PRODUCT:
        mode = "dot"
        qaux = torch.zeros((q,), dtype=torch.float32, device=dev)
        raux = torch.zeros((n,), dtype=torch.float32, device=dev)
    else:
        mode = "cosine"
        qaux = torch.sqrt((queries * queries).sum(1))
        raux = db_norms

    minima = tile_minima(queries.contiguous(), qaux.contiguous(), db,
                         raux.contiguous(), invalidf.contiguous(), mode,
                         tile_rows)                          # (Q, T)

    # Phase B: k best tiles per query provably contain the exact top-k.
    kt = min(k, t)
    tile_idx = torch.topk(minima, kt, dim=1, largest=False)[1]   # (Q, kt)
    row_offsets = torch.arange(tile_rows, device=dev)
    cand_all = (tile_idx[:, :, None] * tile_rows
                + row_offsets[None, None, :]).reshape(q, kt * tile_rows)
    k_eff = min(k, kt * tile_rows)

    best, idx = [], []
    for a in range(0, q, _REFINE_QCHUNK):
        cand = cand_all[a:a + _REFINE_QCHUNK]
        qc = queries[a:a + _REFINE_QCHUNK]
        cand_dots = torch.bmm(db[cand], qc[:, :, None])[..., 0]
        penalty = invalidf[cand] * _INVALID_PENALTY
        if mode == "euclidean":
            cd = (qaux[a:a + _REFINE_QCHUNK, None] + db_sq_norms[cand]
                  - 2.0 * cand_dots)
            cd = torch.clamp(cd, min=0.0) + penalty
        elif mode == "dot":
            cd = -cand_dots + penalty
        else:
            denom = qaux[a:a + _REFINE_QCHUNK, None] * db_norms[cand]
            denom = torch.where(denom == 0.0, torch.ones_like(denom), denom)
            cd = -(cand_dots / denom) + penalty
        v, pos = torch.topk(cd, k_eff, dim=1, largest=False)
        best.append(v)
        idx.append(torch.gather(cand, 1, pos))
    best = torch.cat(best)
    idx = torch.cat(idx)

    # restore true distance values + inf for dead entries
    dead = best >= _INVALID_PENALTY * 0.5
    if mode == "euclidean":
        final = torch.sqrt(torch.clamp(best, min=0.0))
    elif mode == "dot":
        final = best
    else:
        # best = -similarity; clamp like the scalar path (distance.rs:61)
        final = 1.0 + torch.clamp(best, -1.0, 1.0)
    final = torch.where(dead, float("inf"), final)
    return final, idx


__all__ = ["two_phase_search", "tile_minima", "DEFAULT_TILE_ROWS"]
