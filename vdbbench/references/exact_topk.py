"""Exact k-nearest rows under a distance metric, in plain PyTorch.

The semantics of a vector store's unfiltered search: the k rows of least
distance to each query, ascending, with the distances

  * euclidean: |q - x|
  * cosine:    1 - clamp(q.x / (|q| |x|), -1, 1)
  * dot:       -q.x

``topk`` computes them in float64 (the reference), or in TF32 (the
control: both operands of the product rounded to TF32's 10 stored
mantissa bits, products summed in float32, as the tensor cores do when
``allow_tf32`` is set). Rows are read in blocks, so that a 1M x 768 table
fits beside its temporaries. This module imports nothing of the program.
"""

from __future__ import annotations

import torch

BLOCK_ROWS = 1 << 15
PRECISIONS = ("f64", "tf32")


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32 (10 stored mantissa bits), to
    nearest with ties to even; returned as float32."""
    bits = x.contiguous().float().view(torch.int32)
    odd = (bits >> 13) & 1
    bits = (bits + 0xFFF + odd) & ~0x1FFF
    return bits.view(torch.float32)


def _cast(x: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "f64":
        return x.double()
    return tf32_round(x.float())


def _norms(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((x * x).sum(dim=1))


def distances(queries: torch.Tensor, rows: torch.Tensor, metric: str,
              precision: str = "f64") -> torch.Tensor:
    """(Q, N) distances of ``queries`` (Q, d) to ``rows`` (N, d), both
    float32 on one device, computed in ``precision``."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    q, x = _cast(queries, precision), _cast(rows, precision)
    dots = q @ x.T
    if metric == "dot":
        return -dots
    if precision == "tf32":
        # norms are elementwise work: float32, outside the tensor cores
        q, x = queries.float(), rows.float()
    if metric == "euclidean":
        sq = (q * q).sum(dim=1)[:, None] + (x * x).sum(dim=1)[None, :]
        return torch.sqrt(torch.clamp(sq - 2.0 * dots, min=0.0))
    if metric == "cosine":
        denom = _norms(q)[:, None] * _norms(x)[None, :]
        return 1.0 - torch.clamp(dots / denom, -1.0, 1.0)
    raise ValueError(f"unknown metric {metric!r}")


def topk(queries: torch.Tensor, rows: torch.Tensor, metric: str, k: int,
         precision: str = "f64"):
    """(dists (Q, k) ascending, idx (Q, k) int64 row numbers) of the k
    rows nearest each query, over all of ``rows``."""
    best_d = best_i = None
    for lo in range(0, rows.shape[0], BLOCK_ROWS):
        blk = rows[lo:lo + BLOCK_ROWS]
        d = distances(queries, blk, metric, precision)
        kk = min(k, d.shape[1])
        bd, bi = torch.topk(d, kk, dim=1, largest=False)
        bi = bi + lo
        if best_d is None:
            best_d, best_i = bd, bi
        else:
            cd = torch.cat([best_d, bd], dim=1)
            ci = torch.cat([best_i, bi], dim=1)
            best_d, pos = torch.topk(cd, min(k, cd.shape[1]), dim=1,
                                     largest=False)
            best_i = torch.gather(ci, 1, pos)
    return best_d, best_i


def distances_of(queries: torch.Tensor, rows: torch.Tensor,
                 idx: torch.Tensor, metric: str) -> torch.Tensor:
    """float64 distances of each query to the rows ``idx`` (Q, m) names;
    entries of ``idx`` below 0 give +inf."""
    safe = torch.clamp(idx, min=0)
    q = queries.double()
    x = rows[safe.reshape(-1)].double().reshape(idx.shape[0], idx.shape[1],
                                                 -1)
    dots = torch.einsum("qd,qmd->qm", q, x)
    if metric == "dot":
        out = -dots
    elif metric == "euclidean":
        sq = (q * q).sum(dim=1)[:, None] + (x * x).sum(dim=2)
        out = torch.sqrt(torch.clamp(sq - 2.0 * dots, min=0.0))
    elif metric == "cosine":
        denom = _norms(q)[:, None] * torch.sqrt((x * x).sum(dim=2))
        out = 1.0 - torch.clamp(dots / denom, -1.0, 1.0)
    else:
        raise ValueError(f"unknown metric {metric!r}")
    return torch.where(idx >= 0, out, torch.full_like(out, float("inf")))
