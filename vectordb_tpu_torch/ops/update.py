"""Row/value scatter updates for device-resident packed buffers.

Insert/delete against the packed ``f32[capacity, d]`` database never
re-uploads the whole matrix: host bookkeeping queues dirty slots and these
scatters patch the device copy. The JAX package's donated-vs-copy pair
becomes in place (``index_copy_``) vs clone-then-scatter: the clone is for
writes that race an in-flight search, whose fallback tier may read the
old buffers later, on the host's schedule (index/flat.py).
"""

from __future__ import annotations

import torch


def scatter_rows(buf: torch.Tensor, idx: torch.Tensor,
                 rows: torch.Tensor) -> torch.Tensor:
    """buf (N, d) <- rows (m, d) at row positions idx (m,), in place."""
    return buf.index_copy_(0, idx, rows)


def scatter_values(buf: torch.Tensor, idx: torch.Tensor,
                   values: torch.Tensor) -> torch.Tensor:
    """buf (N,) <- values (m,) at positions idx (m,), in place."""
    return buf.index_copy_(0, idx, values)


def scatter_rows_copy(buf: torch.Tensor, idx: torch.Tensor,
                      rows: torch.Tensor) -> torch.Tensor:
    """Like scatter_rows on a fresh copy; ``buf`` is left untouched."""
    return buf.clone().index_copy_(0, idx, rows)


def scatter_values_copy(buf: torch.Tensor, idx: torch.Tensor,
                        values: torch.Tensor) -> torch.Tensor:
    return buf.clone().index_copy_(0, idx, values)


__all__ = ["scatter_rows", "scatter_values", "scatter_rows_copy",
           "scatter_values_copy"]
