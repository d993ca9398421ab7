"""Clustered rows whose deviations share a low-dimensional subspace.

``benchmarks/pq_bench.py``'s ``clustered_intrinsic`` protocol (its lines
87-100), made on the card by a ``torch.Generator`` seeded from the run's
seed: ``centers`` N(0, 1) centers in ``d`` dimensions, a ``subspace`` x d
basis of N(0, 1 / subspace) entries, and each row (and query) a uniformly
drawn center plus ``noise`` * z @ basis, z ~ N(0, 1) in ``subspace``
dimensions. Rows and queries come from one model, as a corpus and its
queries do. Sizes and draws are fixed by the parameters, so every seed
makes the same work.
"""

from __future__ import annotations

import torch

_CHUNK = 1 << 17


def make(seed: int, n: int, d: int, nq: int, params: dict, device):
    """(rows (n, d), queries (nq, d)): float32 tensors on ``device``."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    c, sub = int(params["centers"]), int(params["subspace"])
    noise = float(params["noise"])
    centers = torch.randn(c, d, generator=g, device=device)
    basis = torch.randn(sub, d, generator=g, device=device) / sub ** 0.5

    def draw(m: int) -> torch.Tensor:
        out = torch.empty(m, d, device=device)
        for lo in range(0, m, _CHUNK):
            hi = min(lo + _CHUNK, m)
            which = torch.randint(0, c, (hi - lo,), generator=g,
                                  device=device)
            z = torch.randn(hi - lo, sub, generator=g, device=device)
            out[lo:hi] = centers[which] + noise * (z @ basis)
        return out

    return draw(n), draw(nq)
