"""Device-side HNSW traversal: batched beam search over the padded tables.

Port of ``vectordb_tpu/ops/hnsw_device.py``. The host graph
(index/hnsw_graph.py, index/hnsw_native.py) exports padded
structure-of-arrays tables (int32[N, L, M] adjacency, -1 padded); this
module ships them to the index's device and runs the search phase of HNSW
there:

  * greedy descent over layers max_level..1, then a layer-0 beam of fixed
    width ef, sorted, with an expansion flag per entry and a packed
    uint32[ceil(N/32)] visited bitmask per query;
  * each hop scores the expanded node's live, unvisited neighbours (a
    repeated id in one adjacency row counts once) and keeps the ef best of
    the beam followed by them, stably;
  * ``slot_mask``: a second result track admits only mask-passing slots,
    so a filtered search is exact while navigation stays unmasked.

On a CUDA tensor the whole batch is one launch of the hand-written kernel
H1 (csrc/hnsw_search.cu, ``cuda_kernels.hnsw_search``), a block per
query. The JAX package compiles the loop into one XLA program; in eager
PyTorch each hop would be about ten launches and a device-to-host test.
On a CPU tensor the plain version below runs the same semantics batched
over queries, one loop iteration per hop (the CPU tests, and the card's
check of H1). There is no fallback from the kernel to the plain version.

Ranking distances follow the JAX package's ``_make_distance``: euclidean
is sum (x - q)^2 (finalised by a square root), dot is -x.q, cosine is
1 - clip(x.q / (|x| |q|), -1, 1) with a zero denominator read as 1.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..distance import DistanceMetric, prepare_device
from . import cuda_kernels

_MODE = {DistanceMetric.EUCLIDEAN: "euclidean",
         DistanceMetric.DOT_PRODUCT: "dot",
         DistanceMetric.COSINE: "cosine"}


def build_device_tables(graph, device="cuda") -> dict:
    """Ship a host graph's padded tables to ``device``."""
    dev = prepare_device(device)
    t = graph.export_padded_tables()

    def put(arr):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(dev)

    return {
        "vectors": put(np.asarray(t["vectors"], np.float32)),
        "norms": put(np.asarray(t["norms"], np.float32)),
        "neighbors": put(np.asarray(t["neighbors"], np.int32)),
        "valid": put(np.asarray(t["valid"], bool)),
        "id_of_slot": put(np.asarray(t["id_of_slot"], np.int64)),
        "entry": int(t["entry"]),
        "max_level": int(t["max_level"]),
    }


def _plain_dist(mode: str, q, qn, rows, rn):
    """(Q, d) queries, (Q,) norms, (Q, C, d) rows, (Q, C) row norms ->
    (Q, C) ranking distances."""
    if mode == "euclidean":
        diff = rows - q[:, None, :]
        return (diff * diff).sum(dim=2)
    dots = (rows * q[:, None, :]).sum(dim=2)
    if mode == "dot":
        return -dots
    den = rn * qn[:, None]
    den = torch.where(den == 0.0, torch.ones_like(den), den)
    return 1.0 - torch.clamp(dots / den, -1.0, 1.0)


def _stable_keep(d, ids, extra, ef: int):
    """The ef best of each row of (Q, C) ``d`` by a stable sort (ties keep
    the earlier column), with ``ids`` and each tensor of ``extra``
    gathered alike."""
    order = torch.sort(d, dim=1, stable=True)[1][:, :ef]
    return (torch.gather(d, 1, order), torch.gather(ids, 1, order),
            [torch.gather(x, 1, order) for x in extra])


def _hnsw_search_plain(vectors, norms, neighbors, valid, queries,
                       entry: int, start_layer: int, mode: str, k: int,
                       ef: int, slot_mask=None, stats=None):
    """Plain H1, same contract as ``cuda_kernels.hnsw_search``: the JAX
    program's semantics batched over queries, one iteration a hop (a
    query whose search has ended keeps its state while the others go
    on). ``stats``, if a dict, gains "rows": the rows whose distance the
    search needed (the rows H1 gathers), and "hops": the layer-0
    expansions."""
    dev = vectors.device
    nq = queries.shape[0]
    n, _, m = neighbors.shape
    inf = float("inf")
    qn = torch.sqrt((queries * queries).sum(dim=1))
    ar = torch.arange(nq, device=dev)

    def dist(ids):
        return _plain_dist(mode, queries, qn, vectors[ids], norms[ids])

    # -- greedy descent: per query, its own layer and node
    counted = torch.zeros((), dtype=torch.long, device=dev)
    hops = torch.zeros((), dtype=torch.long, device=dev)
    cur = torch.full((nq,), entry, dtype=torch.long, device=dev)
    cur_d = dist(cur[:, None])[:, 0]
    layer = torch.full((nq,), start_layer, dtype=torch.long, device=dev)
    while bool((layer >= 1).any()):
        act = layer >= 1
        nbrs = neighbors[cur, layer.clamp(min=0)].long()
        safe = nbrs.clamp(min=0)
        ok = (nbrs >= 0) & valid[safe]
        nd = torch.where(ok, dist(safe), inf)
        counted += (ok & act[:, None]).sum()
        j = nd.argmin(dim=1)                    # the first minimum
        best = nd[ar, j]
        moved = act & (best < cur_d)
        cur = torch.where(moved, nbrs[ar, j], cur)
        cur_d = torch.where(moved, best, cur_d)
        layer = torch.where(act & ~moved, layer - 1, layer)

    # -- layer 0: fixed-ef sorted beam
    beam_d = torch.full((nq, ef), inf, device=dev)
    beam_d[:, 0] = cur_d
    beam_id = torch.full((nq, ef), -1, dtype=torch.long, device=dev)
    beam_id[:, 0] = cur
    expanded = torch.zeros((nq, ef), dtype=torch.bool, device=dev)
    visited = torch.zeros((nq, n), dtype=torch.bool, device=dev)
    visited[ar, cur] = True
    has_mask = slot_mask is not None
    if has_mask:
        elig0 = slot_mask[cur]
        res_d = torch.full((nq, ef), inf, device=dev)
        res_d[:, 0] = torch.where(elig0, cur_d, inf)
        res_id = torch.full((nq, ef), -1, dtype=torch.long, device=dev)
        res_id[:, 0] = torch.where(elig0, cur, -1)
    m_ar = torch.arange(m, device=dev)
    earlier = m_ar[:, None] > m_ar[None, :]
    while True:
        frontier = torch.where(expanded, inf, beam_d)
        act = torch.isfinite(frontier).any(dim=1)
        if not bool(act.any()):
            break
        pick = frontier.argmin(dim=1)            # the first minimum
        node = beam_id[ar, pick].clamp(min=0)
        expanded[ar[act], pick[act]] = True
        nbrs = neighbors[node, 0].long()
        safe = nbrs.clamp(min=0)
        seen = visited[ar[:, None], safe]
        dup = ((nbrs[:, :, None] == nbrs[:, None, :]) & earlier).any(dim=2)
        ok = (nbrs >= 0) & valid[safe] & ~seen & ~dup & act[:, None]
        nd = torch.where(ok, dist(safe), inf)
        counted += ok.sum()
        hops += act.sum()
        rows, cols = torch.nonzero(ok, as_tuple=True)
        visited[rows, safe[rows, cols]] = True
        beam_d, beam_id, (expanded,) = _stable_keep(
            torch.cat([beam_d, nd], 1), torch.cat([beam_id, nbrs], 1),
            [torch.cat([expanded, ~ok], 1)], ef)
        if has_mask:
            elig = ok & slot_mask[safe]
            res_d, res_id, _ = _stable_keep(
                torch.cat([res_d, torch.where(elig, nd, inf)], 1),
                torch.cat([res_id, torch.where(elig, nbrs, -1)], 1), [], ef)
    out_d = (res_d if has_mask else beam_d)[:, :k]
    out_slot = (res_id if has_mask else beam_id)[:, :k]
    if mode == "euclidean":
        out_d = torch.sqrt(torch.clamp(out_d, min=0.0))
    found = torch.isfinite(out_d)
    if stats is not None:
        stats["rows"] = stats.get("rows", 0) + nq + int(counted)
        stats["hops"] = stats.get("hops", 0) + int(hops)
    return (torch.where(found, out_d, inf),
            torch.where(found, out_slot, -1).to(torch.int32))


def _hnsw_search(vectors, norms, neighbors, valid, queries, entry: int,
                 start_layer: int, mode: str, k: int, ef: int,
                 slot_mask=None):
    """H1: the CUDA kernel for CUDA tensors, the plain version for CPU
    ones."""
    if vectors.is_cuda:
        return cuda_kernels.hnsw_search(vectors, norms, neighbors, valid,
                                        queries, entry, start_layer, mode,
                                        k, ef, slot_mask)
    return _hnsw_search_plain(vectors, norms, neighbors, valid, queries,
                              entry, start_layer, mode, k, ef, slot_mask)


def hnsw_search_device(vectors, norms, neighbors, valid, id_of_slot,
                       entry: int, max_level: int, queries,
                       metric_name: str, k: int, ef: int, max_layers: int,
                       slot_mask=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched HNSW search, in the JAX package's argument order. Returns
    (dists (Q, k), internal ids (Q, k)); missing results carry +inf
    distance and id -1. ``slot_mask`` (bool[N] or None): exact filtered
    search, navigation unmasked, a result track of mask-passing slots."""
    metric = DistanceMetric(metric_name)
    ef = max(int(ef), int(k))
    start = min(int(max_level), int(max_layers) - 1)
    if int(entry) < 0:
        nq = queries.shape[0]
        return (torch.full((nq, k), float("inf"), device=queries.device),
                torch.full((nq, k), -1, dtype=torch.long,
                           device=queries.device))
    dists, slots = _hnsw_search(vectors, norms, neighbors, valid, queries,
                                int(entry), start, _MODE[metric], int(k),
                                ef, slot_mask)
    slots = slots.long()
    ids = torch.where(slots >= 0, id_of_slot[slots.clamp(min=0)], -1)
    return dists, ids


class DeviceHnswSearcher:
    """Freeze a host graph's tables on a device and run batched searches."""

    def __init__(self, graph, metric: DistanceMetric, device="cuda"):
        self.metric = metric
        self.max_layers = graph.params.max_layers
        self.tables = build_device_tables(graph, device)

    def search_batch(self, queries: np.ndarray, k: int, ef: int,
                     slot_mask=None) -> List[List[Tuple[int, float]]]:
        t = self.tables
        dev = t["vectors"].device
        n = int(t["valid"].shape[0])
        if slot_mask is not None:
            m = np.asarray(slot_mask, dtype=bool)
            if m.shape[0] < n:
                m = np.concatenate([m, np.zeros(n - m.shape[0], bool)])
            slot_mask = torch.from_numpy(np.ascontiguousarray(m[:n])).to(dev)
        q = torch.from_numpy(np.require(queries, np.float32,
                                        ["C", "W"])).to(dev)
        dists, ids = hnsw_search_device(
            t["vectors"], t["norms"], t["neighbors"], t["valid"],
            t["id_of_slot"], t["entry"], t["max_level"], q,
            self.metric.value, int(k), int(ef), self.max_layers,
            slot_mask=slot_mask)
        dists = dists.cpu().numpy()
        ids = ids.cpu().numpy()
        out = []
        for qi in range(dists.shape[0]):
            out.append([(int(i), float(dv))
                        for i, dv in zip(ids[qi], dists[qi])
                        if np.isfinite(dv) and i >= 0])
        return out


__all__ = ["build_device_tables", "hnsw_search_device", "DeviceHnswSearcher"]
