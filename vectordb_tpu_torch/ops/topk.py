"""Flat-scan distance + top-k on the device, and the exact tier ladder.

Port of ``vectordb_tpu/ops/topk.py``. The plain f32 scan (tier 3 and the
in-package oracle) is ``torch.matmul`` at "highest" precision — IEEE f32,
never TF32 (distance.prepare_device) — followed by exact ``torch.topk``.
``flat_search_bf16`` and ``flat_search_int8`` are the exact scans of the
bf16- and int8-stored databases: each widens one row block at a time to
f32 and keeps a running top-k. The JAX package's ``approx_min_k`` (a TPU
PartialReduce unit) has no counterpart; the fast scan uses exact top-k.

There is no jit and so no power-of-two bucketing of Q or k: PyTorch runs
eagerly and the CUDA kernels take any query count.

``flat_search_batched_submit`` is the dispatch point, with the JAX
package's branch order:
  int8 storage   tier 1 coarse_search_1p(scales=) (K7 + K2-int8) in both
                 modes; uncertified rows -> flat_search_int8
  bf16 storage   fast is served as exact; tier 1 coarse_search_1p over
                 db as its own hi (K1 + K2-bf16) at any capacity;
                 uncertified rows -> flat_search_bf16 (never bf16x3: with
                 no lo mirror it would double-count hi.qhi)
  mirrors        tier 1 coarse_search_1p (K1 + K2) -> tier 2 bf16x3
                 coarse_search (K3 + K2) -> tier 3 plain f32 scan
  coarse_f32     tier 1 coarse_search_1p (K4 + K2) -> tier 2
                 coarse_search (K5 at 3 passes + K2) -> tier 3
  fast mode      coarse_search_1p_fast (K1 or K4 + K2, no certificate);
                 where supports() holds and supports_1p() does not (a
                 256-row state), the legacy coarse_search(exact=False)
                 (K6 or K5 at 1 pass)
Each tier's uncertified queries re-run through the next one, inside
``collect``. Each re-run is a span and a counter
(``utils.profiling``), named by the scan it reaches:
  ``vdb/flat.tier2``, ``flat.tier2_queries``  tier 1's re-runs: the
                 bf16x3 tier 2 (mirrors, coarse_f32), the blockwise bf16
                 scan (bf16 storage) or the dequantizing scan (int8)
  ``vdb/flat.tier3``, ``flat.tier3_queries``  tier 2's re-runs: the
                 plain f32 scan
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..distance import DistanceMetric, pairwise_distances
from ..utils.profiling import annotate, count

# Max elements of one (Q-chunk, N) distance block in the plain scans: an
# eager scan materialises it, so large batches are cut into query chunks
# (1 GiB of f32 per block).
_SCAN_ELEMS = 1 << 28


def next_pow2(n: int, floor: int = 1) -> int:
    n = max(int(n), floor)
    return 1 << (n - 1).bit_length()


def _query_chunks(q: int, n: int):
    step = max(1, _SCAN_ELEMS // max(n, 1))
    return [(q0, min(q0 + step, q)) for q0 in range(0, q, step)]


def _chunked(fn):
    """Run a (queries, db, ...) -> (dists, idx) scan over query chunks."""
    @functools.wraps(fn)
    def run(queries, db, *args):
        parts = [fn(queries[a:b], db, *args)
                 for a, b in _query_chunks(queries.shape[0], db.shape[0])]
        return (torch.cat([p[0] for p in parts]),
                torch.cat([p[1] for p in parts]))
    return run


@_chunked
def flat_search(queries, db, db_sq_norms, db_norms, valid,
                metric: DistanceMetric, k: int):
    """Full scan + exact top-k: (dists (Q,k) asc, idx (Q,k)). ``k`` must
    be <= db.shape[0]; invalid slots come back with distance +inf and
    must be dropped by the caller."""
    dists = pairwise_distances(queries, db, metric, db_sq_norms=db_sq_norms,
                               db_norms=db_norms)
    dists = torch.where(valid[None, :], dists, float("inf"))
    return torch.topk(dists, int(k), dim=1, largest=False)


# Candidate pool for the fast path's coarse pass: at least this many (and
# at least FAST_OVERFETCH * k) rows survive into the exact re-rank.
FAST_OVERFETCH = 8
FAST_MIN_CANDIDATES = 128


def _exact_rerank(queries, db, db_sq_norms, db_norms, valid, cand,
                  metric: DistanceMetric, k: int):
    """Exact f32 re-rank of per-query candidate rows ``cand`` (Q, C):
    returns (dists (Q, k'), ids (Q, k')) ascending, +inf for dead rows."""
    cand_rows = db[cand]                                     # (Q, C, d)
    dots = torch.bmm(cand_rows, queries[:, :, None])[..., 0]
    dead = ~valid[cand]
    if metric is DistanceMetric.EUCLIDEAN:
        q_sq = (queries * queries).sum(dim=1, keepdim=True)
        exact = torch.sqrt(torch.clamp(q_sq + db_sq_norms[cand] - 2.0 * dots,
                                       min=0.0))
    elif metric is DistanceMetric.DOT_PRODUCT:
        exact = -dots
    else:
        qn = torch.sqrt((queries * queries).sum(dim=1, keepdim=True))
        denom = qn * db_norms[cand]
        sim = dots / torch.where(denom == 0.0, torch.ones_like(denom), denom)
        exact = 1.0 - torch.clamp(sim, -1.0, 1.0)
    exact = torch.where(dead, float("inf"), exact)
    vals, pos = torch.topk(exact, min(int(k), exact.shape[1]), dim=1,
                           largest=False)
    return vals, torch.gather(cand, 1, pos)


@_chunked
def flat_search_fast(queries, db, db_sq_norms, db_norms, valid,
                     metric: DistanceMetric, k: int):
    """Two-tier search: full f32 scan, exact top-kc candidate pool, exact
    re-rank. Returned distances are exact."""
    n = db.shape[0]
    kc = min(max(int(k) * FAST_OVERFETCH, FAST_MIN_CANDIDATES), n)
    coarse = pairwise_distances(queries, db, metric,
                                db_sq_norms=db_sq_norms, db_norms=db_norms)
    coarse = torch.where(valid[None, :], coarse, float("inf"))
    cand = torch.topk(coarse, kc, dim=1, largest=False)[1]
    return _exact_rerank(queries, db, db_sq_norms, db_norms, valid, cand,
                         metric, k)


# Max queries per fallback chunk when certification fails for a few
# queries in a large batch (bounds the (chunk, N) distance matrix).
_FALLBACK_CHUNK = 256

# Below this capacity the 1-pass certified tier is skipped: the bf16x3
# pipeline serves small stores. Tests lower it.
_EXACT1P_MIN_N = 1 << 18


def _use_exact1p(device_state: dict, capacity: int, d: int,
                 k_eff: int) -> bool:
    from . import coarse_kernel
    # bf16 storage ignores the capacity gate: tier 1 IS its exact path
    # (the stored db is its own hi mirror, elo_max = 0)
    big_enough = (capacity >= _EXACT1P_MIN_N
                  or bool(device_state.get("bf16_storage")))
    return ("elo_max" in device_state
            and big_enough
            and coarse_kernel.supports_1p(capacity, d, k_eff))


def _to_host(*tensors):
    return [t.cpu().numpy() for t in tensors]


def _collect_plain(dists, idx):
    return tuple(_to_host(dists, idx))


def _collect_certified(dists, idx, certified, queries_in, fb_state,
                       metric, k, tier):
    """Fetch a certified search's outputs; re-run uncertified rows through
    the next tier (whatever ``fb_state`` still routes to: the bf16x3
    pipeline when only elo_max was stripped, the plain scan when the
    mirrors were), in chunks of _FALLBACK_CHUNK queries, inside the span
    ``vdb/flat.<tier>``, counted in ``flat.<tier>_queries`` (the module
    docstring). The fallback reads ``fb_state``, the snapshot taken at
    submit, and the queries as they were submitted (numpy, or a tensor
    on the state's device)."""
    d_, i_, cert = _to_host(dists, idx, certified)
    if bool(np.all(cert)):
        return d_, i_
    d_ = d_.copy()
    i_ = i_.copy()
    bad = np.nonzero(~cert)[0]
    count(f"flat.{tier}_queries", bad.shape[0])
    with annotate(f"vdb/flat.{tier}"):
        for start in range(0, bad.shape[0], _FALLBACK_CHUNK):
            rows = bad[start:start + _FALLBACK_CHUNK]
            if isinstance(queries_in, torch.Tensor):
                sub_q = queries_in[torch.from_numpy(rows).to(
                    queries_in.device)]
            else:
                sub_q = np.ascontiguousarray(np.asarray(queries_in)[rows])
            sub_d, sub_i = flat_search_batched(sub_q, fb_state, metric, k,
                                               mode="exact")
            d_[rows] = sub_d[:, : d_.shape[1]]
            i_[rows] = sub_i[:, : i_.shape[1]]
    return d_, i_


# Row-tile size for the exact tiled path: small tiles keep the refine pool
# (k * EXACT_TILE_ROWS rows/query) tiny.
EXACT_TILE_ROWS = 16


@_chunked
def flat_search_exact_tiled(queries, db, db_sq_norms, db_norms, valid,
                            metric: DistanceMetric, k: int):
    """Provably-exact two-phase search (tier 3). Phase 1 reduces the
    masked distance matrix to per-tile minima; phase 2 takes each query's
    k best tiles (if a row outside them were in the true top-k, each
    chosen tile's minimum would witness a closer row) and re-ranks their
    rows exactly. Requires N to be a multiple of EXACT_TILE_ROWS."""
    n = db.shape[0]
    q = queries.shape[0]
    dists = pairwise_distances(queries, db, metric, db_sq_norms=db_sq_norms,
                               db_norms=db_norms)
    dists = torch.where(valid[None, :], dists, float("inf"))
    t = n // EXACT_TILE_ROWS
    minima = dists.reshape(q, t, EXACT_TILE_ROWS).amin(dim=2)
    kt = min(int(k), t)
    tile_idx = torch.topk(minima, kt, dim=1, largest=False)[1]
    offs = torch.arange(EXACT_TILE_ROWS, device=db.device)
    cand = (tile_idx[:, :, None] * EXACT_TILE_ROWS + offs).reshape(
        q, kt * EXACT_TILE_ROWS)
    return _exact_rerank(queries, db, db_sq_norms, db_norms, valid, cand,
                         metric, k)


# Row-block size of the bf16/int8 scans: each block is widened to f32 on
# the fly, so the peak extra memory is block * d * 4 bytes plus one
# (Q, block) distance block.
_WIDEN_SCAN_BLOCK = 1 << 16


def _widening_scan(queries, widen, n: int, db_sq_norms, db_norms, valid,
                   metric: DistanceMetric, k: int):
    """Exact scan over a database stored narrower than f32: ``widen(a, b)``
    returns rows a:b as f32 (exactly: the stored values). Full-precision
    distances per row block and a running top-k across blocks; exact with
    respect to the stored values."""
    q = queries.shape[0]
    kk = min(int(k), n)
    run_d = torch.full((q, kk), float("inf"), dtype=torch.float32,
                       device=queries.device)
    run_i = torch.zeros((q, kk), dtype=torch.int64, device=queries.device)
    for b0 in range(0, n, _WIDEN_SCAN_BLOCK):
        b1 = min(b0 + _WIDEN_SCAN_BLOCK, n)
        dists = pairwise_distances(queries, widen(b0, b1), metric,
                                   db_sq_norms=db_sq_norms[b0:b1],
                                   db_norms=db_norms[b0:b1])
        dists = torch.where(valid[None, b0:b1], dists, float("inf"))
        v, i = torch.topk(dists, min(kk, b1 - b0), dim=1, largest=False)
        all_d = torch.cat([run_d, v], dim=1)
        all_i = torch.cat([run_i, i + b0], dim=1)
        run_d, pos = torch.topk(all_d, kk, dim=1, largest=False)
        run_i = torch.gather(all_i, 1, pos)
    return run_d, run_i


def flat_search_bf16(queries, db16, db_sq_norms, db_norms, valid,
                     metric: DistanceMetric, k: int):
    """Blockwise exact scan for bf16-stored databases (storage="bf16"):
    rows widened exactly to f32 one block at a time."""
    return _widening_scan(queries, lambda a, b: db16[a:b].float(),
                          db16.shape[0], db_sq_norms, db_norms, valid,
                          metric, k)


def flat_search_int8(queries, db8, scales, db_sq_norms, db_norms, valid,
                     metric: DistanceMetric, k: int):
    """Blockwise exact scan for int8-stored databases (storage="int8"):
    rows dequantized one block at a time (code * pow2 row scale, exact in
    f32)."""
    return _widening_scan(
        queries, lambda a, b: db8[a:b].float() * scales[a:b, None],
        db8.shape[0], db_sq_norms, db_norms, valid, metric, k)


class SearchHandle:
    """An in-flight batched search launched by flat_search_batched_submit.

    Kernel launches are asynchronous on the submitting thread's current
    CUDA stream, which the handle records; ``collect()`` runs on that
    stream whatever thread calls it (the serving front end collects on a
    thread of its own), so its device-to-host copies wait for exactly the
    work the submit launched. It runs the fallback tiers for any
    uncertified queries and returns host numpy (dists, idx)."""

    __slots__ = ("_collect", "_done", "_stream")

    def __init__(self, collect_fn):
        self._collect = collect_fn
        self._done = None
        self._stream = None

    def collect(self):
        if self._done is None:
            if self._stream is None:
                self._done = self._collect()
            else:
                with torch.cuda.stream(self._stream):
                    self._done = self._collect()
        return self._done


def _certified_handle(out, queries_np, device_state, drop, metric, k,
                      tier):
    """Handle of a certified tier whose uncertified rows re-run through
    the state minus ``drop`` (the next tier, ``tier``: "tier2" or
    "tier3")."""
    fb_state = {kk: vv for kk, vv in device_state.items() if kk not in drop}
    return SearchHandle(functools.partial(_collect_certified, *out,
                                          queries_np, fb_state, metric, k,
                                          tier))


def flat_search_batched_submit(queries_np: np.ndarray, device_state: dict,
                               metric: DistanceMetric, k: int,
                               mode: str = "exact") -> SearchHandle:
    """Asynchronous entry point used by FlatIndex: launches the device
    work and returns a SearchHandle without waiting for results.
    ``queries_np`` is a (Q, d) f32 numpy array, or a tensor already on
    the state's device (the HNSW device build passes slices of the
    resident rows: no host round trip).

    collect() returns host numpy (dists, idx) with (Q, k') shape; entries
    with dist == +inf are "missing" (fewer than k live rows). ``mode``
    selects the certified exact ladder ("exact") or the 1-pass fast
    pipeline ("fast": exact distances, approximate ids). The tiers by
    storage are in the module docstring."""
    db = device_state["db"]
    handle = _submit(queries_np, device_state, metric, k, mode)
    if db.is_cuda:
        handle._stream = torch.cuda.current_stream(db.device)
    return handle


def _queries_to(queries_np, device: torch.device) -> torch.Tensor:
    """The queries on ``device``. A tensor there already is taken as it
    is (made f32 and contiguous). From numpy to a card the copy leaves
    from pinned memory without blocking the host: a pageable copy would
    wait for all earlier work on the stream, and the serving front end's
    next submit would then wait for the previous cycle's kernels."""
    if isinstance(queries_np, torch.Tensor):
        return queries_np.to(device=device, dtype=torch.float32
                             ).contiguous()
    q = torch.from_numpy(np.require(queries_np, np.float32, ["C", "W"]))
    if device.type != "cuda":
        return q.to(device)
    return q.pin_memory().to(device, non_blocking=True)


def _submit(queries_np: np.ndarray, device_state: dict,
            metric: DistanceMetric, k: int, mode: str) -> SearchHandle:
    from . import coarse_kernel
    db = device_state["db"]
    capacity = int(db.shape[0])
    d = queries_np.shape[1]
    queries = _queries_to(queries_np, db.device)
    k_eff = min(int(k), capacity)
    args = (queries, db, device_state["sq_norms"], device_state["norms"],
            device_state["valid"])

    if device_state.get("int8_storage"):
        # tier 1 in both modes: a single pass over the only stored
        # precision; uncertified rows re-run through the dequantizing scan
        if ("elo_max" in device_state
                and coarse_kernel.supports_1p_int8(capacity, d, k_eff)):
            out = coarse_kernel.coarse_search_1p(
                *args, None, device_state["elo_max"], metric, k_eff,
                scales=device_state["scales"])
            return _certified_handle(out, queries_np, device_state,
                                     ("elo_max",), metric, k, "tier2")
        dists, idx = flat_search_int8(
            queries, db, device_state["scales"], *args[2:], metric, k_eff)
        return SearchHandle(functools.partial(_collect_plain, dists, idx))

    if (("hi" in device_state or device_state.get("coarse_f32"))
            and coarse_kernel.supports(capacity, d, k_eff)):
        hi = device_state.get("hi")
        if device_state.get("bf16_storage"):
            mode = "exact"       # tier 1 is already a single pass
        if mode == "fast":
            if coarse_kernel.supports_1p(capacity, d, k_eff):
                dists, idx = coarse_kernel.coarse_search_1p_fast(
                    *args, hi, metric, k_eff)
            else:
                # legacy single-pass pipeline: K6 over the mirror, K5 at
                # one pass over f32 rows
                dists, idx, _ = coarse_kernel.coarse_search(
                    *args, hi, device_state.get("lo"), metric, k_eff,
                    exact=False)
            return SearchHandle(functools.partial(_collect_plain, dists,
                                                  idx))
        if _use_exact1p(device_state, capacity, d, k_eff):
            # tier 1; uncertified rows re-run through tier 2 (same state
            # minus elo_max), which itself falls back to tier 3. bf16
            # storage has no lo mirror: its rows go straight to the
            # blockwise bf16 scan
            out = coarse_kernel.coarse_search_1p(
                *args, hi, device_state["elo_max"], metric, k_eff)
            drop = (("hi", "lo", "elo_max", "coarse_f32", "bf16_storage")
                    if device_state.get("bf16_storage") else ("elo_max",))
            return _certified_handle(out, queries_np, device_state, drop,
                                     metric, k, "tier2")
        if not device_state.get("bf16_storage"):
            # tier 2: bf16x3 (K3 over the mirrors, K5 over f32 rows);
            # uncertified rows re-run through the plain scan
            out = coarse_kernel.coarse_search(
                *args, hi, device_state.get("lo"), metric, k_eff,
                exact=True)
            return _certified_handle(out, queries_np, device_state,
                                     ("hi", "lo", "elo_max", "coarse_f32"),
                                     metric, k, "tier3")

    if db.dtype == torch.bfloat16:
        # bf16 storage off the coarse path: the widening scan, exact over
        # the stored values, serves both modes
        search_fn = flat_search_bf16
    elif mode == "fast":
        search_fn = flat_search_fast
    elif capacity % EXACT_TILE_ROWS == 0:
        search_fn = flat_search_exact_tiled
    else:
        search_fn = flat_search
    dists, idx = search_fn(*args, metric, k_eff)
    return SearchHandle(functools.partial(_collect_plain, dists, idx))


def flat_search_batched(queries_np: np.ndarray, device_state: dict,
                        metric: DistanceMetric, k: int,
                        mode: str = "exact"):
    """Synchronous wrapper over flat_search_batched_submit (see there)."""
    return flat_search_batched_submit(queries_np, device_state, metric, k,
                                      mode=mode).collect()


__all__ = ["flat_search", "flat_search_fast", "flat_search_exact_tiled",
           "flat_search_bf16", "flat_search_int8", "flat_search_batched",
           "flat_search_batched_submit", "SearchHandle", "next_pow2"]
