"""Certified coarse scan: the flat index's hot path on the GPU.

Port of ``vectordb_tpu/ops/coarse_kernel.py`` (host logic, both
certificates, and the kernels K1-K7). The pipeline is the JAX package's,
step for step:

  1. one bf16 pass over the database emits 16-row tile minima and
     256-row super-tile minima (``_minima_1p_sup``: K1 over the hi mirror
     or a bf16-stored database, K4 over f32 rows rounded on chip, K7 over
     int8 codes), or the bf16x3 pass emits tile minima only (K3 over the
     mirrors, ``_coarse_minima``; K5 over f32 rows, ``_coarse_minima_f32``);
  2. a hierarchical exact top-k picks each query's m candidate tiles;
  3. exact f32 dots over the gathered tiles (K2, ``_refine_dots``, over
     f32 rows, bf16 rows or int8 codes times their pow2 scales);
  4. top-k plus a rigorous per-query exactness certificate; uncertified
     queries are re-run by the caller (ops/topk.py) through the next tier.
The single-pass legacy fast pipeline (``coarse_search(exact=False)``)
runs K6 (``_coarse_minima_1p``) over the mirrors or K5 at one pass over
f32 rows.

Each kernel has a plain PyTorch version beside it with the same signature
and layout. The launchers dispatch on the tensor's device: a CPU tensor
takes the plain version (the CPU tests), a CUDA tensor launches the
hand-written kernel from ``cuda_kernels`` or raises. There is no fallback
from a kernel to its plain version.

Constants that change answers are the JAX package's: ``SUB``, ``SUPER``,
``SUPER2``, ``PENALTY``, the margin scales and the pool formulas.
``_BLOCK_ROWS`` replaces the TPU's ``_tile_cols`` (a VMEM fact): on Hopper
one coarse-kernel block owns one 256-row super-tile, for every d, so the
JAX package's wide-d fallback inside ``_minima_1p_sup`` has no
counterpart. ``_QB_MAX``, ``_VMEM_BUDGET``, ``_REFINE_QBR`` and
``_REFINE_M_CHUNK`` have none either: the CUDA kernels take any query
count and any m.
"""

from __future__ import annotations

import torch

from ..distance import DistanceMetric
from . import cuda_kernels

SUB = 16            # rows per candidate tile (refine granularity)
SUPER = 16          # tiles per super-tile in the hierarchical selection
SUPER2 = 16         # super-tiles per super-super (3rd selection level)
# Penalty added to invalid slots: far past any real distance, far from inf.
PENALTY = 1e30
# Max k served by the coarse path; past this the plain f32 scan serves.
MAX_K = 256
# Database rows per coarse-kernel block on Hopper (one super-tile).
_BLOCK_ROWS = SUB * SUPER
# margin scale on err_dot: rigorous floor is 2 for euclidean (score error =
# 2x dot error) and 1 for dot/cosine; 3.0/1.5 carry a 1.5x slack that also
# absorbs the refine's ~d·2^-24 error and f32 score arithmetic.
_MARGIN_SCALE_EUCLID = 3.0
_MARGIN_SCALE_DOT = 1.5
# plain versions process the (rows, Qp) score block in pieces of about
# this many elements, so they stay usable at the chip's comparison shapes
_PLAIN_ELEMS = 1 << 26


def _metric_mode(metric_name: str) -> str:
    return {"euclidean": "euclidean", "dot_product": "dot",
            "cosine": "cosine"}[metric_name]


def supports(capacity: int, d: int, k_eff: int) -> bool:
    """Whether the coarse path can serve this signature."""
    return (capacity >= _BLOCK_ROWS and capacity % _BLOCK_ROWS == 0
            and k_eff <= MAX_K)


def supports_1p(capacity: int, d: int, k_eff: int) -> bool:
    """The hierarchical selection needs whole super-tiles."""
    return (supports(capacity, d, k_eff)
            and capacity % (SUB * SUPER) == 0
            and capacity // (SUB * SUPER) >= 2)


def supports_1p_int8(capacity: int, d: int, k_eff: int) -> bool:
    """The int8-source tier's gate. In the JAX package it also needs
    whole super-tiles per TPU grid step (its wide-d fallback has no int8
    kernel); on Hopper a coarse block is always one 256-row super-tile,
    for any d, so this is ``supports_1p``."""
    return supports_1p(capacity, d, k_eff)


# Scale of the coarse accumulation term in both certificates, by the body
# that computed the coarse minima (``_coarse_body``). The JAX package's
# margins assume round-to-nearest f32 accumulation: the plain versions
# accumulate in IEEE f32 and keep its coefficient, so certified flags
# compare one to one on the CPU. Tensor-core f32 accumulation does not
# round to nearest (Fasi, Higham, Mikaitis & Pranesh, "Numerical behavior
# of NVIDIA tensor cores", PeerJ Computer Science 2021): mma.sync results
# double the term. How wgmma accumulates is not documented (DeepSeek-V3's
# report found ~14 bits in its fp8 form); chip_smoke.py phase 2 reads the
# raw-dot error of both bodies in units of d 2^-24 sum|x_i q_i| and fails
# if a reading passes its body's coefficient. A larger coefficient only
# widens the margin: more queries fall back, no answer is wrong.
_ACCUM_COEFF = {"plain": 1.0, "mma_sync": 2.0, "wgmma": 2.0}


def _accum_coeff(body: str) -> float:
    return _ACCUM_COEFF[body]


def _coarse_body(src: str, arr, passes: int, emit_super: bool,
                 lo=None) -> str:
    """The body that computes the coarse minima over ``arr`` (hi mirror,
    f32 rows or codes; ``lo``: the lo mirror K3 reads at three passes):
    "plain" for a CPU tensor, else the CUDA route
    (``cuda_kernels._coarse_route``, by shape and alignment)."""
    if not arr.is_cuda:
        return "plain"
    return cuda_kernels.coarse_body(src, arr, passes, emit_super, lo)


def _probe_inv(n: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(inv_col (1, n), live row ids (n/16,)) for reading raw dots through
    a coarse kernel: one live row per 16-row tile (row 16t + t % 16), the
    other 15 dead. In mode "dot" each tile minimum is then exactly -dot of
    its live row (the dead rows sit at -dot + 1e30)."""
    tiles = torch.arange(n // SUB, device=device)
    live = tiles * SUB + tiles % SUB
    inv = torch.ones((1, n), dtype=torch.float32, device=device)
    inv[0, live] = 0.0
    return inv, live


def _accum_reading(tile_min, x, qThi, live, x_lo=None, qTlo=None) -> float:
    """Accumulation error of dots read through ``_probe_inv``: max over
    (tile, query) of |(-tile_min) - dot| / (d 2^-24 sum_i |x_i q_i|), dot
    in f64 over the same bf16 operands. ``x`` (N, d) holds the values the
    kernel multiplied (bf16-exact), ``qThi`` (d, Qp) the bf16 queries; with
    the lo operands ``x_lo`` and ``qTlo`` (3 passes), dot is hi.qhi +
    lo.qhi + hi.qlo and the sum runs over all three products. A
    round-to-nearest f32 sum of one pass reads at most 1."""
    xl, q = x[live].double(), qThi.double()
    pairs = [(xl, q)]
    if x_lo is not None:
        pairs += [(x_lo[live].double(), q), (xl, qTlo.double())]
    dot = sum(a @ b for a, b in pairs)
    scale = sum(a.abs() @ b.abs() for a, b in pairs) * (x.shape[1]
                                                         * 2.0 ** -24)
    err = (-tile_min.double() - dot).abs()
    return float(torch.where(scale > 0, err / scale, err).max())


# ---------------------------------------------------------------------------
# plain PyTorch versions of K1-K7 and K2 (same signatures and layouts as
# the JAX launchers _minima_1p_sup, _coarse_minima, _coarse_minima_f32,
# _coarse_minima_1p, _refine_dots)
# ---------------------------------------------------------------------------

def _score_plain(dots, qrow, col, inv_col, mode: str):
    """Coarse score of a (rows, Qp) dot block, + PENALTY on dead rows —
    the same operation order as the kernels' epilogue."""
    col_t = col.reshape(-1, 1)
    inv_t = inv_col.reshape(-1, 1)
    if mode == "euclidean":
        score = (col_t + qrow) - 2.0 * dots
    elif mode == "dot":
        score = -dots
    else:
        score = -(dots * col_t * qrow)
    return score + inv_t * PENALTY


def _row_chunk(qp: int) -> int:
    return max(_BLOCK_ROWS,
               (_PLAIN_ELEMS // max(qp, 1)) // _BLOCK_ROWS * _BLOCK_ROWS)


def _tile_minima_plain(passes: int, qThi, qTlo, qrow, db, db_lo, col,
                       inv_col, mode: str, src: str = "mirrors",
                       scales=None):
    """(N/16, Qp) tile minima. ``src``: "mirrors" (``db`` the bf16 hi
    mirror, ``db_lo`` the lo one), "f32" (``db`` the f32 rows, split
    here by round to nearest even, as the kernel splits them) or "int8"
    (``db`` the codes, exact in bf16; each dot times its row's scale in
    ``scales`` (1, N)). bf16 operands are widened to f32 BEFORE the matmul
    (torch's bf16 matmul would round its output to bf16); the products are
    then exact and only the summation order differs from the kernels'."""
    qp = qThi.shape[1]
    qhi = qThi.float()
    qlo = qTlo.float() if passes == 3 else None
    step = _row_chunk(qp)
    parts = []
    for r0 in range(0, db.shape[0], step):
        x = db[r0:r0 + step]
        h = x.to(torch.bfloat16).float() if src == "f32" else x.float()
        dots = h @ qhi
        if passes == 3:
            lo = ((x - h).to(torch.bfloat16) if src == "f32"
                  else db_lo[r0:r0 + step])
            dots = dots + lo.float() @ qhi
            dots = dots + h @ qlo
        if scales is not None:
            dots = dots * scales[:, r0:r0 + step].reshape(-1, 1)
        score = _score_plain(dots, qrow, col[:, r0:r0 + step],
                             inv_col[:, r0:r0 + step], mode)
        parts.append(score.reshape(-1, SUB, qp).amin(dim=1))
    return torch.cat(parts, dim=0)


def _minima_1p_sup_plain(qThi, qrow, dbarr, col, inv_col, mode: str,
                         src: str = "mirrors", scales=None):
    """Plain K1 (src "mirrors"), K4 ("f32"), K7 ("int8"): (tile minima
    (T, Qp), super minima (T2, Qp))."""
    tile_tq = _tile_minima_plain(1, qThi, None, qrow, dbarr, None, col,
                                 inv_col, mode, src, scales)
    qp = qThi.shape[1]
    return tile_tq, tile_tq.reshape(-1, SUPER, qp).amin(dim=1)


def _coarse_minima_plain(qThi, qTlo, qrow, db_hi, db_lo, col, inv_col,
                         passes: int, mode: str):
    """Plain K3: (Qp, T) tile minima over the mirrors, 3 passes (bf16x3)
    or 1."""
    return _tile_minima_plain(passes, qThi, qTlo, qrow, db_hi, db_lo, col,
                              inv_col, mode).T.contiguous()


def _coarse_minima_f32_plain(qThi, qTlo, qrow, db, col, inv_col,
                             passes: int, mode: str):
    """Plain K5: (Qp, T) tile minima over f32 rows, 3 passes or 1."""
    return _tile_minima_plain(passes, qThi, qTlo, qrow, db, None, col,
                              inv_col, mode, "f32").T.contiguous()


def _coarse_minima_1p_plain(qThi, qrow, db_hi, col, inv_col, mode: str):
    """Plain K6: (Qp, T) tile minima, one bf16 pass over the hi mirror."""
    return _tile_minima_plain(1, qThi, None, qrow, db_hi, None, col,
                              inv_col, mode).T.contiguous()


def _refine_dots_plain(tile_idx, queries, db, m: int, scales=None):
    """Plain K2: (Qp, m*SUB) f32 dots of each query with the rows of its
    m selected tiles (gathered, widened exactly to f32, multiplied
    elementwise and summed over d: the reduction ``_query_terms`` uses
    for |q|^2, so a row searched with itself cancels to 0 in
    |q|^2 + |x|^2 - 2 x.q); with int8 codes, the dots times the rows'
    pow2 ``scales`` (N,)."""
    qp, d = queries.shape
    db3 = db.reshape(-1, SUB, d)
    step = max(1, _PLAIN_ELEMS // max(m * SUB * d, 1))
    parts = []
    for q0 in range(0, qp, step):
        t_i = tile_idx[q0:q0 + step]
        rows = db3[t_i].reshape(-1, m * SUB, d).float()
        dots = (rows * queries[q0:q0 + step, None, :]).sum(dim=2)
        if scales is not None:
            dots = dots * scales.reshape(-1, SUB)[t_i].reshape(-1, m * SUB)
        parts.append(dots)
    return torch.cat(parts, dim=0)


# ---------------------------------------------------------------------------
# launchers: plain version for CPU tensors, the CUDA kernel for CUDA ones
# ---------------------------------------------------------------------------

def _minima_1p_sup(qThi, qrow, dbarr, col, inv_col, mode: str,
                   src: str = "mirrors", scales=None):
    """(tile minima (T, Qp), super minima (T2, Qp)) in one pass. ``dbarr``
    is the bf16 hi mirror or bf16-stored database (src "mirrors": K1),
    the f32 rows ("f32": K4) or the int8 codes ("int8": K7, with the
    per-row pow2 ``scales`` as (1, N))."""
    if dbarr.is_cuda:
        if src == "f32":
            return cuda_kernels.coarse_minima_f32_1p_sup(qThi, qrow, dbarr,
                                                         col, inv_col, mode)
        if src == "int8":
            return cuda_kernels.coarse_minima_int8_1p_sup(
                qThi, qrow, dbarr, scales, col, inv_col, mode)
        return cuda_kernels.coarse_minima_1p_sup(qThi, qrow, dbarr, col,
                                                 inv_col, mode)
    return _minima_1p_sup_plain(qThi, qrow, dbarr, col, inv_col, mode, src,
                                scales)


def _coarse_minima(qThi, qTlo, qrow, db_hi, db_lo, col, inv_col,
                   passes: int, mode: str):
    """K3: (Qp, T) coarse tile minima over the mirrors."""
    if db_hi.is_cuda:
        return cuda_kernels.coarse_minima(
            qThi, qTlo, qrow, db_hi, db_lo, col, inv_col, passes,
            mode).T.contiguous()
    return _coarse_minima_plain(qThi, qTlo, qrow, db_hi, db_lo, col,
                                inv_col, passes, mode)


def _coarse_minima_f32(qThi, qTlo, qrow, db, col, inv_col, passes: int,
                       mode: str):
    """K5: (Qp, T) coarse tile minima streaming the f32 rows."""
    if db.is_cuda:
        return cuda_kernels.coarse_minima_f32(
            qThi, qTlo, qrow, db, col, inv_col, passes, mode).T.contiguous()
    return _coarse_minima_f32_plain(qThi, qTlo, qrow, db, col, inv_col,
                                    passes, mode)


def _coarse_minima_1p(qThi, qrow, db_hi, col, inv_col, mode: str):
    """K6: (Qp, T) single-pass coarse tile minima over the hi mirror."""
    if db_hi.is_cuda:
        return cuda_kernels.coarse_minima_1p(qThi, qrow, db_hi, col,
                                             inv_col, mode).T.contiguous()
    return _coarse_minima_1p_plain(qThi, qrow, db_hi, col, inv_col, mode)


def _refine_dots(tile_idx, queries, db, m: int, scales=None):
    """K2: (Qp, m*SUB) exact f32 candidate dots."""
    if db.is_cuda:
        return cuda_kernels.refine_dots(tile_idx, queries, db, m, scales)
    return _refine_dots_plain(tile_idx, queries, db, m, scales)


# ---------------------------------------------------------------------------
# pipeline host logic
# ---------------------------------------------------------------------------

def _query_terms(queries, db_sq, db_norms, valid, mode: str):
    """Per-query and per-row kernel operands: (qThi (d, Qp) bf16, qlo
    (d, Qp) f32 residual, qsq, qn, qrow (1, Qp), col (1, N), inv_col
    (1, N))."""
    qp = queries.shape[0]
    n = db_sq.shape[0]
    qT = queries.T.contiguous()
    qThi = qT.to(torch.bfloat16)
    qlo = qT - qThi.float()
    qsq = (queries * queries).sum(dim=1)
    qn = torch.sqrt(qsq)
    if mode == "euclidean":
        qrow = qsq.reshape(1, qp)
        col = db_sq.reshape(1, n)
    elif mode == "dot":
        qrow = torch.zeros((1, qp), dtype=torch.float32,
                           device=queries.device)
        col = torch.zeros((1, n), dtype=torch.float32, device=queries.device)
    else:
        qinv = torch.where(qn == 0.0, 0.0, 1.0 / qn)
        rinv = torch.where(db_norms == 0.0, 0.0, 1.0 / db_norms)
        qrow = qinv.reshape(1, qp)
        col = rinv.reshape(1, n).contiguous()
    inv_col = (1.0 - valid.float()).reshape(1, n)
    return qThi, qlo, qsq, qn, qrow, col, inv_col


def _select_tiles_1p(tile_tq, sup_tq, qp: int, t_all: int, m2: int, m: int):
    """3-level exact tile selection over (T, Qp) tile and (T2, Qp) super
    minima -> (tile_idx (Qp, m), boundary b (Qp,)).

    The advanced-indexing steps index a (Qp, ...) permuted view with two
    adjacent index arrays, so the result is (Qp, m3, SUPER2) by
    construction. The JAX package writes ``sup3_tq[ss_idx, :,
    arange(qp)[:, None]]``, which gives the same order under numpy's
    rule for separated advanced indices (tests/test_torch_coarse_kernel.py
    holds the two against each other). Soundness does not depend on tie
    order: each boundary term bounds whatever a tied stratum left out."""
    dev = tile_tq.device
    t2 = t_all // SUPER
    inf_col = torch.full((qp,), float("inf"), dtype=torch.float32,
                         device=dev)
    ar = torch.arange(qp, device=dev)[:, None]
    if t2 % SUPER2 == 0 and t2 // SUPER2 >= 2:
        # third selection level: super-supers of SUPER2 supers (the JAX
        # package's containment argument, coarse_kernel.py:1030-1041)
        t3 = t2 // SUPER2
        m3 = min(m2, t3)
        sup3_qts = sup_tq.reshape(t3, SUPER2, qp).permute(2, 0, 1)
        minima3 = sup3_qts.amin(dim=2)                       # (Qp, t3)
        val_ss, ss_idx = torch.topk(minima3, m3, dim=1, largest=False)
        sel_sup = sup3_qts[ar, ss_idx].reshape(qp, m3 * SUPER2)
        val_sup, loc2 = torch.topk(sel_sup, m2, dim=1, largest=False)
        ss_of = torch.gather(ss_idx, 1, loc2 // SUPER2)
        sup_idx = ss_of * SUPER2 + (loc2 % SUPER2)         # (Qp, m2) global
        ss_boundary = val_ss[:, -1] if m3 < t3 else inf_col
    else:
        val_sup, sup_idx = torch.topk(sup_tq.T, m2, dim=1, largest=False)
        ss_boundary = inf_col
    tiles_qts = tile_tq.reshape(t2, SUPER, qp).permute(2, 0, 1)
    sel = tiles_qts[ar, sup_idx].reshape(qp, m2 * SUPER)
    val_t, loc = torch.topk(sel, m, dim=1, largest=False)
    sup_of = torch.gather(sup_idx, 1, loc // SUPER)
    tile_idx = sup_of * SUPER + (loc % SUPER)               # (Qp, m) global
    # smallest coarse minimum over everything NOT refined, stratum by
    # stratum (+inf when a stratum is fully selected)
    sup_boundary = val_sup[:, -1] if m2 < t2 else inf_col
    tile_boundary = val_t[:, -1] if m < m2 * SUPER else inf_col
    b = torch.minimum(ss_boundary, torch.minimum(sup_boundary,
                                                 tile_boundary))
    return tile_idx, b


def _candidates(tile_idx):
    """(Qp, m*SUB) slot ids of the rows in the selected tiles."""
    offs = torch.arange(SUB, device=tile_idx.device)
    qp, m = tile_idx.shape
    return (tile_idx[:, :, None] * SUB + offs).reshape(qp, m * SUB)


def _refine_topk(tile_idx, queries, qsq, qn, db, db_sq, db_norms, valid,
                 mode: str, m: int, k: int, scales=None):
    """Exact f32 re-rank of each query's m candidate tiles.

    ``scales`` (int8 storage only): per-row pow2 scale vector. The dot
    runs over the raw integer codes and the scale multiplies the finished
    dot — bit-identical to dotting the dequantized rows, because a pow2
    multiply only shifts exponents.

    Returns (sk, pos, w): the k best refined scores ascending, their
    positions within the (m*SUB) candidate pool, and the refined minimum
    of the LAST (m-th) tile (the bf16x3 certificate's boundary term)."""
    qp = queries.shape[0]
    t_all = db.shape[0] // SUB
    dots = _refine_dots(tile_idx, queries, db, m, scales)
    vld = valid.reshape(t_all, SUB)[tile_idx].reshape(qp, m * SUB)
    if mode == "euclidean":
        sq = db_sq.reshape(t_all, SUB)[tile_idx].reshape(qp, m * SUB)
        s2 = qsq[:, None] + sq - 2.0 * dots
    elif mode == "dot":
        s2 = -dots
    else:
        qinv_i = torch.where(qn == 0.0, 0.0, 1.0 / qn)
        rn = db_norms.reshape(t_all, SUB)[tile_idx].reshape(qp, m * SUB)
        rinv_i = torch.where(rn == 0.0, 0.0, 1.0 / rn)
        s2 = -(dots * qinv_i[:, None] * rinv_i)
    s2 = torch.where(vld, s2, float("inf"))
    sk, pos = torch.topk(s2, k, dim=1, largest=False)
    w = s2[:, (m - 1) * SUB:].amin(dim=1)
    return sk, pos, w


def _scores_to_dists(sk, mode: str):
    """Refined top-k scores -> metric distances (one copy shared by every
    pipeline tail). Non-finite scores map to +inf."""
    inf = float("inf")
    if mode == "euclidean":
        return torch.where(torch.isfinite(sk),
                           torch.sqrt(torch.clamp(sk, min=0.0)), inf)
    if mode == "dot":
        return sk
    return torch.where(torch.isfinite(sk),
                       1.0 + torch.clamp(sk, -1.0, 1.0), inf)


def _xmax(db_sq, valid):
    return torch.sqrt(torch.where(valid, db_sq, 0.0).max())


def _xnmin(db_norms, valid):
    return torch.where(valid & (db_norms > 0.0), db_norms,
                       float("inf")).min()


def _dispatch_src(db, db_hi, scales):
    """(src, array the coarse kernel reads): int8 codes (scales given),
    a bf16-stored database (its own hi mirror), an explicit hi mirror, or
    the f32 rows (split on chip). The JAX package's ladder; its "bf16"
    source runs the mirrors kernel over ``db``, as here."""
    if scales is not None:
        if db.dtype != torch.int8:
            raise ValueError("scales= requires an int8 code matrix")
        return "int8", db
    if db.dtype == torch.int8:
        raise ValueError("int8 code matrix requires scales=")
    if db.dtype == torch.bfloat16 and (db_hi is None or db_hi is db):
        return "mirrors", db
    if db_hi is not None:
        return "mirrors", db_hi
    return "f32", db


# ---------------------------------------------------------------------------
# 1-pass certified exact pipeline (tier 1) and 1-pass fast mode
# ---------------------------------------------------------------------------

def _exact1p_pool(k: int, t_all: int) -> tuple[int, int]:
    """(m2 supers, m tiles) for the 1-pass certified refine pool (the
    JAX package's formula and measured knees, unchanged)."""
    t2 = t_all // SUPER
    coeff = 1.7 if SUB * int(k) <= 256 else 2.5
    slack = max(22, int(coeff * (SUB * int(k)) ** 0.5) + 1)
    m = min(max(32, int(k) + slack), t_all)
    m2 = min(max(32, int(k) + slack), t2)
    return m2, min(m, m2 * SUPER)


def _fast1p_pool(k: int, t_all: int) -> tuple[int, int]:
    """(m2 supers, m tiles) for the 1-pass FAST pool, with m2 = m so the
    containment argument makes tile selection exact over the coarse
    scores (the JAX package's formula, unchanged)."""
    slack = max(6, int(0.45 * (SUB * int(k)) ** 0.5))
    m = min(max(16, int(k) + slack), t_all)
    m2 = min(m, t_all // SUPER) if t_all // SUPER >= 1 else 1
    return m2, min(m, m2 * SUPER)


def _coarse_search_1p(queries, db, db_sq, db_norms, valid, src, src_arr,
                      elo_max, mode: str, k: int, m2: int, m: int,
                      with_cert: bool, scales=None):
    qp, d = queries.shape
    t_all = db.shape[0] // SUB
    qThi, qlo, qsq, qn, qrow, col, inv_col = _query_terms(
        queries, db_sq, db_norms, valid, mode)
    tile_tq, sup_tq = _minima_1p_sup(
        qThi, qrow, src_arr, col, inv_col, mode, src,
        None if scales is None else scales.reshape(1, -1))
    tile_idx, b = _select_tiles_1p(tile_tq, sup_tq, qp, t_all, m2, m)
    sk, pos, _ = _refine_topk(tile_idx, queries, qsq, qn, db, db_sq,
                              db_norms, valid, mode, m, k, scales)
    idx_out = torch.gather(_candidates(tile_idx), 1, pos)
    dists = _scores_to_dists(sk, mode)
    if not with_cert:
        return dists, idx_out, torch.zeros(qp, dtype=torch.bool,
                                           device=queries.device)

    # rigorous per-query margin from computed residual norms (the JAX
    # package's derivation, coarse_kernel.py:911-932). 4x accumulation
    # term: the requirement is 2*e_coarse + 2*e_refine, each bounded by
    # one term; _accum_coeff scales it by the body that ran the pass.
    qlo_n = torch.sqrt((qlo * qlo).sum(dim=0))                  # (Qp,)
    xmax = _xmax(db_sq, valid)
    acc = 4.0 * _accum_coeff(_coarse_body(src, src_arr, 1, True))
    err_dot = (elo_max * (qn + qlo_n) + xmax * qlo_n
               + acc * d * 2.0 ** -24 * (xmax + elo_max) * (qn + qlo_n))
    if mode == "euclidean":
        margin = _MARGIN_SCALE_EUCLID * err_dot
        smax = qsq + xmax * (xmax + 2.0 * qn)   # |live coarse score| bound
    elif mode == "dot":
        margin = _MARGIN_SCALE_DOT * err_dot
        smax = xmax * qn * 1.001
    else:
        qinv_m = torch.where(qn == 0.0, float("inf"), 1.0 / qn)
        margin = _MARGIN_SCALE_DOT * err_dot * qinv_m / _xnmin(db_norms,
                                                               valid)
        smax = torch.full_like(qn, 2.0)
    # additive-PENALTY masking is sound only while live coarse scores stay
    # far below PENALTY; extreme-magnitude data takes the fallback
    sane = smax < 0.25 * PENALTY
    last = sk[:, -1]
    # non-finite last = fewer than k live rows in the pool: certified only
    # when the boundary itself is dead (hierarchical selection can strand
    # live tiles in non-selected supers)
    certified = sane & torch.where(torch.isfinite(last), last <= b - margin,
                                   b >= 0.5 * PENALTY)
    return dists, idx_out, certified


def coarse_search_1p(queries, db, db_sq, db_norms, valid, db_hi, elo_max,
                     metric: DistanceMetric, k: int, scales=None):
    """1-pass certified-exact search: (dists, idx, certified).

    ``elo_max`` is an upper bound on max_r |row_r - bf16(row_r)| (the
    index maintains it; stale-high is safe — the margin only widens).
    With ``db_hi is None`` the f32-source kernel K4 streams the f32 rows
    and rounds them on chip; a bf16 ``db`` is its own hi mirror. With
    ``scales`` given (int8 storage), ``db`` is the int8 code matrix and
    K7 searches the stored values code * pow2-scale exactly (pass
    elo_max = 0). Uncertified queries must be re-run by the caller
    through the next exact tier."""
    src, src_arr = _dispatch_src(db, db_hi, scales)
    m2, m = _exact1p_pool(k, db.shape[0] // SUB)
    return _coarse_search_1p(queries, db, db_sq, db_norms, valid, src,
                             src_arr, elo_max, _metric_mode(metric.value),
                             int(k), m2, m, True, scales)


def coarse_search_1p_fast(queries, db, db_sq, db_norms, valid, db_hi,
                          metric: DistanceMetric, k: int):
    """1-pass FAST search: (dists, idx) — approximate ids (exact top-m
    tile selection over single-bf16-pass coarse scores), exact distances
    over the refined pool, no certificate. Same source dispatch as
    coarse_search_1p minus int8 (int8 storage always serves the certified
    tier — it is already a single pass)."""
    if db.dtype == torch.int8:
        raise ValueError(
            "int8 codes serve the certified tier (coarse_search_1p with "
            "scales=) — it is already a single pass")
    src, src_arr = _dispatch_src(db, db_hi, None)
    m2, m = _fast1p_pool(k, db.shape[0] // SUB)
    dists, idx, _ = _coarse_search_1p(
        queries, db, db_sq, db_norms, valid, src, src_arr, 0.0,
        _metric_mode(metric.value), int(k), m2, m, False)
    return dists, idx


# ---------------------------------------------------------------------------
# bf16x3 certified pipeline (tier 2) and the single-pass legacy fast one
# ---------------------------------------------------------------------------

def coarse_search(queries, db, db_sq, db_norms, valid, db_hi, db_lo,
                  metric: DistanceMetric, k: int, exact: bool = True):
    """(dists (Q,k) asc, idx (Q,k), certified (Q,) bool).

    ``exact=True`` runs the bf16x3 certified pipeline (K3 over the
    mirrors, or K5 at 3 passes over the f32 rows when ``db_hi is None``);
    ``exact=False`` the single-pass legacy fast pipeline (K6 over the hi
    mirror, or K5 at 1 pass), whose certified output is all False. The
    JAX package's fast variant selects tiles with ``approx_min_k``; the
    port selects them exactly, so its recall is no lower."""
    mode = _metric_mode(metric.value)
    d = queries.shape[1]
    t = db.shape[0] // SUB
    if exact:
        # order-statistics cushion (the bf16x3 margin is tiny, so a
        # ~1.5x-sqrt slack suffices; uncertified queries still fall back)
        slack = max(6, int(1.5 * (SUB * int(k)) ** 0.5) + 1)
        m_tiles = min(max(16, int(k) + slack), t)
        if db_hi is not None and db_lo is None:
            # bf16 storage has no lo mirror: lo = hi would double-count
            # hi.qhi under a certificate that still passes
            raise ValueError("the bf16x3 pipeline needs a lo mirror")
    else:
        slack = max(2, int((SUB * int(k)) ** 0.5))
        m_tiles = min(max(12, int(k) + slack), t)
    qThi, qlo, qsq, qn, qrow, col, inv_col = _query_terms(
        queries, db_sq, db_norms, valid, mode)
    qTlo = qlo.to(torch.bfloat16)
    if db_hi is None:
        minima = _coarse_minima_f32(qThi, qTlo, qrow, db, col, inv_col,
                                    3 if exact else 1, mode)
    elif exact:
        minima = _coarse_minima(qThi, qTlo, qrow, db_hi, db_lo, col,
                                inv_col, 3, mode)
    else:
        minima = _coarse_minima_1p(qThi, qrow, db_hi, col, inv_col, mode)
    # the certificate's proof needs the TRUE m best tiles: exact top-k
    tile_idx = torch.topk(minima, m_tiles, dim=1, largest=False)[1]
    sk, pos, w = _refine_topk(tile_idx, queries, qsq, qn, db, db_sq,
                              db_norms, valid, mode, m_tiles, int(k))
    idx_out = torch.gather(_candidates(tile_idx), 1, pos)
    dists = _scores_to_dists(sk, mode)
    if not exact:
        return dists, idx_out, torch.zeros(qsq.shape[0], dtype=torch.bool,
                                           device=queries.device)

    # per-query certification (bf16x3): non-selected tiles' true minima
    # >= (m-th tile's refined min) - margin. The d·2^-24 accumulation term
    # is scaled by the coarse body's coefficient (_accum_coeff), asked of
    # the arrays the launch was given (K3 reads both mirrors).
    body = (_coarse_body("f32", db, 3, False) if db_hi is None
            else _coarse_body("mirrors", db_hi, 3, False, db_lo))
    eps = 2.0 ** -17 + _accum_coeff(body) * d * 2.0 ** -24
    xmax = _xmax(db_sq, valid)
    if mode == "euclidean":
        margin = 8.0 * eps * qn * xmax                  # d2 error x2, safety 2
        smax = qsq + xmax * (xmax + 2.0 * qn)
    elif mode == "dot":
        margin = 4.0 * eps * qn * xmax
        smax = xmax * qn * 1.001
    else:
        margin = (4.0 * eps * xmax / _xnmin(db_norms, valid)).expand_as(qn)
        smax = torch.full_like(qn, 2.0)
    sane = smax < 0.25 * PENALTY
    last = sk[:, -1]
    # a non-finite k-th score means fewer than k live candidates; with
    # m_tiles >= k every live row is then already a candidate
    certified = sane & torch.where(torch.isfinite(last), last <= w - margin,
                                   True)
    return dists, idx_out, certified


# ---------------------------------------------------------------------------
# mirror maintenance
# ---------------------------------------------------------------------------

def split_hi_lo(db: torch.Tensor):
    """Derive the kernel's bf16 hi/lo database mirrors from the f32 rows
    (round to nearest even, as XLA's convert)."""
    hi = db.to(torch.bfloat16)
    lo = (db - hi.float()).to(torch.bfloat16)
    return hi, lo


def residual_max_norm(db: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Upper bound max_r |db_r - hi_r| for the 1-pass certificate."""
    resid = db - hi.float()
    return torch.sqrt((resid * resid).sum(dim=1).max())


def residual_max_norm_f32(db: torch.Tensor) -> torch.Tensor:
    """residual_max_norm with the bf16 split done on the fly (the
    f32-source store keeps no hi mirror)."""
    return residual_max_norm(db, db.to(torch.bfloat16))


def scatter_hi_lo(hi, lo, idx, rows_f32):
    """Patch the hi/lo mirrors in place for dirty rows."""
    rhi, rlo = split_hi_lo(rows_f32)
    return hi.index_copy_(0, idx, rhi), lo.index_copy_(0, idx, rlo)


def scatter_hi_lo_copy(hi, lo, idx, rows_f32):
    """scatter_hi_lo on fresh copies (a search may still read the old)."""
    return scatter_hi_lo(hi.clone(), lo.clone(), idx, rows_f32)


__all__ = ["coarse_search", "coarse_search_1p", "coarse_search_1p_fast",
           "split_hi_lo", "scatter_hi_lo", "scatter_hi_lo_copy", "supports",
           "supports_1p", "supports_1p_int8", "residual_max_norm",
           "residual_max_norm_f32", "SUB", "SUPER", "MAX_K", "PENALTY"]
