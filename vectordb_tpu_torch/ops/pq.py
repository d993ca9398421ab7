"""Product Quantization primitives: training, encoding, decode, scan,
re-rank.

Port of ``vectordb_tpu/ops/pq.py``: PQ-Flat's and IVF-PQ's device
programs. The numpy-only pieces (``fit_opq_rotation``,
``pack_codebook``, ``pq_distortion``) are the port's own copies: importing
them from the JAX module would load JAX.

  * training: M independent ksub-way k-means fits advance in lockstep as
    batched tensor ops on the index's device, seeded by a
    ``torch.Generator`` (the streams differ from ``jax.random``: parity
    tests import the JAX package's trained state). Cluster sums are a
    one-hot f32 product, deterministic on the card, where ``index_add_``
    would not be.
  * encoding: chunked batched argmin over subspace codebooks (first index
    on ties, as ``jnp.argmin``); f32 products at IEEE precision.
  * decode (kernel K8): uint8 codes -> bf16 rows, bit for bit the
    codewords. On the TPU it was a one-hot matmul against the packed
    block-diagonal codebook (the MXU's way to a table lookup); on Hopper
    it is the lookup itself (``csrc/pq_decode.cu``). A CUDA tensor
    launches the kernel at any row count, a CPU tensor takes the plain
    version; nothing falls back from one to the other.
  * scan: each chunk of codes is decoded, scored against the hi/lo bf16
    query split by two bf16 products that come out in f32, and reduced to
    its exact top r; one more exact top r over the pooled candidates
    finishes the selection. The JAX package's ``lax.approx_min_k`` has no
    counterpart: exact per-chunk top r followed by an exact pooled top r
    is the exact global top r of the scores for any chunk size.
  * IVF-PQ scan (``ivfpq_scan_topr``): the same over the IVF layout's
    cluster-aligned chunks, each decoded row a residual on its cluster's
    centroid; one (Q, nlist) pair of products gives every cluster's q.c.
  * re-rank: exact f32 distances of the candidate rows in the direct
    forms (difference form for euclidean), on the device that holds them.
"""

from __future__ import annotations

import torch

from ..distance import DistanceMetric
from . import cuda_kernels

_OPQ_COV_ROWS = 65536
_RERANK_DEV_QBLK = 512   # queries per gather block of pq_rerank_topk


def fit_opq_rotation(sample, m: int) -> "np.ndarray":
    """PCA + eigenvalue-balanced subspace allocation: the pre-rotation
    approximation of Optimized Product Quantization (Ge et al., CVPR'13).
    Returns R (d, d) f32 with columns = permuted eigenvectors; rows and
    queries rotate as ``x @ R``. Host-only numpy, the JAX package's code
    line for line (same arrays on the same host)."""
    import heapq

    import numpy as np
    x = np.asarray(sample, np.float32)
    n, d = x.shape
    dsub = d // m
    if n > _OPQ_COV_ROWS:
        x = x[:: n // _OPQ_COV_ROWS][:_OPQ_COV_ROWS]
    cov = (x.T @ x) / np.float32(max(len(x), 1))
    w, v = np.linalg.eigh(cov.astype(np.float64))
    order = np.argsort(w)[::-1]
    w, v = w[order], v[:, order]
    # greedy balanced allocation: next (largest) eigenvalue goes to the
    # non-full bucket with the smallest log-eigenvalue load
    buckets: list[list[int]] = [[] for _ in range(m)]
    heap = [(0.0, j) for j in range(m)]
    heapq.heapify(heap)
    for i in range(d):
        while True:
            load, j = heapq.heappop(heap)
            if len(buckets[j]) < dsub:
                break
        buckets[j].append(i)
        if len(buckets[j]) < dsub:
            heapq.heappush(
                heap, (load + float(np.log(max(w[i], 1e-12))), j))
    cols = [i for j in range(m) for i in buckets[j]]
    return np.ascontiguousarray(v[:, cols], np.float32)


def _maybe_rotate(x: torch.Tensor, rot) -> torch.Tensor:
    """x @ R at IEEE f32 (distance.prepare_device pins TF32 off)."""
    if rot is None:
        return x
    return x.float() @ rot


def _subspace_view(rows: torch.Tensor, m: int) -> torch.Tensor:
    """(S, d) -> (m, S, dsub): subspace-major view of row blocks."""
    s, d = rows.shape
    return rows.reshape(s, m, d // m).permute(1, 0, 2)


def _kmeanspp_init(sub: torch.Tensor, gen: torch.Generator,
                   ksub: int) -> torch.Tensor:
    """Batched k-means++ (D^2 sampling, Gumbel-max over log D^2):
    (m, S, dsub) -> (m, ksub, dsub). Duplicate row patterns are never
    double-picked (their D^2 is 0)."""
    m, s, dsub = sub.shape
    dev = sub.device
    first = int(torch.randint(0, s, (1,), generator=gen, device=dev))
    prev = sub[:, first, :]                                 # (m, dsub)
    picks = [prev]
    mind = torch.full((m, s), float("inf"), dtype=torch.float32, device=dev)
    ar = torch.arange(m, device=dev)
    for _ in range(ksub - 1):
        d = ((sub - prev[:, None, :]) ** 2).sum(-1)         # (m, S)
        mind = torch.minimum(mind, d)
        u = torch.rand((m, s), generator=gen, device=dev)
        g = -torch.log(-torch.log(u.clamp_min(1e-20)))
        idx = torch.argmax(torch.log(torch.clamp(mind, min=1e-30)) + g, dim=1)
        prev = sub[ar, idx, :]
        picks.append(prev)
    return torch.stack(picks, dim=1)


def pq_fit(sample: torch.Tensor, gen: torch.Generator, m: int, ksub: int,
           iters: int, chunk: int, rot=None) -> torch.Tensor:
    """Batched subspace k-means: (S, d) f32 -> codebook (m, ksub, dsub)
    f32 holding bf16 values, on ``sample``'s device. With ``rot``
    (fit_opq_rotation output, a tensor) the fit runs in the rotated space.

    Init is batched k-means++ on a strided subsample; Lloyd assignment is
    chunked over rows to bound the (m, chunk, ksub) score tensor; cluster
    sums and counts are one-hot f32 products (deterministic, unlike a
    scatter-add); empty clusters re-seed to a random sample row each
    iteration. ``sample`` rows must be a multiple of ``chunk``."""
    s, d = sample.shape
    if s % chunk:
        raise ValueError(f"sample rows {s} not a multiple of chunk {chunk}")
    dsub = d // m
    dev = sample.device
    sample = _maybe_rotate(sample.float(), rot)
    sub = _subspace_view(sample, m)                         # (m, S, dsub)
    s_init = min(s, max(8 * ksub, 4096))
    stride = max(1, s // s_init)
    codebook = _kmeanspp_init(
        sub[:, ::stride, :][:, :s_init, :].contiguous(), gen, ksub)
    iota = torch.arange(ksub, device=dev)
    for _ in range(iters):
        cnorm = (codebook * codebook).sum(-1)               # (m, ksub)
        sums = torch.zeros((m, ksub, dsub), dtype=torch.float32, device=dev)
        cnts = torch.zeros((m, ksub), dtype=torch.float32, device=dev)
        for c0 in range(0, s, chunk):
            xc = sub[:, c0:c0 + chunk, :]                   # (m, chunk, dsub)
            scores = (-2.0 * torch.bmm(xc, codebook.transpose(1, 2))
                      + cnorm[:, None, :])
            a = torch.argmin(scores, dim=-1)                # (m, chunk)
            oh = (a[..., None] == iota).float()             # (m, chunk, ksub)
            sums += torch.bmm(oh.transpose(1, 2), xc)
            cnts += oh.sum(1)
        new = sums / torch.clamp(cnts, min=1.0)[..., None]
        pick = torch.randint(0, s, (ksub,), generator=gen, device=dev)
        reseed = _subspace_view(sample[pick], m)
        codebook = torch.where(cnts[..., None] > 0.0, new, reseed)
    # round the codewords to bf16 VALUES: this makes the scan's bf16
    # decode exact (the JAX package's reasoning, ops/pq.py:212-218)
    return codebook.to(torch.bfloat16).float()


def pq_encode(rows: torch.Tensor, codebook: torch.Tensor, chunk: int,
              rot=None) -> torch.Tensor:
    """(N, d) f32 rows -> (N, m) uint8 codes (nearest codeword per
    subspace, first index on ties), chunked over rows; N must be a
    multiple of ``chunk``. With ``rot`` the rows are rotated into the
    codebook's OPQ space first."""
    n, d = rows.shape
    if n % chunk:
        raise ValueError(f"rows {n} not a multiple of chunk {chunk}")
    m, ksub, dsub = codebook.shape
    cnorm = (codebook * codebook).sum(-1)
    sub = _subspace_view(_maybe_rotate(rows.float(), rot), m)
    cbT = codebook.transpose(1, 2)
    out = torch.empty((n, m), dtype=torch.uint8, device=rows.device)
    for c0 in range(0, n, chunk):
        scores = (-2.0 * torch.bmm(sub[:, c0:c0 + chunk, :], cbT)
                  + cnorm[:, None, :])
        out[c0:c0 + chunk] = torch.argmin(scores, dim=-1).T.to(torch.uint8)
    return out


def pack_codebook(codebook, lane: int = 128):
    """Regroup the (m, ksub, dsub) codebook into block-diagonal decode
    matrices (bd (g, spg*ksub, spg*dsub) f32, spg), numpy, as the JAX
    package packs it for its MXU decode. Nothing in the port's path reads
    this form (its decode is a lookup in the (m, ksub, dsub) table): it is
    kept to carry a packed codebook across and to hold the two packages'
    packings equal."""
    import numpy as np
    cb = np.asarray(codebook, dtype=np.float32)
    m, ksub, dsub = cb.shape
    spg = max(1, min(m, lane // max(dsub, 1)))
    while m % spg:
        spg -= 1
    g = m // spg
    bd = np.zeros((g, spg * ksub, spg * dsub), np.float32)
    cbg = cb.reshape(g, spg, ksub, dsub)
    for s in range(spg):
        bd[:, s * ksub:(s + 1) * ksub, s * dsub:(s + 1) * dsub] = cbg[:, s]
    return bd, spg


def _decode_rows_plain(codes: torch.Tensor, cb: torch.Tensor) -> torch.Tensor:
    """Plain K8: (rows, m) uint8 codes, (m, ksub, dsub) bf16 codebook ->
    (rows, m*dsub) bf16, row i's subspace c = codeword codes[i, c]."""
    rows, m = codes.shape
    ar = torch.arange(m, device=codes.device)
    return cb[ar, codes.long()].reshape(rows, m * cb.shape[2])


def pq_decode_rows(codes: torch.Tensor, cb_bf: torch.Tensor) -> torch.Tensor:
    """(rows, m) uint8 codes (each < ksub) -> (rows, d) bf16 decoded rows,
    bit for bit the codewords of ``cb_bf`` (m, ksub, dsub) bf16 (exact:
    pq_fit rounds codewords to bf16 values). Any row count. K8 for a
    CUDA tensor, its plain version for a CPU one."""
    if codes.is_cuda:
        return cuda_kernels.pq_decode(codes, cb_bf)
    return _decode_rows_plain(codes, cb_bf)


def _decode_block(codes: torch.Tensor, cb_bf: torch.Tensor,
                  cnorm: torch.Tensor):
    """(rows, m) uint8 codes -> ((rows, d) bf16 decoded rows (K8), (rows,)
    f32 decoded-row sq-norms). The norm comes exactly from the
    codeword-norm table ``cnorm`` (m, ksub): the subspaces are disjoint
    coordinates, so |x_hat|^2 = sum_c |codeword_c|^2 — the same on every
    device, whatever decode produced the rows."""
    m = codes.shape[1]
    ar = torch.arange(m, device=codes.device)
    return pq_decode_rows(codes, cb_bf), cnorm[ar, codes.long()].sum(1)


def _split_query(queries: torch.Tensor):
    """f32 queries -> (hi, lo) bf16 pair with hi + lo == q to ~2^-16
    relative: two bf16 passes recover the f32 query dot past the neighbor
    gaps that plain bf16 rounding of q would blur."""
    q32 = queries.float()
    q_hi = q32.to(torch.bfloat16)
    q_lo = (q32 - q_hi.float()).to(torch.bfloat16)
    return q_hi, q_lo


def _score_dots(q_hi: torch.Tensor, q_lo: torch.Tensor,
                decoded: torch.Tensor) -> torch.Tensor:
    """(Q, chunk) f32 query-row dots ``q_hi . x + q_lo . x`` of bf16
    operands, as the JAX package's matmuls with preferred_element_type=f32.
    The products must come out in f32: torch's bf16 matmul returns bf16,
    which rounds the scores to 8 mantissa bits. On the card each product
    is one bf16 GEMM with f32 output (``out_dtype``); on the CPU, where
    that op does not exist, the operands widen exactly to f32."""
    dt = decoded.T
    if decoded.is_cuda:
        return (torch.mm(q_hi, dt, out_dtype=torch.float32)
                + torch.mm(q_lo, dt, out_dtype=torch.float32))
    d32 = dt.float()
    return q_hi.float() @ d32 + q_lo.float() @ d32


def pq_scan_topr(queries: torch.Tensor, codes: torch.Tensor,
                 cb_bf: torch.Tensor, cnorm: torch.Tensor,
                 valid: torch.Tensor, metric: DistanceMetric, r: int,
                 chunk: int, rot=None):
    """Streaming PQ scan -> top-r candidate ROWS per query.

    queries (Q, d) f32 · codes (N, m) uint8 · cb_bf (m, ksub, dsub) bf16
    codebook (the JAX op takes pack_codebook's block-diagonal form of it) ·
    cnorm (m, ksub) f32 codeword sq-norms · valid (N,) bool. N must be a
    multiple of ``chunk``; r <= chunk. The JAX op's ``recall_target`` has
    no counterpart: selection is exact here.

    Per chunk: K8 decodes the codes to bf16 rows, two bf16 products with
    f32 output score them against the hi/lo query split, and an exact
    top r keeps the chunk's best; one exact top r over the (Q, nc*r) pool
    finishes. Scores are rank surrogates (per-query constants dropped):
    |x|^2 - 2 q.x (euclidean, |x|^2 exact from the codeword norms), -q.x
    (dot), -q.x / |x| (cosine). Returns (scores (Q, r) ascending, slots
    (Q, r) int64); +inf marks dead/masked slots."""
    n, m = codes.shape
    if n % chunk:
        raise ValueError(f"codes rows {n} must be a multiple of "
                         f"chunk {chunk}")
    if r > chunk:
        raise ValueError(f"r={r} exceeds chunk={chunk}")
    q_hi, q_lo = _split_query(_maybe_rotate(queries.float(), rot))
    vals, idx = [], []
    for c0 in range(0, n, chunk):
        decoded, xsq = _decode_block(codes[c0:c0 + chunk], cb_bf, cnorm)
        scores = torch.where(valid[None, c0:c0 + chunk],
                             _metric_scores(_score_dots(q_hi, q_lo, decoded),
                                            xsq, metric), float("inf"))
        cv, cl = torch.topk(scores, r, dim=1, largest=False)
        vals.append(cv)
        idx.append(cl + c0)
    vals = torch.cat(vals, dim=1)
    idx = torch.cat(idx, dim=1)
    fv, pos = torch.topk(vals, r, dim=1, largest=False)
    return fv, torch.gather(idx, 1, pos)


def _metric_scores(dots: torch.Tensor, xsq: torch.Tensor,
                   metric: DistanceMetric) -> torch.Tensor:
    """(Q, n) f32 query-row dots and (n,) row sq-norms -> the scan's rank
    surrogates (per-query constants dropped)."""
    if metric is DistanceMetric.DOT_PRODUCT:
        return -dots
    if metric is DistanceMetric.EUCLIDEAN:
        return xsq[None, :] - 2.0 * dots                  # + |q|^2 dropped
    xnorm = torch.sqrt(torch.clamp(xsq, min=1e-30))
    return -dots / xnorm[None, :]                         # / |q| dropped


def ivfpq_scan_topr(queries: torch.Tensor, codes: torch.Tensor,
                    cb_bf: torch.Tensor, cnorm: torch.Tensor,
                    valid: torch.Tensor, cents: torch.Tensor,
                    csq: torch.Tensor, cid_sp: torch.Tensor,
                    metric: DistanceMetric, r: int, cpc: int, span: int,
                    nlist: int, rot=None):
    """Residual-corrected streaming PQ scan over an IVF slot layout ->
    top-r candidate rows per query.

    A row decodes as ``x_hat = c + r_hat``: ``c`` the centroid of its
    cluster (constant over each ``span``-row cluster block of the IVF
    repack) and ``r_hat`` its PQ-decoded residual. Rows [0, nlist*span)
    are the cluster blocks, streamed in chunks of ``cpc * span`` rows (a
    cluster count that does not fill the last chunk runs once, padded with
    dead rows); rows [nlist*span, N) are the spill region, scored densely,
    each row's residual taken against its nearest centroid ``cid_sp``
    (S,) int32 (garbage for dead slots, which are masked).

    queries (Q, d) f32 · codes (N, m) uint8 · cb_bf (m, ksub, dsub) bf16 ·
    cnorm (m, ksub) f32 · valid (N,) bool · cents (nlist, d) f32 holding
    bf16 values (the OPQ-rotated table under ``rot``) · csq (nlist,) f32
    their sq-norms. Centroids and codewords are bf16 values and the
    queries split hi/lo, so every term carries only f32 accumulation
    rounding; each bf16 product comes out in f32 (``_score_dots``; a
    row-wise product widens its bf16 operands exactly):

    * ``q . x_hat = q . c + q . r_hat``: ``q . c`` from one (Q, nlist)
      pair of products, each cluster's column shared by its ``span`` rows
      (the spill rows gather their centroid's column); ``q . r_hat`` from
      the chunk's decode (K8) and two products;
    * ``|x_hat|^2 = |c|^2 + 2 c . r_hat + |r_hat|^2``: ``|r_hat|^2``
      exactly from the codeword norms, ``c . r_hat`` a row-wise product.

    Selection is exact (an exact top r a chunk, then over the pool); the
    JAX op's ``approx_min_k`` and ``recall_target`` have no counterpart.
    Returns (scores (Q, r_out) ascending, slots (Q, r_out) int64),
    ``r_out = min(r, pooled candidates)``; +inf marks dead/masked slots."""
    n, m = codes.shape
    big_m = nlist * span
    s_rows = n - big_m
    chunk = cpc * span
    if r > chunk:
        raise ValueError(f"r={r} exceeds chunk={chunk}")
    q, d = queries.shape
    q_hi, q_lo = _split_query(_maybe_rotate(queries.float(), rot))
    nfull = big_m // chunk
    tail_cl = nlist - nfull * cpc
    # pad the centroid tables to the chunk grid: the tail chunk must never
    # read a real cluster's centroid
    nlist_pad = (nfull + (1 if tail_cl else 0)) * cpc
    cents_bf = cents.to(torch.bfloat16)           # exact: values are bf16
    csq = csq.float()
    if nlist_pad != nlist:
        cents_bf = torch.cat([cents_bf, cents_bf.new_zeros(
            (nlist_pad - nlist, d))])
        csq = torch.cat([csq, csq.new_zeros(nlist_pad - nlist)])
    qc = _score_dots(q_hi, q_lo, cents_bf)        # (Q, nlist_pad), once
    inf = float("inf")

    def chunk_scores(cc, vc, c0):
        """Scores of one cluster-aligned chunk starting at cluster c0."""
        decoded, rsq = _decode_block(cc, cb_bf, cnorm)
        cen = cents_bf[c0:c0 + cpc].float()
        cr = torch.bmm(decoded.view(cpc, span, d).float(),
                       cen[:, :, None])[..., 0]                # (cpc, span)
        xsq = (csq[c0:c0 + cpc, None] + 2.0 * cr
               + rsq.view(cpc, span)).reshape(chunk)
        dots = (_score_dots(q_hi, q_lo, decoded).view(q, cpc, span)
                + qc[:, c0:c0 + cpc, None]).view(q, chunk)
        return torch.where(vc[None, :], _metric_scores(dots, xsq, metric),
                           inf)

    vals, idx = [], []
    for j in range(nfull):
        r0 = j * chunk
        scores = chunk_scores(codes[r0:r0 + chunk], valid[r0:r0 + chunk],
                              j * cpc)
        cv, cl = torch.topk(scores, r, dim=1, largest=False)
        vals.append(cv)
        idx.append(cl + r0)
    if tail_cl:
        t0 = nfull * chunk
        trows = tail_cl * span
        cc = torch.cat([codes[t0:t0 + trows],
                        codes.new_zeros((chunk - trows, m))])
        vc = torch.cat([valid[t0:t0 + trows],
                        valid.new_zeros(chunk - trows)])
        scores = chunk_scores(cc, vc, nfull * cpc)
        cv, cl = torch.topk(scores, min(r, trows), dim=1, largest=False)
        vals.append(cv)
        idx.append(cl + t0)
    if s_rows:
        dec_sp, rsq_sp = _decode_block(codes[big_m:], cb_bf, cnorm)
        cid = torch.clamp(cid_sp, 0, nlist - 1).long()
        cen_sp = cents_bf[cid].float()                         # (S, d)
        cr_sp = (dec_sp.float() * cen_sp).sum(1)
        xsq = csq[cid] + 2.0 * cr_sp + rsq_sp
        dots = _score_dots(q_hi, q_lo, dec_sp) + qc[:, cid]
        scores = torch.where(valid[None, big_m:],
                             _metric_scores(dots, xsq, metric), inf)
        cv, cl = torch.topk(scores, min(r, s_rows), dim=1, largest=False)
        vals.append(cv)
        idx.append(cl + big_m)
    vals = torch.cat(vals, dim=1)
    idx = torch.cat(idx, dim=1)
    # a tiny index can pool fewer than r candidates: return what exists
    fv, pos = torch.topk(vals, min(r, vals.shape[1]), dim=1, largest=False)
    return fv, torch.gather(idx, 1, pos)


def _exact_dists(rows: torch.Tensor, qb: torch.Tensor,
                 metric: DistanceMetric) -> torch.Tensor:
    """(Q, r, d) candidate rows, (Q, d) queries -> (Q, r) exact f32
    distances in the direct forms of the host re-rank."""
    if metric is DistanceMetric.EUCLIDEAN:
        diff = rows - qb[:, None, :]
        return torch.sqrt((diff * diff).sum(-1))
    dots = torch.bmm(rows, qb[:, :, None])[..., 0]
    if metric is DistanceMetric.DOT_PRODUCT:
        return -dots
    qn = torch.sqrt((qb * qb).sum(1))[:, None]
    xn = torch.sqrt((rows * rows).sum(-1))
    denom = torch.clamp(qn * xn, min=1e-30)
    return 1.0 - torch.clamp(dots / denom, -1.0, 1.0)


def pq_rerank_topk(queries: torch.Tensor, rows: torch.Tensor,
                   slots: torch.Tensor, scan_scores: torch.Tensor,
                   valid: torch.Tensor, metric: DistanceMetric, k: int):
    """Exact f32 re-rank of PQ scan candidates on the device that holds
    the rows: gather the candidate rows, exact distances, mask dead
    candidates (+inf scan score or invalid slot), top-k. Returns (dists
    (Q, k) f32 ascending with +inf tail, slots (Q, k)). Queries go in
    _RERANK_DEV_QBLK blocks so the (blk, r, d) gather stays bounded."""
    q, r = slots.shape
    outs_d, outs_s = [], []
    for a in range(0, q, _RERANK_DEV_QBLK):
        sl = slots[a:a + _RERANK_DEV_QBLK]
        ok = torch.isfinite(scan_scores[a:a + _RERANK_DEV_QBLK]) & valid[sl]
        dist = _exact_dists(rows[sl], queries[a:a + _RERANK_DEV_QBLK],
                            metric)
        dist = torch.where(ok, dist, float("inf"))
        v, pos = torch.topk(dist, k, dim=1, largest=False)
        outs_d.append(v)
        outs_s.append(torch.gather(sl, 1, pos))
    return torch.cat(outs_d), torch.cat(outs_s)


def pq_rerank_gathered(queries: torch.Tensor, rows: torch.Tensor,
                       ok: torch.Tensor, metric: DistanceMetric, k: int):
    """Exact f32 re-rank of host-gathered candidate rows on the device:
    queries (Qb, d), rows (Qb, r, d), ok (Qb, r) bool -> (dists (Qb, k)
    ascending with +inf tail, positions (Qb, k) into the r axis)."""
    dist = torch.where(ok, _exact_dists(rows, queries, metric),
                       float("inf"))
    return torch.topk(dist, k, dim=1, largest=False)


def pq_distortion(rows, codebook, codes) -> float:
    """Mean squared reconstruction error (host-side numpy diagnostic)."""
    import numpy as np
    m, ksub, dsub = codebook.shape
    rec = np.concatenate(
        [np.asarray(codebook)[j, np.asarray(codes)[:, j]]
         for j in range(m)], axis=1)
    diff = np.asarray(rows, dtype=np.float32) - rec
    return float(np.mean(np.sum(diff * diff, axis=1)))


__all__ = ["fit_opq_rotation", "pq_fit", "pq_encode", "pack_codebook",
           "pq_decode_rows", "pq_scan_topr", "ivfpq_scan_topr",
           "pq_rerank_topk", "pq_rerank_gathered", "pq_distortion"]
