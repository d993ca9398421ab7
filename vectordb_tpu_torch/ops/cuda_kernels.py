"""Build, load and wrap the hand-written Hopper kernels (csrc/*.cu).

The sources are compiled at first use with ``nvcc`` for ``sm_90a`` into
one shared library with a plain C interface, cached under
``vectordb_tpu_torch/_build/`` by a hash of the sources, and loaded with
ctypes. Nothing is built or loaded when this module is imported, so the
CPU tests import it on a machine with no ``nvcc`` and no card. The
library links no ``libcuda``: ``coarse_wgmma.cu`` reaches the driver's
``cuTensorMapEncodeTiled`` through the runtime's entry-point query.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty``, launches on ``torch.cuda.current_stream()``
of the tensors' device with that device current (``_guard``), raises if
the C function reports a CUDA error, and adds one to its entry of
``launches`` (a plain integer per kernel, reset by ``reset_launches``).

    K1  coarse_minima_1p_sup       coarse_wgmma.cu or     mirrors, 1 pass,
                                   coarse_minima.cu       super
    K3  coarse_minima              coarse_wgmma.cu or     mirrors, 3 or 1
                                   coarse_minima.cu       passes
    K4  coarse_minima_f32_1p_sup   coarse_wgmma.cu or     f32, 1 pass,
                                   coarse_minima.cu       super
    K5  coarse_minima_f32          coarse_wgmma.cu or     f32, 3 or 1 passes
                                   coarse_minima.cu
    K6  coarse_minima_1p           coarse_wgmma.cu or     mirrors, 1 pass
                                   coarse_minima.cu
    K7  coarse_minima_int8_1p_sup  coarse_wgmma.cu or     int8, 1 pass,
                                   coarse_minima.cu       super
    K2  refine_dots                refine_dots.cu    f32, bf16 or int8 rows
        (launch keys refine_dots, refine_dots_bf16, refine_dots_int8;
        two bodies, see below)
    K8  pq_decode                  pq_decode.cu      uint8 codes -> bf16 rows
                                   (two bodies, see below)
    K8s ivfpq_scan                 ivfpq_scan.cu     uint8 codes -> f32 IVF-PQ
                                   scores of every slot (K8's decode fused
                                   with the residual scoring)
        scan_select                ivfpq_scan.cu     the exact top k of each
                                   segment of a row of scores (K8s's
                                   selection, two launches a query block)
    K9  scan_min                   scan_min.cu       f32 per-tile minima
    H1  hnsw_search                hnsw_search.cu    batched HNSW traversal
        (one block a query; the counterpart of an XLA program, not of a
        Pallas kernel)

The coarse kernels have two bodies, chosen by shape alone in
``_coarse_route``: "wgmma" (``coarse_wgmma.cu``: TMA ring, wgmma,
persistent blocks) for K1, K3, K4, K5, K6 and K7 launches whose rows TMA
can take (d a multiple of 8 -- of 16 for int8 codes -- and 16-byte
aligned rows, K3's lo mirror too), "mma_sync" (``coarse_minima.cu``) for
every other shape. K2 has two bodies in ``refine_dots.cu``, chosen by
shape in ``_refine_route``: "tile_major" (the pairs grouped by tile, each
tile brought into a shared-memory ring by bulk copy and read once for all
the queries of a work item) for 16-byte aligned rows and queries, d a
multiple of 4 (f32) or 8 (bf16, int8 codes), and a 16-row tile that fits
twice in shared memory; "query_major" (a warp per candidate row) for
every other shape. K8 has two bodies in ``pq_decode.cu``, chosen by shape
in ``_decode_route``: "tile_ring" (persistent blocks, each keeping to a
group of subspaces whose codebook stays in L1, walk tiles of rows; each
tile's codes come into a shared-memory ring by bulk copy) for 16-byte
codewords or a multiple of them (dsub % 8 == 0), 16-byte aligned codes,
codebook and output and m <= 4096; "grid_stride" (a thread per codeword
word) for every other shape. K8s has one body; ``ivfpq_scan_body``
says whether an IVF-PQ scan takes it ("fused") or the chunk loop over K8
and library products ("chunked"), and ``routes["ivfpq_scan"]`` counts the
scans of each, ``launches["ivfpq_scan"]`` all of them.
``routes[key][body]`` counts the coarse kernels', K2's and K8's launches
by body beside ``launches``. No body stands in for another: a failed
build or launch raises. K9 (``scan_min.cu``) has one body for every
shape.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from ..utils.profiling import annotate

SUB = 16
SUPER = 16
_ROWS_PER_BLOCK = SUB * SUPER          # coarse kernel: one super-tile
_REFINE_QPB = 4                        # K2 query-major: queries per block
_MAX_SMEM = 227 * 1024                 # Hopper per-block shared memory
# K2 tile-major (refine_dots.cu): sorted pairs a block takes at a time
# (at most this many queries share a work item), ring stages at most, the
# bytes of its mbarriers, and the elements a lane reads per shared-memory
# load by row dtype (16 bytes of f32 or bf16, 8 of int8 codes)
_REFINE_WINDOW = 32
_REFINE_STAGES = 8
_REFINE_BAR_BYTES = 128
_REFINE_VEC = {torch.float32: 4, torch.bfloat16: 8, torch.int8: 8}
# K8 tile_ring (pq_decode.cu): the codebook bytes a group of subspaces may
# hold (it stays in L1), the output words a work item aims at, the code
# bytes a ring stage holds unless 16 rows need more, and the widest m the
# route sends to it (two stages of 16 rows of codes fit in shared memory)
_DECODE_L1_SLICE = 96 * 1024
_DECODE_TILE_WORDS = 768
_DECODE_STAGE_BYTES = 16384
_DECODE_MAX_M = 4096
# K8s (ivfpq_scan.cu): 32-row warp tiles, 8 warps a block; the shared
# memory holds a block's queries (hi and lo) and each warp's tile of codes
_SCAN_WARP_ROWS = 32
_SCAN_WARPS = 8
_SELECT_SEG = 16384                    # keys a selection block reads
_SELECT_MAX_K = 1024
_SELECT_MAX_ROWS = 65535               # rows a selection launch takes
_MODES = {"euclidean": 0, "dot": 1, "cosine": 2}
# coarse source: (C code, row dtype)
_COARSE_SRC = {"mirrors": (0, torch.bfloat16), "f32": (1, torch.float32),
               "int8": (2, torch.int8)}
# refine source by row dtype: (C code, launch key)
_REFINE_SRC = {torch.float32: (0, "refine_dots"),
               torch.bfloat16: (1, "refine_dots_bf16"),
               torch.int8: (2, "refine_dots_int8")}
_PKG = Path(__file__).resolve().parent.parent
_SOURCES = ("coarse_minima.cu", "coarse_wgmma.cu", "refine_dots.cu",
            "pq_decode.cu", "scan_min.cu", "hnsw_search.cu", "ivfpq_scan.cu")
# H1: device bytes of visited bitmasks one launch may hold (N/8 bytes a
# query); larger batches go in several launches
_HNSW_VISITED_BYTES = 256 << 20
_ARCH = "arch=compute_90a,code=sm_90a"

launches = {"coarse_minima_1p_sup": 0, "coarse_minima": 0,
            "coarse_minima_f32_1p_sup": 0, "coarse_minima_f32": 0,
            "coarse_minima_1p": 0, "coarse_minima_int8_1p_sup": 0,
            "refine_dots": 0, "refine_dots_bf16": 0, "refine_dots_int8": 0,
            "pq_decode": 0, "scan_min": 0, "hnsw_search": 0,
            "ivfpq_scan": 0, "scan_select": 0}
# coarse, K2 and K8 launches by body (see _coarse_route, _refine_route,
# _decode_route), reset with ``launches``
routes = {key: ({"wgmma": 0, "mma_sync": 0} if key.startswith("coarse")
                else {"tile_major": 0, "query_major": 0})
          for key in launches if key.startswith(("coarse", "refine"))}
routes["pq_decode"] = {"tile_ring": 0, "grid_stride": 0}
routes["ivfpq_scan"] = {"fused": 0, "chunked": 0}
# build facts of the loaded library (path, compiler output); the seconds
# are the spans ``vdb/kernels.build`` and ``vdb/kernels.load``
build_info: dict = {}


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0
    for body in routes.values():
        for key in body:
            body[key] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc")
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    if path is None and os.path.exists(os.path.join(home, "bin", "nvcc")):
        path = os.path.join(home, "bin", "nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _compile(src: Path, obj: Path) -> subprocess.Popen:
    return subprocess.Popen(
        [_nvcc(), "-gencode", _ARCH, "-std=c++17", "-O3", "-Xcompiler",
         "-fPIC", "-Xptxas", "-v", "-c", "-o", str(obj), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library. Each
    source compiles in its own nvcc process, all started together."""
    srcs = [_PKG / "csrc" / name for name in _SOURCES]
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in srcs))
    build = _PKG / "_build"
    build.mkdir(exist_ok=True)
    so = build / f"libvdb_kernels_{digest.hexdigest()[:16]}.so"
    log = ""
    if not so.exists():
        with annotate("vdb/kernels.build"):
            tag = f"{os.getpid()}.tmp"
            objs = [build / f".{p.stem}.{tag}.o" for p in srcs]
            procs = [_compile(p, o) for p, o in zip(srcs, objs)]
            outs = [p.communicate()[0] for p in procs]
            log = "".join(outs)
            if any(p.returncode for p in procs):
                raise RuntimeError(f"nvcc failed:\n{log}")
            tmp = build / f".{so.name}.{tag}"
            proc = subprocess.run(
                [_nvcc(), "-gencode", _ARCH, "-shared", "-o", str(tmp),
                 *map(str, objs)], capture_output=True, text=True)
            log += proc.stdout + proc.stderr
            for o in objs:
                o.unlink(missing_ok=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc link failed ({proc.returncode}):\n{log}")
            os.replace(tmp, so)
    with annotate("vdb/kernels.load"):
        lib = ctypes.CDLL(str(so))
    p, i, l = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
    lib.vdb_coarse_minima.argtypes = [p, p, p, p, p, p, p, p, p, p, l, i, i,
                                      i, i, i, i, p]
    lib.vdb_coarse_minima.restype = i
    lib.vdb_coarse_wgmma.argtypes = [p, p, p, p, p, p, p, p, p, p, l, i, i,
                                     i, i, i, i, p]
    lib.vdb_coarse_wgmma.restype = i
    lib.vdb_refine_dots.argtypes = [p, p, p, p, p, i, i, i, i, p]
    lib.vdb_refine_dots.restype = i
    lib.vdb_refine_tiles.argtypes = [p, p, i, p, p, p, p, i, i, i, p]
    lib.vdb_refine_tiles.restype = i
    lib.vdb_pq_decode.argtypes = [p, p, p, l, i, i, i, p]
    lib.vdb_pq_decode.restype = i
    lib.vdb_pq_decode_tiles.argtypes = [p, p, p, l, i, i, i, i, i, p]
    lib.vdb_pq_decode_tiles.restype = i
    lib.vdb_scan_min.argtypes = [p, p, p, p, p, p, l, i, i, i, i, p]
    lib.vdb_scan_min.restype = i
    lib.vdb_hnsw_search.argtypes = [p, p, p, p, p, p, p, p, p, l, i, i, i,
                                    i, i, i, i, i, i, p]
    lib.vdb_hnsw_search.restype = i
    lib.vdb_hnsw_search_smem.argtypes = [i, i, i, i]
    lib.vdb_hnsw_search_smem.restype = l
    lib.vdb_ivfpq_scan.argtypes = [p, p, p, p, p, p, p, p, p, p, l, l, i, i,
                                   i, i, i, i, i, i, i, p]
    lib.vdb_ivfpq_scan.restype = i
    lib.vdb_select.argtypes = [p, p, p, p, l, l, i, p]
    lib.vdb_select.restype = i
    build_info.update(path=str(so), log=log)
    return lib


def load() -> dict:
    """Build and load the library now; returns ``build_info``."""
    _lib()
    return build_info


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _raise_on(rc: int, kernel: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError {rc}")


def _guard(device):
    """The launch's device guard: the C entry points read the CURRENT
    device (``cudaGetDevice`` for the SM count, ``cudaFuncSetAttribute``),
    so each launch runs with its output tensor's device current; a shard
    on another card then gets that card's attributes and stream."""
    return torch.cuda.device(device)


def _stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _raw_stream(device) -> int:
    """K8's launcher's stream lookup: the raw handle of ``device``'s
    current stream by torch's private ``_cuda_getCurrentRawStream``, the
    handle ``_stream`` reads without building a ``torch.cuda.Stream``
    (4.6-5.7 us of K8's host time a call on an H100's host; the card
    tests hold the two handles equal)."""
    index = device.index
    return torch._C._cuda_getCurrentRawStream(
        torch.cuda.current_device() if index is None else index)


def _coarse_route(src: str, passes: int, emit_super: bool, d: int,
                  ptrs_aligned: bool) -> str:
    """The coarse body a launch takes, from its shape alone: "wgmma"
    (coarse_wgmma.cu) for K1 and K6 (src "mirrors", one pass, with and
    without super minima), K3 ("mirrors", three passes or one, no super
    minima), K4 and K5 (the same over "f32" rows) and K7 ("int8", one
    pass, super minima) when TMA can take the operands: 16-byte aligned
    rows (both mirrors for K3 at three passes) and a row pitch that is a
    multiple of 16 bytes for the bf16 query copy and the rows (d % 8 == 0;
    d % 16 == 0 for int8 codes, one byte each); "mma_sync"
    (coarse_minima.cu) otherwise."""
    if not ptrs_aligned or d < 8 or d % 8:
        return "mma_sync"
    if src == "int8":
        routed = passes == 1 and emit_super and d % 16 == 0
    else:
        routed = passes == 1 or not emit_super
    return "wgmma" if routed else "mma_sync"


# K7's query copy: within each 16-block of k, fragment column p holds query
# dimension _INT8_K_ORDER[p], so that the four codes k = 4t..4t+3 a thread
# reads with one 32-bit load land on the mma fragment's columns 2t, 2t+1,
# 2t+8, 2t+9 (coarse_wgmma.cu, widen4); every dot is unchanged
_INT8_K_ORDER = (0, 1, 4, 5, 8, 9, 12, 13, 2, 3, 6, 7, 10, 11, 14, 15)


def _int8_k_index(d: int, device) -> torch.Tensor:
    """(d,) indices of ``_INT8_K_ORDER`` applied to each 16-block of k."""
    k = torch.arange(d, device=device)
    order = torch.tensor(_INT8_K_ORDER, device=device)
    return k - k % 16 + order[k % 16]


def coarse_body(src: str, db, passes: int, emit_super: bool,
                db_lo=None) -> str:
    """``_coarse_route`` of a launch over the rows ``db`` (N, d) and, for
    K3 at three passes, the lo mirror ``db_lo``: every row array it reads
    must be 16-byte aligned."""
    arrays = (db,) if db_lo is None else (db, db_lo)
    return _coarse_route(src, passes, emit_super, db.shape[1],
                         all(a.data_ptr() % 16 == 0 for a in arrays))


def _coarse(key: str, src: str, qThi, qTlo, qrow, db, db_lo, scales, col,
            inv_col, mode: str, passes: int, emit_super: bool):
    d, qp = qThi.shape
    n = db.shape[0]
    dev = db.device
    if dev.type != "cuda":
        raise ValueError(f"coarse kernel needs CUDA tensors, got {dev}")
    if n % _ROWS_PER_BLOCK or n == 0:
        raise ValueError(f"rows {n} must be a positive multiple of "
                         f"{_ROWS_PER_BLOCK}")
    if passes not in (1, 3) or (passes == 3 and emit_super):
        raise ValueError(f"unsupported passes={passes}, "
                         f"emit_super={emit_super}")
    code, row_dtype = _COARSE_SRC[src]
    bf, f32 = torch.bfloat16, torch.float32
    _check("qThi", qThi, bf, (d, qp), dev)
    _check("qrow", qrow, f32, (1, qp), dev)
    _check("db", db, row_dtype, (n, d), dev)
    _check("col", col, f32, (1, n), dev)
    _check("inv_col", inv_col, f32, (1, n), dev)
    if passes == 3:
        _check("qTlo", qTlo, bf, (d, qp), dev)
        if src == "mirrors":
            _check("db_lo", db_lo, bf, (n, d), dev)
    if src == "int8":
        _check("scales", scales, f32, (1, n), dev)
    tile = torch.empty((n // SUB, qp), dtype=f32, device=dev)
    sup = (torch.empty((n // _ROWS_PER_BLOCK, qp), dtype=f32, device=dev)
           if emit_super else None)
    lo = db_lo if passes == 3 and src == "mirrors" else None
    body = coarse_body(src, db, passes, emit_super, lo)
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    if body == "wgmma":
        # the queries K-major, (Qp, d): both wgmma operands then share one
        # swizzled layout (for int8 codes in K7's k order)
        qk = (qThi.t().index_select(1, _int8_k_index(d, dev))
              if src == "int8" else qThi.t().contiguous())
        qk_lo = qTlo.t().contiguous() if passes == 3 else None
        with _guard(dev):
            rc = _lib().vdb_coarse_wgmma(
                qk.data_ptr(), ptr(qk_lo), qrow.data_ptr(), db.data_ptr(),
                ptr(lo), ptr(scales), col.data_ptr(), inv_col.data_ptr(),
                tile.data_ptr(), ptr(sup), n, d, qp, _MODES[mode], code,
                passes, int(emit_super), _stream(dev))
    else:
        rc = _mma_sync(src, qThi, qTlo, qrow, db, lo, scales, col, inv_col,
                       mode, passes, tile, sup)
    _raise_on(rc, f"{key} ({body})")
    launches[key] += 1
    routes[key][body] += 1
    return tile, sup


def _mma_sync(src: str, qThi, qTlo, qrow, db, db_lo, scales, col, inv_col,
              mode: str, passes: int, tile, sup) -> int:
    """Launch the mma.sync body (coarse_minima.cu) into ``tile`` (and
    ``sup``, super minima, or None); returns its cudaError_t."""
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    d, qp = qThi.shape
    with _guard(db.device):
        return _lib().vdb_coarse_minima(
            qThi.data_ptr(), ptr(qTlo if passes == 3 else None),
            qrow.data_ptr(), db.data_ptr(),
            ptr(db_lo if passes == 3 else None), ptr(scales),
            col.data_ptr(), inv_col.data_ptr(), tile.data_ptr(), ptr(sup),
            db.shape[0], d, qp, _MODES[mode], _COARSE_SRC[src][0], passes,
            int(sup is not None), _stream(db.device))


def coarse_minima_mma_sync(src: str, qThi, qTlo, qrow, db, db_lo, scales,
                           col, inv_col, mode: str, passes: int,
                           emit_super: bool):
    """The mma.sync body (coarse_minima.cu) through its C entry point at
    any shape, whatever ``_coarse_route`` would pick: the other body for
    side-by-side readings (chip_smoke.py's accumulation reading of that
    body, its K6 bit-equality check, the card tests). No search path
    calls it, so it counts no launch. Operands as ``_coarse``'s; returns
    (tile minima (N/16, Qp), super minima (N/256, Qp) or None)."""
    qp = qThi.shape[1]
    n = db.shape[0]
    dev = db.device
    if dev.type != "cuda":
        raise ValueError(f"coarse kernel needs CUDA tensors, got {dev}")
    if n % _ROWS_PER_BLOCK or n == 0:
        raise ValueError(f"rows {n} must be a positive multiple of "
                         f"{_ROWS_PER_BLOCK}")
    tile = torch.empty((n // SUB, qp), dtype=torch.float32, device=dev)
    sup = (torch.empty((n // _ROWS_PER_BLOCK, qp), dtype=torch.float32,
                       device=dev) if emit_super else None)
    _raise_on(_mma_sync(src, qThi, qTlo, qrow, db, db_lo, scales, col,
                        inv_col, mode, passes, tile, sup),
              "coarse_minima (mma_sync)")
    return tile, sup


def coarse_minima_1p_sup(qThi, qrow, db_hi, col, inv_col, mode: str):
    """K1: one bf16 pass over the hi mirror (or a bf16-stored database)
    -> (tile minima (N/16, Qp), super minima (N/256, Qp)) f32, tile-major,
    as vectordb_tpu's _minima_1p_sup."""
    return _coarse("coarse_minima_1p_sup", "mirrors", qThi, None, qrow,
                   db_hi, None, None, col, inv_col, mode, 1, True)


def coarse_minima(qThi, qTlo, qrow, db_hi, db_lo, col, inv_col,
                  passes: int, mode: str):
    """K3: bf16x3 (passes=3) or one bf16 pass over the hi/lo mirrors ->
    tile minima (N/16, Qp) f32, tile-major (the caller transposes)."""
    return _coarse("coarse_minima", "mirrors", qThi, qTlo, qrow, db_hi,
                   db_lo, None, col, inv_col, mode, passes, False)[0]


def coarse_minima_f32_1p_sup(qThi, qrow, db, col, inv_col, mode: str):
    """K4: K1 over the f32 rows, rounded to bf16 on chip -> (tile minima,
    super minima), as _minima_1p_sup(src="f32")."""
    return _coarse("coarse_minima_f32_1p_sup", "f32", qThi, None, qrow, db,
                   None, None, col, inv_col, mode, 1, True)


def coarse_minima_f32(qThi, qTlo, qrow, db, col, inv_col, passes: int,
                      mode: str):
    """K5: K3 over the f32 rows, hi/lo split on chip -> tile minima
    (N/16, Qp), tile-major (the caller transposes)."""
    return _coarse("coarse_minima_f32", "f32", qThi, qTlo, qrow, db, None,
                   None, col, inv_col, mode, passes, False)[0]


def coarse_minima_1p(qThi, qrow, db_hi, col, inv_col, mode: str):
    """K6: one bf16 pass over the hi mirror, tile minima only (N/16, Qp),
    tile-major, as _coarse_minima_1p_tq."""
    return _coarse("coarse_minima_1p", "mirrors", qThi, None, qrow, db_hi,
                   None, None, col, inv_col, mode, 1, False)[0]


def coarse_minima_int8_1p_sup(qThi, qrow, codes, scales, col, inv_col,
                              mode: str):
    """K7: K1 over int8 codes (cast exactly to bf16), each dot times its
    row's pow2 scale ``scales`` (1, N) -> (tile minima, super minima), as
    _minima_1p_sup(src="int8")."""
    return _coarse("coarse_minima_int8_1p_sup", "int8", qThi, None, qrow,
                   codes, None, scales, col, inv_col, mode, 1, True)


def _refine_stages(d: int, itemsize: int) -> int:
    """Ring stages of K2's tile-major body for rows of width ``d`` and
    ``itemsize`` bytes an element: as many 16-row tiles as fit in shared
    memory beside its barriers, at most ``_REFINE_STAGES``; 0 if fewer
    than two fit (refine_dots.cu, tile_stages)."""
    fit = (_MAX_SMEM - _REFINE_BAR_BYTES) // (SUB * d * itemsize)
    return min(fit, _REFINE_STAGES) if fit >= 2 else 0


def _refine_route(dtype, d: int, aligned: bool) -> str:
    """The K2 body a launch takes, from its shape alone: "tile_major" when
    the rows and queries are 16-byte aligned, a lane's shared-memory read
    of ``_REFINE_VEC[dtype]`` elements stays aligned (d % 4 == 0 for f32
    rows, d % 8 == 0 for bf16 rows and int8 codes) and two 16-row tiles
    fit in shared memory (d <= 1815 f32, 3630 bf16, 7260 int8);
    "query_major" otherwise."""
    itemsize = torch.empty(0, dtype=dtype).element_size()
    if aligned and d % _REFINE_VEC[dtype] == 0 and _refine_stages(d,
                                                                   itemsize):
        return "tile_major"
    return "query_major"


def refine_body(db, queries) -> str:
    """``_refine_route`` of a K2 launch over the rows ``db`` (N, d) for
    ``queries`` (Qp, d): both must be 16-byte aligned."""
    return _refine_route(db.dtype, db.shape[1],
                         db.data_ptr() % 16 == 0
                         and queries.data_ptr() % 16 == 0)


def _refine_work(tile_idx):
    """K2's tile-major work list from ``tile_idx`` (Qp, m): (tiles int32,
    pairs int64), the pair ids q*m + j in the stable order of their tile
    ids, and those tile ids in that order. One sort of 32-bit keys on the
    tensor's device (half the radix passes of 64-bit ones); it only
    orders the work."""
    return torch.sort(tile_idx.reshape(-1).to(torch.int32), stable=True)


def _refine_items(tiles):
    """The work items the tile-major body walks over the sorted tile ids
    ``tiles``: the start positions of each window of ``_REFINE_WINDOW``
    pairs and of each change of tile within one (the kernel's segment
    heads). Item i covers sorted positions items[i] .. items[i + 1] - 1,
    the last one up to the end: one tile, at most ``_REFINE_WINDOW``
    pairs; each item is one tile read into the ring."""
    pos = torch.arange(tiles.numel(), device=tiles.device)
    head = pos % _REFINE_WINDOW == 0
    head[1:] |= tiles[1:] != tiles[:-1]
    return pos[head]


def refine_dots(tile_idx, queries, db, m: int, scales=None):
    """K2: (Qp, m*16) f32 dots of each query with the rows of its m
    selected 16-row tiles, IEEE f32 FMA. ``db`` holds f32 rows, bf16 rows
    (widened exactly) or int8 codes; for codes, ``scales`` (N,) f32 pow2
    row scales multiply the finished dots. The body is
    ``refine_body(db, queries)``."""
    qp, d = queries.shape
    n = db.shape[0]
    dev = db.device
    if dev.type != "cuda":
        raise ValueError(f"refine kernel needs CUDA tensors, got {dev}")
    if n % SUB:
        raise ValueError(f"rows {n} must be a multiple of {SUB}")
    if db.dtype not in _REFINE_SRC:
        raise ValueError(f"db: dtype {db.dtype}, expected float32, bfloat16 "
                         "or int8")
    code, key = _REFINE_SRC[db.dtype]
    _check("tile_idx", tile_idx, torch.int64, (qp, m), dev)
    _check("queries", queries, torch.float32, (qp, d), dev)
    _check("db", db, db.dtype, (n, d), dev)
    if (scales is not None) != (db.dtype == torch.int8):
        raise ValueError("scales= goes with int8 codes, and only with them")
    if scales is not None:
        _check("scales", scales, torch.float32, (n,), dev)
    if qp * m >= 2 ** 31 or n // SUB >= 2 ** 31:
        raise ValueError(f"{qp} x {m} pairs over {n} rows: too many for one "
                         "launch")
    body = refine_body(db, queries)
    if body == "query_major" and _REFINE_QPB * d * 4 > _MAX_SMEM:
        raise ValueError(f"d={d} too wide for the refine kernel")
    out = torch.empty((qp, m * SUB), dtype=torch.float32, device=dev)
    if qp == 0 or m == 0:
        return out
    sc = scales.data_ptr() if scales is not None else None
    if body == "tile_major":
        tiles, pairs = _refine_work(tile_idx)
        with _guard(dev):
            rc = _lib().vdb_refine_tiles(
                tiles.data_ptr(), pairs.data_ptr(), qp * m,
                queries.data_ptr(), db.data_ptr(), sc, out.data_ptr(), m, d,
                code, _stream(dev))
    else:
        with _guard(dev):
            rc = _lib().vdb_refine_dots(
                tile_idx.data_ptr(), queries.data_ptr(), db.data_ptr(), sc,
                out.data_ptr(), qp, m, d, code, _stream(dev))
    _raise_on(rc, f"{key} ({body})")
    launches[key] += 1
    routes[key][body] += 1
    return out


def _decode_route(dsub: int, aligned: bool, m: int) -> str:
    """The K8 body a launch takes, from its shape alone: "tile_ring" for
    codewords of 16 bytes or a multiple of them (dsub % 8 == 0) when the
    codes and the codebook are 16-byte aligned and m <= ``_DECODE_MAX_M``
    (two stages of 16 rows of codes fit in shared memory); "grid_stride"
    otherwise."""
    if aligned and dsub % 8 == 0 and m <= _DECODE_MAX_M:
        return "tile_ring"
    return "grid_stride"


def decode_body(codes, cb) -> str:
    """``_decode_route`` of a K8 launch over ``codes`` (rows, m) with the
    codebook ``cb`` (m, ksub, dsub): both must be 16-byte aligned. The
    output needs no test: the wrapper allocates it with ``torch.empty``,
    whose storage is aligned."""
    aligned = (codes.data_ptr() | cb.data_ptr()) % 16 == 0
    return _decode_route(cb.shape[2], aligned, cb.shape[0])


@functools.lru_cache(maxsize=None)
def _decode_plan(m: int, ksub: int, dsub: int):
    """The tile_ring body's work items: (tile_rows, group). A group holds
    as many subspaces as fit their codebook in ``_DECODE_L1_SLICE`` bytes
    (at least one, at most m); a tile holds a multiple of 16 rows (so
    each tile's codes start 16-byte aligned), as many as keep the item
    near ``_DECODE_TILE_WORDS`` 16-byte output words and its codes within
    ``_DECODE_STAGE_BYTES``."""
    words = dsub // 8
    group = max(1, min(m, _DECODE_L1_SLICE // (ksub * dsub * 2)))
    tiles = min(_DECODE_TILE_WORDS // (16 * group * words),
                _DECODE_STAGE_BYTES // (16 * m))
    return 16 * max(1, tiles), group


def _decode_args(codes, cb):
    """Check K8's operands; returns (out, rows, m, ksub, dsub), ``out`` a
    new (rows, m*dsub) bf16 tensor."""
    dev = codes.device
    if dev.type != "cuda":
        raise ValueError(f"pq_decode kernel needs CUDA tensors, got {dev}")
    if codes.dim() != 2 or cb.dim() != 3:
        raise ValueError("pq_decode: codes must be (rows, m), cb (m, ksub, "
                         "dsub)")
    rows, m = codes.shape
    _, ksub, dsub = cb.shape
    if not 1 <= ksub <= 256:
        raise ValueError(f"pq_decode: ksub {ksub} must be in [1, 256]")
    _check("codes", codes, torch.uint8, (rows, m), dev)
    _check("cb", cb, torch.bfloat16, (m, ksub, dsub), dev)
    out = torch.empty((rows, m * dsub), dtype=torch.bfloat16, device=dev)
    return out, rows, m, ksub, dsub


def pq_decode(codes, cb):
    """K8: (rows, m) uint8 codes, (m, ksub, dsub) bf16 codebook -> (rows,
    m*dsub) bf16 rows, row i's subspace c = codeword codes[i, c] bit for
    bit. Any row count, any dsub, ksub <= 256; every code must be < ksub
    (pq_encode emits them so, PqFlatIndex.adopt_codes checks). The body
    is ``decode_body(codes, cb)``."""
    out, rows, m, ksub, dsub = _decode_args(codes, cb)
    if rows == 0 or m == 0:
        return out
    ptrs = (codes.data_ptr(), cb.data_ptr(), out.data_ptr())
    body = decode_body(codes, cb)
    with _guard(codes.device):
        if body == "tile_ring":
            rc = _lib().vdb_pq_decode_tiles(*ptrs, rows, m, ksub, dsub,
                                            *_decode_plan(m, ksub, dsub),
                                            _raw_stream(codes.device))
        else:
            rc = _lib().vdb_pq_decode(*ptrs, rows, m, ksub, dsub,
                                      _raw_stream(codes.device))
    _raise_on(rc, f"pq_decode ({body})")
    launches["pq_decode"] += 1
    routes["pq_decode"][body] += 1
    return out


def pq_decode_grid_stride(codes, cb):
    """The grid_stride body of K8 through its C entry point at any shape,
    whatever ``_decode_route`` would pick: the other body for side-by-side
    readings (chip_smoke.py, tools/coarse_bodies.py, the card tests). No
    search path calls it, so it counts no launch."""
    out, rows, m, ksub, dsub = _decode_args(codes, cb)
    if rows == 0 or m == 0:
        return out
    with _guard(codes.device):
        rc = _lib().vdb_pq_decode(codes.data_ptr(), cb.data_ptr(),
                                  out.data_ptr(), rows, m, ksub, dsub,
                                  _raw_stream(codes.device))
    _raise_on(rc, "pq_decode (grid_stride)")
    return out


def _scan_smem(d: int, m: int, nt: int) -> int:
    """K8s's shared memory: a block's ``8 nt`` queries, hi and lo, and each
    warp's tile of codes (ivfpq_scan.cu, ``vdb_ivfpq_scan_smem``)."""
    return 4 * nt * 8 * d + _SCAN_WARPS * _SCAN_WARP_ROWS * m


def _scan_tile(q: int, d: int, m: int) -> int:
    """The n-tiles of 8 queries a K8s block holds (ivfpq_scan.cu builds
    two): 8 for more than 16 queries where the block's shared memory
    holds them, else 2; 0 if 2 do not fit."""
    for nt in ((8, 2) if q > 16 else (2,)):
        if _scan_smem(d, m, nt) <= _MAX_SMEM:
            return nt
    return 0


def _ivfpq_scan_route(dtype, d: int, dsub: int, m: int,
                      aligned: bool) -> str:
    """The route of an IVF-PQ scan over CUDA tensors, from its shape
    alone: "fused" (K8s, one launch a query block) for uint8 codes, d % 16
    == 0 and dsub % 8 == 0 (whole k16 steps, each lane's four dims within
    one codeword), 16-byte aligned codes and codebook, and a block's
    shared memory that holds two n-tiles of queries beside its codes;
    "chunked" (ops/pq.py's chunk loop over K8 and library products)
    otherwise."""
    if (dtype == torch.uint8 and d % 16 == 0 and dsub % 8 == 0 and aligned
            and _scan_tile(1, d, m)):
        return "fused"
    return "chunked"


def ivfpq_scan_body(codes, cb) -> str:
    """``_ivfpq_scan_route`` of a scan over ``codes`` (N, m) with the
    codebook ``cb`` (m, ksub, dsub): both must be 16-byte aligned."""
    m, _, dsub = cb.shape
    aligned = (codes.data_ptr() | cb.data_ptr()) % 16 == 0
    return _ivfpq_scan_route(codes.dtype, m * dsub, dsub, m, aligned)


def ivfpq_scan(codes, cb, q_hi, q_lo, qc, cents, csq, cid_sp, valid,
               span: int, nlist: int, mode: str):
    """K8s: (Q, N) f32 scan scores of every slot, one launch. ``codes``
    (N, m) uint8 (each < ksub), ``cb`` (m, ksub, dsub) bf16, ``q_hi``,
    ``q_lo`` (Q, d) bf16 (the query split), ``qc`` (Q, nlist) f32 (q.c of
    each cluster), ``cents`` (nlist, d) bf16, ``csq`` (nlist,) f32,
    ``cid_sp`` (N - nlist*span,) int32 (the spill slots' clusters),
    ``valid`` (N,) bool. Scores as ops/pq.py's ``_metric_scores`` of the
    residual dots, +inf on dead slots; the route must be "fused"
    (``ivfpq_scan_body``)."""
    dev = codes.device
    if dev.type != "cuda":
        raise ValueError(f"ivfpq_scan kernel needs CUDA tensors, got {dev}")
    if codes.dim() != 2 or cb.dim() != 3 or q_hi.dim() != 2:
        raise ValueError("ivfpq_scan: codes (N, m), cb (m, ksub, dsub), "
                         "queries (Q, d)")
    n, m = codes.shape
    _, ksub, dsub = cb.shape
    q, d = q_hi.shape
    big_m = nlist * span
    if d != m * dsub or not 0 <= big_m <= n or not 1 <= ksub <= 256:
        raise ValueError(f"ivfpq_scan: d={d}, m={m}, dsub={dsub}, "
                         f"ksub={ksub}, nlist*span={big_m}, N={n}")
    bf, f32 = torch.bfloat16, torch.float32
    _check("codes", codes, torch.uint8, (n, m), dev)
    _check("cb", cb, bf, (m, ksub, dsub), dev)
    _check("q_hi", q_hi, bf, (q, d), dev)
    _check("q_lo", q_lo, bf, (q, d), dev)
    _check("qc", qc, f32, (q, nlist), dev)
    _check("cents", cents, bf, (nlist, d), dev)
    _check("csq", csq, f32, (nlist,), dev)
    _check("cid_sp", cid_sp, torch.int32, (n - big_m,), dev)
    _check("valid", valid, torch.bool, (n,), dev)
    body = ivfpq_scan_body(codes, cb)
    if body != "fused" or (cents.data_ptr() | q_hi.data_ptr()
                           | q_lo.data_ptr()) % 16:
        raise ValueError(f"ivfpq_scan: this shape takes the {body} route, "
                         "or a table is not 16-byte aligned")
    out = torch.empty((q, n), dtype=f32, device=dev)
    if q == 0 or n == 0:
        return out
    with _guard(dev):
        rc = _lib().vdb_ivfpq_scan(
            codes.data_ptr(), cb.data_ptr(), q_hi.data_ptr(),
            q_lo.data_ptr(), qc.data_ptr(), cents.data_ptr(),
            csq.data_ptr(), cid_sp.data_ptr(), valid.data_ptr(),
            out.data_ptr(), n, big_m, q, d, m, ksub, dsub, span, nlist,
            _scan_tile(q, d, m), _MODES[mode], _raw_stream(dev))
    _raise_on(rc, "ivfpq_scan")
    launches["ivfpq_scan"] += 1
    routes["ivfpq_scan"]["fused"] += 1
    return out


def scan_select(keys, k: int, payload=None):
    """K8s's selection: for each row of ``keys`` (R, L) f32 and each
    segment of ``_SELECT_SEG`` keys, its k smallest, ascending -> (values
    (R, S*k) f32, slots (R, S*k) int64), S = ceil(L / _SELECT_SEG); a slot
    is the key's column, or its entry of ``payload`` (R, L) int64. A
    segment of fewer than k keys ends in NaN values and slot -1. Ties may
    come in another order than torch.topk's; the values are the same.
    Its plain version is ops/pq.py ``_select_plain``."""
    dev = keys.device
    if dev.type != "cuda":
        raise ValueError(f"scan_select kernel needs CUDA tensors, got {dev}")
    if keys.dim() != 2:
        raise ValueError("scan_select: keys must be (rows, len)")
    rows, n = keys.shape
    if not 1 <= k <= _SELECT_MAX_K or rows > _SELECT_MAX_ROWS:
        raise ValueError(f"scan_select: k={k} (1..{_SELECT_MAX_K}), "
                         f"{rows} rows (at most {_SELECT_MAX_ROWS})")
    _check("keys", keys, torch.float32, (rows, n), dev)
    if payload is not None:
        _check("payload", payload, torch.int64, (rows, n), dev)
    segs = -(-n // _SELECT_SEG)
    out_v = torch.empty((rows, segs * k), dtype=torch.float32, device=dev)
    out_i = torch.empty((rows, segs * k), dtype=torch.int64, device=dev)
    if rows == 0 or n == 0:
        return out_v, out_i
    with _guard(dev):
        rc = _lib().vdb_select(
            keys.data_ptr(),
            payload.data_ptr() if payload is not None else None,
            out_v.data_ptr(), out_i.data_ptr(), rows, n, k, _raw_stream(dev))
    _raise_on(rc, "scan_select")
    launches["scan_select"] += 1
    return out_v, out_i


def scan_min(queries, qaux, db, raux, invalidf, mode: str, tile_rows: int):
    """K9: (Q, N / tile_rows) f32 per-tile minima of the f32 scores of
    ``queries`` (Q, d) against ``db`` (N, d) rows (IEEE fmaf dots; the
    euclidean / dot / cosine forms of vectordb_tpu's _scan_min_kernel,
    1e30 added where ``invalidf`` (N,) is 1)."""
    dev = db.device
    if dev.type != "cuda":
        raise ValueError(f"scan_min kernel needs CUDA tensors, got {dev}")
    q, d = queries.shape
    n = db.shape[0]
    if tile_rows < 1 or n % tile_rows:
        raise ValueError(f"rows {n} must be a multiple of tile_rows "
                         f"{tile_rows}")
    f32 = torch.float32
    _check("queries", queries, f32, (q, d), dev)
    _check("qaux", qaux, f32, (q,), dev)
    _check("db", db, f32, (n, d), dev)
    _check("raux", raux, f32, (n,), dev)
    _check("invalidf", invalidf, f32, (n,), dev)
    out = torch.empty((q, n // tile_rows), dtype=f32, device=dev)
    if q == 0 or n == 0:
        return out
    with _guard(dev):
        rc = _lib().vdb_scan_min(queries.data_ptr(), qaux.data_ptr(),
                                 db.data_ptr(), raux.data_ptr(),
                                 invalidf.data_ptr(), out.data_ptr(), n, q,
                                 d, tile_rows, _MODES[mode], _stream(dev))
    _raise_on(rc, "scan_min")
    launches["scan_min"] += 1
    return out


def hnsw_search(vectors, norms, neighbors, valid, queries, entry: int,
                start_layer: int, mode: str, k: int, ef: int,
                slot_mask=None):
    """H1: batched HNSW search over the padded tables, one thread block a
    query (hnsw_search.cu). ``vectors`` (N, d) f32, ``norms`` (N,) f32,
    ``neighbors`` (N, L, M) int32 (-1 padded), ``valid`` (N,) bool,
    ``queries`` (Q, d) f32, ``slot_mask`` (N,) bool or None; ``ef`` >=
    ``k``. Returns (dists (Q, k) f32 finalised, slots (Q, k) int32), +inf
    and -1 where missing. The visited bitmasks (N/8 bytes a query) are
    scratch of this call; more than ``_HNSW_VISITED_BYTES`` of them go in
    several launches."""
    dev = vectors.device
    if dev.type != "cuda":
        raise ValueError(f"hnsw_search kernel needs CUDA tensors, got {dev}")
    n, d = vectors.shape
    nq = queries.shape[0]
    if neighbors.dim() != 3 or neighbors.shape[0] != n:
        raise ValueError("neighbors must be (N, L, M)")
    _, layers, m = neighbors.shape
    if not 1 <= k <= ef:
        raise ValueError(f"need 1 <= k <= ef, got k={k}, ef={ef}")
    if not 0 <= entry < n or start_layer >= layers:
        raise ValueError(f"entry {entry} / start layer {start_layer} out "
                         "of range")
    f32 = torch.float32
    _check("vectors", vectors, f32, (n, d), dev)
    _check("norms", norms, f32, (n,), dev)
    _check("neighbors", neighbors, torch.int32, (n, layers, m), dev)
    _check("valid", valid, torch.bool, (n,), dev)
    _check("queries", queries, f32, (nq, d), dev)
    if slot_mask is not None:
        _check("slot_mask", slot_mask, torch.bool, (n,), dev)
    lib = _lib()
    smem = lib.vdb_hnsw_search_smem(d, ef, m, int(slot_mask is not None))
    if smem > _MAX_SMEM or m > 256:
        raise ValueError(f"d={d}, ef={ef}, M={m}: {smem} bytes of shared "
                         "memory a block, more than the card holds")
    out_d = torch.empty((nq, k), dtype=f32, device=dev)
    out_slot = torch.empty((nq, k), dtype=torch.int32, device=dev)
    if nq == 0:
        return out_d, out_slot
    words = (n + 31) // 32
    chunk = max(1, _HNSW_VISITED_BYTES // (words * 4))
    visited = torch.empty((min(chunk, nq), words), dtype=torch.int32,
                          device=dev)
    mask_ptr = slot_mask.data_ptr() if slot_mask is not None else None
    for q0 in range(0, nq, chunk):
        q1 = min(q0 + chunk, nq)
        with _guard(dev):
            rc = lib.vdb_hnsw_search(
                vectors.data_ptr(), norms.data_ptr(), neighbors.data_ptr(),
                valid.data_ptr(), queries[q0:q1].data_ptr(), mask_ptr,
                visited.data_ptr(), out_d[q0:q1].data_ptr(),
                out_slot[q0:q1].data_ptr(), n, q1 - q0, d, layers, m, entry,
                start_layer, k, ef, _MODES[mode], _stream(dev))
        _raise_on(rc, "hnsw_search")
        launches["hnsw_search"] += 1
    return out_d, out_slot


__all__ = ["coarse_minima_1p_sup", "coarse_minima", "coarse_minima_f32_1p_sup",
           "coarse_minima_f32", "coarse_minima_1p",
           "coarse_minima_int8_1p_sup", "refine_dots", "pq_decode",
           "pq_decode_grid_stride", "scan_min", "hnsw_search", "ivfpq_scan",
           "scan_select", "launches", "routes",
           "coarse_body", "refine_body", "decode_body", "ivfpq_scan_body",
           "reset_launches",
           "load", "build_info"]
