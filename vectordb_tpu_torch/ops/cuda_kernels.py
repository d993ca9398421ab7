"""Build, load and wrap the hand-written Hopper kernels (csrc/*.cu).

The sources are compiled at first use with ``nvcc`` for ``sm_90a`` into
one shared library with a plain C interface, cached under
``vectordb_tpu_torch/_build/`` by a hash of the sources, and loaded with
ctypes. Nothing is built or loaded when this module is imported, so the
CPU tests import it on a machine with no ``nvcc`` and no card. The
library links no ``libcuda``: ``coarse_wgmma.cu`` reaches the driver's
``cuTensorMapEncodeTiled`` through the runtime's entry-point query.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty``, launches on ``torch.cuda.current_stream()``,
raises if the C function reports a CUDA error, and adds one to its entry
of ``launches`` (a plain integer per kernel, reset by ``reset_launches``).

    K1  coarse_minima_1p_sup       coarse_wgmma.cu or     mirrors, 1 pass,
                                   coarse_minima.cu       super
    K3  coarse_minima              coarse_wgmma.cu or     mirrors, 3 passes
                                   coarse_minima.cu       (1 pass: mma.sync)
    K4  coarse_minima_f32_1p_sup   coarse_wgmma.cu or     f32, 1 pass,
                                   coarse_minima.cu       super
    K5  coarse_minima_f32          coarse_wgmma.cu or     f32, 3 or 1 passes
                                   coarse_minima.cu
    K6  coarse_minima_1p           coarse_minima.cu  mirrors, 1 pass
    K7  coarse_minima_int8_1p_sup  coarse_wgmma.cu or     int8, 1 pass,
                                   coarse_minima.cu       super
    K2  refine_dots                refine_dots.cu    f32, bf16 or int8 rows
        (launch keys refine_dots, refine_dots_bf16, refine_dots_int8)
    K8  pq_decode                  pq_decode.cu      uint8 codes -> bf16 rows
    K9  scan_min                   scan_min.cu       f32 per-tile minima

The coarse kernels have two bodies, chosen by shape alone in
``_coarse_route``: "wgmma" (``coarse_wgmma.cu``: TMA ring, wgmma,
persistent blocks) for K1, K3 (3 passes), K4, K5 (3 passes or 1) and K7
launches whose rows TMA can take (d a multiple of 8 -- of 16 for int8
codes -- and 16-byte aligned rows, K3's lo mirror too), "mma_sync"
(``coarse_minima.cu``) for every other shape, for K6 and for K3 at one
pass. ``routes[key][body]`` counts each coarse kernel's launches by body
beside ``launches``. No body stands in for another: a failed build or
launch raises. K9 (``scan_min.cu``) has one body for every shape.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

SUB = 16
SUPER = 16
_ROWS_PER_BLOCK = SUB * SUPER          # coarse kernel: one super-tile
_REFINE_QPB = 4                        # refine kernel: queries per block
_MAX_SMEM = 227 * 1024                 # Hopper per-block shared memory
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
            "pq_decode.cu", "scan_min.cu")
_ARCH = "arch=compute_90a,code=sm_90a"

launches = {"coarse_minima_1p_sup": 0, "coarse_minima": 0,
            "coarse_minima_f32_1p_sup": 0, "coarse_minima_f32": 0,
            "coarse_minima_1p": 0, "coarse_minima_int8_1p_sup": 0,
            "refine_dots": 0, "refine_dots_bf16": 0, "refine_dots_int8": 0,
            "pq_decode": 0, "scan_min": 0}
# coarse launches by body (see _coarse_route), reset with ``launches``
routes = {key: {"wgmma": 0, "mma_sync": 0}
          for key in launches if key.startswith("coarse_minima")}
# build facts of the loaded library (path, seconds, compiler output)
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
    seconds, log = 0.0, ""
    if not so.exists():
        tag = f"{os.getpid()}.tmp"
        objs = [build / f".{p.stem}.{tag}.o" for p in srcs]
        t0 = time.perf_counter()
        procs = [_compile(p, o) for p, o in zip(srcs, objs)]
        outs = [p.communicate()[0] for p in procs]
        log = "".join(outs)
        if any(p.returncode for p in procs):
            raise RuntimeError(f"nvcc failed:\n{log}")
        tmp = build / f".{so.name}.{tag}"
        proc = subprocess.run(
            [_nvcc(), "-gencode", _ARCH, "-shared", "-o", str(tmp),
             *map(str, objs)], capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log += proc.stdout + proc.stderr
        for o in objs:
            o.unlink(missing_ok=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{log}")
        os.replace(tmp, so)
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
    lib.vdb_pq_decode.argtypes = [p, p, p, l, i, i, i, p]
    lib.vdb_pq_decode.restype = i
    lib.vdb_scan_min.argtypes = [p, p, p, p, p, p, l, i, i, i, i, p]
    lib.vdb_scan_min.restype = i
    build_info.update(path=str(so), seconds=seconds, log=log)
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


def _stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _coarse_route(src: str, passes: int, emit_super: bool, d: int,
                  ptrs_aligned: bool) -> str:
    """The coarse body a launch takes, from its shape alone: "wgmma"
    (coarse_wgmma.cu) for K1 (src "mirrors", one pass, super minima), K3
    ("mirrors", three passes, no super minima), K4 and K5 ("f32": one pass
    with or without super minima, or three passes without) and K7 ("int8",
    one pass, super minima) when TMA can take the operands: 16-byte
    aligned rows (both mirrors for K3) and a row pitch that is a multiple
    of 16 bytes for the bf16 query copy and the rows (d % 8 == 0; d % 16
    == 0 for int8 codes, one byte each); "mma_sync" (coarse_minima.cu)
    otherwise, and for K6 and K3 at one pass ("mirrors", one pass, no
    super minima)."""
    if not ptrs_aligned or d < 8 or d % 8:
        return "mma_sync"
    if src == "int8":
        routed = passes == 1 and emit_super and d % 16 == 0
    elif src == "f32":
        routed = passes == 1 or not emit_super
    else:
        routed = (passes, emit_super) in ((1, True), (3, False))
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
        rc = _lib().vdb_coarse_wgmma(
            qk.data_ptr(), ptr(qk_lo), qrow.data_ptr(), db.data_ptr(),
            ptr(lo), ptr(scales), col.data_ptr(), inv_col.data_ptr(),
            tile.data_ptr(), ptr(sup), n, d, qp, _MODES[mode], code, passes,
            int(emit_super), _stream(dev))
    else:
        rc = _lib().vdb_coarse_minima(
            qThi.data_ptr(), ptr(qTlo if passes == 3 else None),
            qrow.data_ptr(), db.data_ptr(), ptr(lo), ptr(scales),
            col.data_ptr(), inv_col.data_ptr(), tile.data_ptr(), ptr(sup), n,
            d, qp, _MODES[mode], code, passes, int(emit_super),
            _stream(dev))
    _raise_on(rc, f"{key} ({body})")
    launches[key] += 1
    routes[key][body] += 1
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


def refine_dots(tile_idx, queries, db, m: int, scales=None):
    """K2: (Qp, m*16) f32 dots of each query with the rows of its m
    selected 16-row tiles, IEEE f32 FMA. ``db`` holds f32 rows, bf16 rows
    (widened exactly) or int8 codes; for codes, ``scales`` (N,) f32 pow2
    row scales multiply the finished dots."""
    qp, d = queries.shape
    n = db.shape[0]
    dev = db.device
    if dev.type != "cuda":
        raise ValueError(f"refine kernel needs CUDA tensors, got {dev}")
    if n % SUB:
        raise ValueError(f"rows {n} must be a multiple of {SUB}")
    if _REFINE_QPB * d * 4 > _MAX_SMEM:
        raise ValueError(f"d={d} too wide for the refine kernel")
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
    out = torch.empty((qp, m * SUB), dtype=torch.float32, device=dev)
    if qp == 0 or m == 0:
        return out
    rc = _lib().vdb_refine_dots(
        tile_idx.data_ptr(), queries.data_ptr(), db.data_ptr(),
        scales.data_ptr() if scales is not None else None, out.data_ptr(),
        qp, m, d, code, _stream(dev))
    _raise_on(rc, "refine_dots")
    launches[key] += 1
    return out


def pq_decode(codes, cb):
    """K8: (rows, m) uint8 codes, (m, ksub, dsub) bf16 codebook -> (rows,
    m*dsub) bf16 rows, row i's subspace c = codeword codes[i, c] bit for
    bit. Any row count, any dsub, ksub <= 256; every code must be < ksub
    (pq_encode emits them so, PqFlatIndex.adopt_codes checks)."""
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
    if rows == 0 or m == 0:
        return out
    rc = _lib().vdb_pq_decode(codes.data_ptr(), cb.data_ptr(),
                              out.data_ptr(), rows, m, ksub, dsub,
                              _stream(dev))
    _raise_on(rc, "pq_decode")
    launches["pq_decode"] += 1
    return out


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
    rc = _lib().vdb_scan_min(queries.data_ptr(), qaux.data_ptr(),
                             db.data_ptr(), raux.data_ptr(),
                             invalidf.data_ptr(), out.data_ptr(), n, q, d,
                             tile_rows, _MODES[mode], _stream(dev))
    _raise_on(rc, "scan_min")
    launches["scan_min"] += 1
    return out


__all__ = ["coarse_minima_1p_sup", "coarse_minima", "coarse_minima_f32_1p_sup",
           "coarse_minima_f32", "coarse_minima_1p",
           "coarse_minima_int8_1p_sup", "refine_dots", "pq_decode",
           "scan_min", "launches", "routes", "coarse_body",
           "reset_launches", "load", "build_info"]
