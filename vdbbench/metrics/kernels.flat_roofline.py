"""Tier 1's share of its roofline, in percent: the least time an H100
needs for the work that every exact answer of a call must do
(``bound``), over ``flat.scan_device_ms``.

The bound is the sum of two passes, each the larger of its operations
over the peak rate and its bytes over the peak bandwidth (NVIDIA's data
sheet, H100 SXM, dense: 989 TFLOP/s bf16, 67 TFLOP/s f32 outside the
tensor cores, 3.35 TB/s HBM):

  * K1, the bf16 pass over the rows' hi mirror: 2 Q N d operations in
    bf16 and N d 2 bytes;
  * K2, the exact f32 dots over each query's m candidate tiles of 16
    rows: 2 Q m 16 d operations in f32 and m 16 d 4 bytes (one query's
    tiles, the least a refine must read).

N is the configuration's live rows, not the store's padded capacity, so
the yardstick reads the same work whatever implements it; m is the
1-pass certified pool at k (201 at k=100 over 1M rows), written out here
so that it does not move with the program. Q and k are the traffic's.
"""

from vdbbench.manifest import load_module

PEAK_BF16 = 989e12        # FLOP/s
PEAK_F32 = 67e12          # FLOP/s
PEAK_BYTES = 3.35e12      # B/s
SUB, SUPER = 16, 16       # rows a tile, tiles a super-tile


def pool_tiles(k: int, n: int) -> int:
    """m: candidate tiles a query in the 1-pass certified refine."""
    t_all, t2 = n // SUB, n // (SUB * SUPER)
    coeff = 1.7 if SUB * k <= 256 else 2.5
    slack = max(22, int(coeff * (SUB * k) ** 0.5) + 1)
    m = min(max(32, k + slack), t_all)
    m2 = min(max(32, k + slack), t2)
    return min(m, m2 * SUPER)


def bound(n: int, d: int, q: int, k: int) -> dict:
    """Each pass's operations, bytes and bound in ms, what bounds it
    ("ops" or "bytes"), m, and ``ms``, their sum."""
    m = pool_tiles(k, n)
    passes = {"K1": (2.0 * q * n * d, PEAK_BF16, n * d * 2.0),
              "K2": (2.0 * q * m * SUB * d, PEAK_F32, m * SUB * d * 4.0)}
    out = {"m": m, "ms": 0.0}
    for name, (ops, peak, nbytes) in passes.items():
        t_ops, t_bytes = ops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
        out[name] = {"ops": ops, "bytes": nbytes, "ms": max(t_ops, t_bytes),
                     "by": "ops" if t_ops >= t_bytes else "bytes"}
        out["ms"] += out[name]["ms"]
    return out


def read(rec):
    scan = load_module("metrics", "flat.scan_device_ms").read(rec)
    if scan is None:
        return None
    conf, traf = rec.cell.config, rec.cell.traffic
    got = bound(int(conf["rows"]), int(conf["dim"]),
                int(traf["queries_per_call"]), int(traf["k"]))
    return 100.0 * got["ms"] / scan
