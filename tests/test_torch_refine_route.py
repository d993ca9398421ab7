"""K2's two bodies: the tile-major work list (the (query, tile) pairs
grouped by tile, in windows of at most ``_REFINE_WINDOW`` pairs a work
item), and the route by shape. CPU only: the work list is torch on the
tensor's device, and the route reads dtype, width and alignment."""

import numpy as np
import pytest
import torch

from vectordb_tpu_torch.ops import coarse_kernel as ck
from vectordb_tpu_torch.ops import cuda_kernels

WINDOW = cuda_kernels._REFINE_WINDOW


def _tile_idx(case, seed=0):
    """(Qp, m) int64 tile ids over 4096 tiles for each sharing pattern."""
    rng = np.random.default_rng(seed)
    qp, m = {"random": (129, 33), "same": (200, 32), "distinct": (64, 32),
             "m1": (300, 1), "qp1": (1, 33), "empty": (0, 32)}[case]
    if case == "same":              # every query picks the same m tiles
        ids = np.tile(rng.permutation(4096)[:m], (qp, 1))
    elif case == "distinct":        # no tile chosen twice
        ids = rng.permutation(4096)[:qp * m].reshape(qp, m)
    else:
        ids = rng.integers(0, 4096, (qp, m))
    return torch.from_numpy(ids.astype(np.int64))


CASES = ["random", "same", "distinct", "m1", "qp1", "empty"]


@pytest.mark.parametrize("case", CASES)
def test_work_list_covers_each_pair_once_grouped_by_tile(case):
    tidx = _tile_idx(case)
    qp, m = tidx.shape
    tiles, pairs = cuda_kernels._refine_work(tidx)
    assert tiles.dtype == torch.int32 and pairs.dtype == torch.int64
    # every (q, j) exactly once, with its own tile id beside it
    assert torch.equal(torch.sort(pairs).values, torch.arange(qp * m))
    assert torch.equal(tiles.long(), tidx.reshape(-1)[pairs])
    # equal tiles contiguous (sorted), stable: pair ids rise within a tile
    assert bool((tiles[1:] >= tiles[:-1]).all())
    same = tiles[1:] == tiles[:-1]
    assert bool((pairs[1:][same] > pairs[:-1][same]).all())


@pytest.mark.parametrize("case", CASES)
def test_work_items_hold_one_tile_and_at_most_a_window(case):
    """Each item is one tile's run inside one window of WINDOW sorted
    pairs: it starts at every window edge and every change of tile, so a
    tile every query chose is split into chunks of at most WINDOW
    queries, and every pair lies in exactly one item."""
    tiles, _ = cuda_kernels._refine_work(_tile_idx(case))
    p = tiles.numel()
    items = cuda_kernels._refine_items(tiles)
    ends = torch.cat([items[1:], torch.tensor([p])])
    if p == 0:
        assert items.numel() == 0
        return
    assert int(items[0]) == 0 and bool((ends > items).all())
    assert int((ends - items).sum()) == p          # a partition
    for a, b in zip(items.tolist(), ends.tolist()):
        assert b - a <= WINDOW
        assert a // WINDOW == (b - 1) // WINDOW     # inside one window
        assert bool((tiles[a:b] == tiles[a]).all())
    # as few items as that allows: one more only at a window edge
    changes = int((tiles[1:] != tiles[:-1]).sum()) + 1
    windows = (p + WINDOW - 1) // WINDOW
    assert changes <= items.numel() <= changes + windows - 1
    if case == "same":          # 200 queries a tile, in chunks of WINDOW
        counts = torch.unique(tiles, return_counts=True)[1]
        assert int(counts.max()) == 200
        assert int((ends - items).max()) == WINDOW


@pytest.mark.parametrize("case", ["random", "same", "distinct", "m1", "qp1"])
@pytest.mark.parametrize("src", ["f32", "bf16", "int8"])
def test_tile_major_walk_equals_plain(case, src):
    """The tile-major body's walk, in Python: per work item, the item's
    tile against each of its queries, written to out[q, j*16:(j+1)*16]
    (q, j from the pair id), int8 dots times their rows' scales. With
    integer-valued rows and queries every dot is exact, so it must equal
    ``_refine_dots_plain`` bit for bit."""
    rng = np.random.default_rng(7)
    tidx = _tile_idx(case, seed=1)
    qp, m = tidx.shape
    n, d = 4096 * 16, 24
    rows = torch.from_numpy(rng.integers(-100, 101, (n, d)).astype(
        np.float32))
    queries = torch.from_numpy(rng.integers(-9, 10, (qp, d)).astype(
        np.float32))
    scales = None
    if src == "bf16":
        rows = rows.to(torch.bfloat16)
    elif src == "int8":
        rows = rows.to(torch.int8)
        scales = torch.exp2(torch.from_numpy(
            rng.integers(-3, 4, n).astype(np.float32)))
    tiles, pairs = cuda_kernels._refine_work(tidx)
    items = cuda_kernels._refine_items(tiles).tolist() + [tiles.numel()]
    out = torch.full((qp, m * 16), float("nan"))
    for a, b in zip(items[:-1], items[1:]):
        t = int(tiles[a])
        tile = rows[t * 16:(t + 1) * 16].float()
        for pr in pairs[a:b].tolist():
            q, j = divmod(pr, m)
            dots = tile @ queries[q]
            if scales is not None:
                dots = dots * scales[t * 16:(t + 1) * 16]
            out[q, j * 16:(j + 1) * 16] = dots
    want = ck._refine_dots_plain(tidx, queries, rows, m, scales)
    assert torch.equal(out, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8])
@pytest.mark.parametrize("d", [768, 200, 37, 1792, 4096, 8192])
@pytest.mark.parametrize("aligned", [True, False])
def test_refine_route(dtype, d, aligned):
    """tile_major needs 16-byte aligned rows and queries, a width whose
    lane reads stay aligned (d % 4 == 0 for f32 rows, d % 8 == 0 for bf16
    rows and int8 codes) and two 16-row tiles in shared memory (f32 up to
    d = 1815, bf16 3630, int8 7260); everything else runs query_major."""
    itemsize = {torch.float32: 4, torch.bfloat16: 2, torch.int8: 1}[dtype]
    vec = 4 if dtype == torch.float32 else 8
    fits = 2 * 16 * d * itemsize <= 227 * 1024 - 128
    want = ("tile_major" if aligned and d % vec == 0 and fits
            else "query_major")
    assert cuda_kernels._refine_route(dtype, d, aligned) == want


@pytest.mark.parametrize("d, itemsize, stages", [
    (768, 4, 4), (768, 2, 8), (768, 1, 8), (1792, 4, 2), (1792, 2, 4),
    (2048, 4, 0), (200, 4, 8)])
def test_refine_stages_fill_shared_memory(d, itemsize, stages):
    """As many 16-row tiles as fit beside the barriers, at most 8; fewer
    than two is no ring at all (the route then takes query_major)."""
    assert cuda_kernels._refine_stages(d, itemsize) == stages


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8])
def test_refine_body_reads_alignment_from_rows_and_queries(dtype):
    buf = torch.zeros((64 * 768 + 16,), dtype=dtype)
    rows = buf[:64 * 768].view(64, 768)
    shifted = buf[1:64 * 768 + 1].view(64, 768)       # 1, 2 or 4 bytes off
    qbuf = torch.zeros((4 * 768 + 4,))
    queries = qbuf[:4 * 768].view(4, 768)
    q_shifted = qbuf[1:4 * 768 + 1].view(4, 768)      # 4 bytes off
    assert cuda_kernels.refine_body(rows, queries) == "tile_major"
    assert cuda_kernels.refine_body(shifted, queries) == "query_major"
    assert cuda_kernels.refine_body(rows, q_shifted) == "query_major"


def test_refine_routes_are_counted_beside_launches():
    for key in ("refine_dots", "refine_dots_bf16", "refine_dots_int8"):
        assert set(cuda_kernels.routes[key]) == {"tile_major",
                                                 "query_major"}
    cuda_kernels.routes["refine_dots"]["tile_major"] += 3
    cuda_kernels.reset_launches()
    assert cuda_kernels.routes["refine_dots"]["tile_major"] == 0
