"""K8's two bodies: the route by shape, the tile_ring body's plan, and a
model of its walk over tiles of rows times groups of subspaces. CPU only:
the route reads dsub, m and alignment, the plan is arithmetic, and the
walk is modelled in numpy, one step of all the block's threads at a
time, with the kernel's own index stepping."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from vectordb_tpu_torch.ops import cuda_kernels
from vectordb_tpu_torch.ops import pq as pq_ops

SCAN_CHUNK = 16384


def _cu_constants() -> dict:
    """The ``constexpr int`` constants of pq_decode.cu's tile_ring body,
    read from the source, so that the model walks as the kernel does."""
    src = (Path(cuda_kernels.__file__).resolve().parent.parent / "csrc"
           / "pq_decode.cu").read_text()
    src = src[:src.index("constexpr int THREADS")]    # grid_stride's own
    return {k: int(v) for k, v in
            re.findall(r"constexpr int (\w+) = (\d+);", src)}


_CU = _cu_constants()
RTHREADS, STAGES, BLOCKS_PER_SM = (_CU["RTHREADS"], _CU["STAGES"],
                                   _CU["BLOCKS_PER_SM"])
BATCH, BAR_BYTES, SMEM_LIMIT = _CU["BATCH"], _CU["BAR_BYTES"], \
    _CU["SMEM_LIMIT"]


@pytest.mark.parametrize("dsub", [1, 2, 4, 5, 8, 16, 24, 64])
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("m", [1, 96, 4096, 4097])
def test_decode_route(dsub, aligned, m):
    """tile_ring takes 16-byte codewords or multiples of them (dsub % 8
    == 0) with aligned codes and codebook and m <= 4096; every other
    shape runs grid_stride."""
    want = ("tile_ring" if aligned and dsub % 8 == 0 and m <= 4096
            else "grid_stride")
    assert cuda_kernels._decode_route(dsub, aligned, m) == want


def test_decode_body_reads_alignment_from_codes_cb_and_out():
    """The route reads the alignment of the codes and the codebook; the
    output is the wrapper's own ``torch.empty``, which is aligned."""
    rows, m, ksub, dsub = 64, 96, 256, 8
    cbuf = torch.zeros(rows * m + 16, dtype=torch.uint8)
    codes, codes_off = (cbuf[:rows * m].view(rows, m),
                        cbuf[1:rows * m + 1].view(rows, m))
    bbuf = torch.zeros(m * ksub * dsub + 8, dtype=torch.bfloat16)
    cb, cb_off = (bbuf[:m * ksub * dsub].view(m, ksub, dsub),
                  bbuf[1:m * ksub * dsub + 1].view(m, ksub, dsub))
    body = cuda_kernels.decode_body
    assert body(codes, cb) == "tile_ring"
    assert body(codes_off, cb) == "grid_stride"
    assert body(codes, cb_off) == "grid_stride"
    assert body(codes, cb[:, :, :4].contiguous()) == "grid_stride"
    for r in (1, 15, SCAN_CHUNK):
        out = torch.empty((r, m * dsub), dtype=torch.bfloat16)
        assert out.data_ptr() % 16 == 0


@pytest.mark.parametrize("m, ksub, dsub", [
    (96, 256, 8), (1, 256, 8), (7, 256, 8), (48, 256, 16), (4096, 256, 8),
    (1, 16, 16), (3, 1, 64), (192, 256, 8), (8, 256, 768)])
def test_decode_plan_fits_the_kernel(m, ksub, dsub):
    """Tiles are a multiple of 16 rows (aligned code copies); a group's
    codebook slice fits the L1 budget unless it is one subspace; the
    ring's code stages fit in shared memory; an item stays near the aimed number
    of output words unless 16 rows already pass it."""
    tile_rows, group = cuda_kernels._decode_plan(m, ksub, dsub)
    words = dsub // 8
    assert tile_rows >= 16 and tile_rows % 16 == 0
    assert 1 <= group <= m
    assert group == 1 or group * ksub * dsub * 2 <= 96 * 1024
    assert BAR_BYTES + STAGES * tile_rows * m <= SMEM_LIMIT
    assert (tile_rows == 16
            or tile_rows * group * words <= cuda_kernels._DECODE_TILE_WORDS)
    if (m, ksub, dsub) == (96, 256, 8):          # the scan chunk's shape
        assert (tile_rows, group) == (32, 24)


def _walk(codes, cb_bits, tile_rows, group, sms=132):
    """pq_decode_tiles_kernel's walk: returns (out (rows, m*words, 8)
    uint16, writes per output word). Each block takes items blockIdx.x +
    local * grid (a grid that is a multiple of the group count keeps a
    block on one group); thread 0 fills stage local % STAGES with the
    item's first ``bulk`` code bytes, the kernel's threads wait on that
    stage at parity (local // STAGES) & 1, read code p from the stage
    when p < bulk and from global memory otherwise, and step (r, c, w) by
    RTHREADS words with the kernel's carries."""
    rows, m = codes.shape
    _, ksub, dsub = cb_bits.shape
    words = dsub // 8
    cbw = cb_bits.reshape(-1, 8)
    flat = codes.reshape(-1).astype(np.int64)
    n_groups = -(-m // group)
    items = -(-rows // tile_rows) * n_groups
    grid = sms * BLOCKS_PER_SM
    if grid >= n_groups:
        grid -= grid % n_groups
    grid = min(grid, items)
    out = np.zeros((rows * m * words, 8), np.uint16)
    writes = np.zeros(rows * m * words, np.int64)
    tid = np.arange(RTHREADS)
    for b in range(grid):
        filled = {s: [] for s in range(STAGES)}     # items each stage held
        groups = set()

        def issue(local):
            item = b + local * grid
            if item < items:
                filled[local % STAGES].append(item)

        for local in range(STAGES):
            issue(local)
        local = 0
        while b + local * grid < items:
            item = b + local * grid
            s, use = local % STAGES, local // STAGES
            assert filled[s][use] == item      # the phase waited on
            t, g = divmod(item, n_groups)
            row0, c0 = t * tile_rows, g * group
            nrows, gsize = min(tile_rows, rows - row0), min(group, m - c0)
            groups.add(g)
            cols = gsize * words
            total = nrows * cols
            bulk = (nrows * m) & ~15
            assert bulk % 16 == 0 and (row0 * m) % 16 == 0
            stage = flat[row0 * m:row0 * m + bulk]    # the bulk copy
            r = tid // cols
            c = (tid - r * cols) // words
            w = tid - r * cols - c * words
            dr = RTHREADS // cols
            dc = (RTHREADS - dr * cols) // words
            dw = RTHREADS - dr * cols - dc * words
            for o0 in range(0, total, BATCH * RTHREADS):
                for u in range(BATCH):
                    o = o0 + u * RTHREADS + tid
                    live = o < total
                    assert np.array_equal(r[live], o[live] // cols)
                    assert np.array_equal(c[live] * words + w[live],
                                          o[live] % cols)
                    p = r * m + c0 + c
                    assert (p[live] < nrows * m).all()
                    from_stage = live & (p < bulk)
                    from_tail = live & (p >= bulk)
                    code = np.zeros(RTHREADS, np.int64)
                    code[from_stage] = stage[p[from_stage]]
                    code[from_tail] = flat[row0 * m + p[from_tail]]
                    assert (code[live] < ksub).all()
                    src = ((c0 + c) * ksub + code) * words + w
                    dst = (row0 + r) * m * words + (c0 + c) * words + w
                    out[dst[live]] = cbw[src[live]]
                    np.add.at(writes, dst[live], 1)
                    w = w + dw
                    c = c + dc
                    carry = w >= words
                    w = np.where(carry, w - words, w)
                    c = np.where(carry, c + 1, c)
                    carry = c >= gsize
                    c = np.where(carry, c - gsize, c)
                    r = np.where(carry, r + 1, r) + dr
            issue(local + STAGES)
            local += 1
        if grid % n_groups == 0:            # a block keeps one group
            assert len(groups) <= 1
    return out.reshape(rows, m * words, 8), writes


def _operands(rows, m, ksub, dsub, seed=0):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, ksub, (rows, m), dtype=np.uint8)
    cb = torch.from_numpy(rng.standard_normal(
        (m, ksub, dsub), dtype=np.float32)).to(torch.bfloat16)
    return codes, cb


@pytest.mark.parametrize("rows", [0, 1, 15, SCAN_CHUNK, 16385])
@pytest.mark.parametrize("m", [1, 7, 96])
def test_tile_walk_writes_every_word_once(rows, m):
    """Every (row, subspace) word of the output is written exactly once,
    with the codeword its code names: the walk equals the plain decode
    bit for bit."""
    ksub, dsub = 256, 8
    codes, cb = _operands(rows, m, ksub, dsub)
    tile_rows, group = cuda_kernels._decode_plan(m, ksub, dsub)
    out, writes = _walk(codes, cb.view(torch.int16).numpy().view(np.uint16),
                        tile_rows, group)
    assert (writes == 1).all()
    want = pq_ops._decode_rows_plain(torch.from_numpy(codes), cb)
    assert np.array_equal(out.reshape(rows, m * dsub),
                          want.view(torch.int16).numpy().view(np.uint16))


@pytest.mark.parametrize("rows, m, ksub, dsub, sms", [
    (1000, 48, 256, 16, 132), (333, 5, 16, 24, 132), (77, 96, 1, 64, 132),
    (SCAN_CHUNK + 3, 96, 256, 8, 3), (40, 3, 200, 8, 1),
    (500, 50, 256, 8, 132), (500, 50, 256, 8, 2)])
def test_tile_walk_other_shapes_and_grids(rows, m, ksub, dsub, sms):
    """Codewords of two to eight words, small ksub, groups that do not
    divide m, and grids of a few blocks that each walk many items through
    the ring."""
    codes, cb = _operands(rows, m, ksub, dsub, seed=3)
    tile_rows, group = cuda_kernels._decode_plan(m, ksub, dsub)
    out, writes = _walk(codes, cb.view(torch.int16).numpy().view(np.uint16),
                        tile_rows, group, sms=sms)
    assert (writes == 1).all()
    want = pq_ops._decode_rows_plain(torch.from_numpy(codes), cb)
    assert np.array_equal(out.reshape(rows, m * dsub),
                          want.view(torch.int16).numpy().view(np.uint16))


def test_model_constants_are_the_kernels():
    """The walk's constants come from pq_decode.cu itself, and the host
    side's ring sizes agree with them: two stages of 16 rows of codes at
    the widest routed m fit in the kernel's shared memory."""
    assert {"RTHREADS", "STAGES", "BLOCKS_PER_SM", "BATCH", "BAR_BYTES",
            "SMEM_LIMIT"} <= set(_CU)
    assert RTHREADS % 32 == 0 and STAGES >= 2 and BATCH >= 1
    assert BAR_BYTES >= 8 * STAGES
    assert BAR_BYTES + STAGES * 16 * cuda_kernels._DECODE_MAX_M <= SMEM_LIMIT


def test_decode_routes_are_counted_beside_launches():
    assert set(cuda_kernels.routes["pq_decode"]) == {"tile_ring",
                                                     "grid_stride"}
    cuda_kernels.routes["pq_decode"]["tile_ring"] += 2
    cuda_kernels.reset_launches()
    assert cuda_kernels.routes["pq_decode"]["tile_ring"] == 0


def test_decode_wrappers_refuse_cpu_tensors():
    codes, cb = _operands(4, 96, 256, 8)
    codes = torch.from_numpy(codes)
    for fn in (cuda_kernels.pq_decode, cuda_kernels.pq_decode_grid_stride):
        with pytest.raises(ValueError, match="CUDA"):
            fn(codes, cb)
    # the launcher's CPU tensors take the plain version
    assert torch.equal(pq_ops.pq_decode_rows(codes, cb),
                       pq_ops._decode_rows_plain(codes, cb))
