"""One sharded serving step on an n-shard mesh, at tiny shapes.

Port of ``__graft_entry__.dryrun_multichip``. The JAX package starts a
virtual CPU mesh in a subprocess when devices are short; the port's
counterpart of a virtual mesh is a mesh that repeats a device, so no
subprocess is needed: with fewer devices than shards, the shards cycle
over the devices there are.

    python -c "from vectordb_tpu_torch.parallel import dryrun_multichip
    print(dryrun_multichip(8, devices=['cpu']))"
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch


def _pool(n_devices: int, devices: Optional[Sequence]) -> list:
    """``n_devices`` devices drawn from ``devices`` (default: the visible
    CUDA devices), cycling when there are fewer."""
    if devices is None:
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if not devices:
        raise RuntimeError("no CUDA device: pass devices=['cpu'] to run "
                           "the dry run on the CPU")
    return [devices[i % len(devices)] for i in range(n_devices)]


def dryrun_multichip(n_devices: int, devices: Optional[Sequence] = None
                     ) -> dict:
    """One full sharded serving step on an ``n_devices``-shard mesh:
    a 2-D (rows x batch) exact index with a scatter update and a search,
    the 1-D certified coarse route, a sharded store with upsert and
    delete, int8 storage, and PQ codes. ``devices`` (the port's own) is
    the pool, repeated as needed. Returns what ran."""
    from ..distance import DistanceMetric
    from ..ops.coarse_kernel import residual_max_norm_f32
    from .distributed import DistributedFlatIndex
    from .mesh import make_mesh

    pool = _pool(n_devices, devices)
    # a 2-D mesh (rows x batch) when possible, else 1-D rows
    if n_devices % 2 == 0 and n_devices >= 4:
        mesh = make_mesh(n_devices, axis_names=("shard", "batch"),
                         shape=(n_devices // 2, 2), devices=pool)
        batch_axis = "batch"
    else:
        mesh = make_mesh(n_devices, devices=pool)
        batch_axis = None

    rng = np.random.default_rng(1)
    n, d, q, k = 64 * n_devices, 32, 4, 5
    db = rng.standard_normal((n, d)).astype(np.float32)

    index = DistributedFlatIndex(mesh, DistanceMetric.EUCLIDEAN,
                                 batch_axis=batch_axis)
    index.load(db)

    # write path: a scatter update of slots 0 and 1 (shard 0) in place;
    # the new rows can only raise the residual bound the certificate reads
    db_s, sq_s, norm_s, valid_s = (parts[0] for parts in index._device)
    slots = torch.arange(2, device=db_s.device)
    new_rows = torch.from_numpy(
        rng.standard_normal((2, d)).astype(np.float32)).to(db_s.device)
    row_sq = (new_rows * new_rows).sum(dim=1)
    db_s.index_copy_(0, slots, new_rows)
    sq_s.index_copy_(0, slots, row_sq)
    norm_s.index_copy_(0, slots, torch.sqrt(row_sq))
    valid_s.index_fill_(0, slots, True)
    index._elo_max = torch.maximum(index._elo_max,
                                   residual_max_norm_f32(new_rows).to(
                                       index._elo_max.device))

    # read path: the sharded search and the distributed top-k merge
    queries = np.concatenate(
        [new_rows[:1].cpu().numpy(),
         rng.standard_normal((q - 1, d)).astype(np.float32)])
    results = index.search_batch(queries, k)
    assert len(results) == q
    assert results[0][0][0] == 0, "freshly written row must be its own NN"
    for row in results:
        assert len(row) == k
        dists = [r[1] for r in row]
        assert dists == sorted(dists)
        assert all(np.isfinite(dists))

    # the certified coarse route on a 1-D mesh
    mesh1d = make_mesh(n_devices, devices=pool)
    cindex = DistributedFlatIndex(mesh1d, DistanceMetric.EUCLIDEAN)
    cindex.load(db)
    assert cindex._elo_max is not None, "coarse path should be armed"
    cresults = cindex.search_batch(queries[:2], k)
    assert len(cresults) == 2 and all(len(r) == k for r in cresults)
    for row in cresults:
        dd = [r[1] for r in row]
        assert dd == sorted(dd) and all(np.isfinite(dd))

    # the production stack over the same route: string ids, metadata,
    # upsert, delete; int8 storage; PQ codes
    _dryrun_store(mesh1d, rng, d, k)
    _dryrun_int8(mesh1d, rng, d, k)
    _dryrun_pq(mesh1d, rng)
    return {"mesh": mesh.shape, "devices": [str(x) for x in pool],
            "rows": n, "queries": q, "k": k}


def _dryrun_store(mesh, rng, d: int, k: int) -> None:
    """Store-level sharded serving: insert / upsert / delete + batched
    search through VectorStore(FlatIndex(mesh=...))."""
    from ..distance import DistanceMetric
    from ..index.flat import FlatIndex
    from ..store import BatchInsertItem, VectorStore
    from ..vector import Vector

    store = VectorStore(FlatIndex(DistanceMetric.EUCLIDEAN, mesh=mesh))
    rows = rng.standard_normal((64, d)).astype(np.float32)
    store.insert_batch([BatchInsertItem(id=f"v{i}", vector=Vector(rows[i]))
                        for i in range(len(rows))])
    store.delete("v3")
    store.insert("v5", Vector(rows[5] + 0.25))  # upsert: fresh internal id
    out = store.search_batch([(Vector(rows[0]), k), (Vector(rows[7]), k)])
    assert len(out) == 2 and all(len(r) == k for r in out)
    assert out[0][0].id == "v0" and out[1][0].id == "v7"
    for r in out:
        dd = [h.distance for h in r]
        assert dd == sorted(dd)
        assert all(h.id != "v3" for h in r), "deleted id must not appear"


def _dryrun_int8(mesh, rng, d: int, k: int) -> None:
    """int8 storage on the mesh: codes + pow2 scales sharded over the
    row axis, exact over the stored values."""
    from ..distance import DistanceMetric
    from ..store import VectorStore
    from ..vector import Vector

    store = VectorStore.with_sharded_flat_index(
        DistanceMetric.EUCLIDEAN, mesh, storage="int8")
    rows = rng.standard_normal((96, d)).astype(np.float32)
    for i in range(len(rows)):
        store.insert(f"i{i}", Vector(rows[i]))
    with store.index._lock:
        dev = store.index._sync_device()
    assert all(t.dtype == torch.int8 for t in dev["db"]), dev["db"]
    out = store.search_batch([(Vector(rows[3]), k)])
    assert out[0][0].id == "i3", "stored row must be its own NN"
    dd = [h.distance for h in out[0]]
    assert dd == sorted(dd) and len(out[0]) == k


def _dryrun_pq(mesh, rng) -> None:
    """PQ codes on the mesh: per-shard streaming scan, exact merged
    top-r, exact host re-rank."""
    from ..distance import DistanceMetric
    from ..index.pq import PqFlatIndex
    from ..store import VectorStore
    from ..vector import Vector

    d = 32
    idx = PqFlatIndex(DistanceMetric.EUCLIDEAN, m=4, ksub=16, refine=64,
                      auto_train_min=10 ** 9, seed=0, mesh=mesh)
    store = VectorStore.with_index(idx)
    rows = rng.standard_normal((400, d)).astype(np.float32)
    for i in range(len(rows)):
        store.insert(f"p{i}", Vector(rows[i]))
    idx.train()
    assert idx.is_trained
    out = store.search_batch([(Vector(rows[11]), 5),
                              (Vector(rows[42]), 5)])
    assert out[0][0].id == "p11" and out[1][0].id == "p42"
    for row in out:
        dd = [h.distance for h in row]
        assert dd == sorted(dd) and len(row) == 5
