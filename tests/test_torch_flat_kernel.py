"""The port's two-phase exact scan (ops/flat_kernel.py, kernel K9) against
the JAX package's, on the CPU.

The JAX side runs its Pallas scan in interpret mode, as
tests/test_flat_kernel.py does; the port runs the plain version of K9 on
CPU tensors. Tile minima agree to f32 summation order, and the searches
return the same ids and distances (continuous random data: no ties).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vectordb_tpu.ops import flat_kernel as jfk

from vectordb_tpu_torch.distance import DistanceMetric, pairwise_distances
from vectordb_tpu_torch.ops import cuda_kernels
from vectordb_tpu_torch.ops import flat_kernel as tfk

torch.set_num_threads(1)

METRICS = ["euclidean", "dot_product", "cosine"]


def _aux(queries, db, mode):
    sq = np.einsum("ij,ij->i", db, db).astype(np.float32)
    qsq = np.einsum("ij,ij->i", queries, queries).astype(np.float32)
    if mode == "euclidean":
        return qsq, sq
    if mode == "dot":
        return (np.zeros(len(queries), np.float32),
                np.zeros(len(db), np.float32))
    return np.sqrt(qsq), np.sqrt(sq)


def _both(queries, db, metric, k, valid=None, tile_rows=128):
    """(JAX (dists, idx), port (dists, idx)) of two_phase_search."""
    sq = np.einsum("ij,ij->i", db, db).astype(np.float32)
    norms = np.sqrt(sq)
    if valid is None:
        valid = np.ones(db.shape[0], dtype=bool)
    jd, ji = jfk.two_phase_search(
        jnp.asarray(queries), jnp.asarray(db), jnp.asarray(sq),
        jnp.asarray(norms), jnp.asarray(valid), metric, k,
        tile_rows=tile_rows, interpret=True)
    td, ti = tfk.two_phase_search(
        torch.from_numpy(queries), torch.from_numpy(db),
        torch.from_numpy(sq), torch.from_numpy(norms),
        torch.from_numpy(valid), metric, k, tile_rows=tile_rows)
    return (np.asarray(jd), np.asarray(ji)), (td.numpy(), ti.numpy())


@pytest.mark.parametrize("mode", ["euclidean", "dot", "cosine"])
@pytest.mark.parametrize("tile_rows", [128, 64])
def test_tile_minima_matches_jax(mode, tile_rows):
    rng = np.random.default_rng(0)
    db = rng.standard_normal((1024, 48)).astype(np.float32)
    queries = rng.standard_normal((6, 48)).astype(np.float32)
    invalid = (rng.random(1024) < 0.1).astype(np.float32)
    invalid[:tile_rows] = 1.0                 # one wholly dead tile
    qaux, raux = _aux(queries, db, mode)
    want = np.asarray(jfk.tile_minima(
        jnp.asarray(queries), jnp.asarray(qaux), jnp.asarray(db),
        jnp.asarray(raux), jnp.asarray(invalid), mode, tile_rows,
        interpret=True))
    got = tfk.tile_minima(*(torch.from_numpy(x) for x in (
        queries, qaux, db, raux, invalid)), mode, tile_rows).numpy()
    assert got.shape == want.shape == (6, 1024 // tile_rows)
    live = want < 1e29
    assert np.array_equal(live, got < 1e29)
    scale = 1.0 if mode == "cosine" else float(
        np.sqrt((db * db).sum(1).max() * (queries * queries).sum(1).max()))
    assert np.abs(got - want)[live].max() <= 1e-6 * scale


@pytest.mark.parametrize("metric", METRICS)
def test_two_phase_matches_jax(metric):
    rng = np.random.default_rng(1)
    db = rng.standard_normal((1024, 64)).astype(np.float32) + 1.0
    queries = rng.standard_normal((4, 64)).astype(np.float32) + 1.0
    valid = rng.random(1024) >= 0.1
    (jd, ji), (td, ti) = _both(queries, db, metric, 10, valid)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(td, jd, rtol=2e-5, atol=1e-6)
    # and both are the exact top-k of the oracle
    oracle = pairwise_distances(torch.from_numpy(queries),
                                torch.from_numpy(db),
                                DistanceMetric(metric)).numpy()
    oracle[:, ~valid] = np.inf
    np.testing.assert_array_equal(np.sort(ti, axis=1),
                                  np.sort(np.argsort(oracle, axis=1)[:, :10],
                                          axis=1))


def test_respects_validity_mask():
    rng = np.random.default_rng(2)
    db = rng.standard_normal((512, 32)).astype(np.float32)
    queries = db[:2] + 0.01
    valid = np.ones(512, dtype=bool)
    valid[0] = False              # knock out the nearest row of query 0
    (jd, ji), (td, ti) = _both(queries, db, "euclidean", 5, valid)
    assert 0 not in ti[0] and np.all(np.isfinite(td))
    np.testing.assert_array_equal(ti, ji)


def test_fewer_live_rows_than_k():
    rng = np.random.default_rng(3)
    db = rng.standard_normal((256, 16)).astype(np.float32)
    valid = np.zeros(256, dtype=bool)
    valid[:3] = True
    query = rng.standard_normal((1, 16)).astype(np.float32)
    (jd, ji), (td, ti) = _both(query, db, "euclidean", 8, valid,
                               tile_rows=64)
    finite = np.isfinite(td[0])
    assert finite.sum() == 3 and set(ti[0][finite]) == {0, 1, 2}
    np.testing.assert_array_equal(np.isfinite(jd), np.isfinite(td))
    np.testing.assert_allclose(td[np.isfinite(td)], jd[np.isfinite(jd)],
                               rtol=2e-5)


def test_exactness_adversarial_tile_packing():
    """All of the true top-k packed into one tile: the k-best-tiles filter
    still keeps every one of them."""
    rng = np.random.default_rng(4)
    n, d, k, tile_rows = 512, 8, 10, 64
    db = rng.standard_normal((n, d)).astype(np.float32) * 10 + 100
    query = np.zeros((1, d), dtype=np.float32)
    base = 3 * tile_rows
    for j in range(k):
        db[base + j] = j * 0.01
    (_, ji), (_, ti) = _both(query, db, "euclidean", k, tile_rows=tile_rows)
    assert set(ti[0]) == set(ji[0]) == {base + j for j in range(k)}


def test_large_k_spanning_many_tiles():
    rng = np.random.default_rng(5)
    db = rng.standard_normal((1024, 16)).astype(np.float32)
    queries = rng.standard_normal((2, 16)).astype(np.float32)
    (jd, ji), (td, ti) = _both(queries, db, "euclidean", 64)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(td, jd, rtol=2e-5, atol=1e-6)


def test_tile_minima_checks_its_inputs():
    z = torch.zeros
    with pytest.raises(ValueError, match="multiple"):
        tfk.tile_minima(z((2, 8)), z(2), z((100, 8)), z(100), z(100),
                        "dot", 64)
    # the kernel wrapper takes CUDA tensors only: no fallback inside it
    with pytest.raises(ValueError, match="CUDA"):
        cuda_kernels.scan_min(z((2, 8)), z(2), z((128, 8)), z(128), z(128),
                              "dot", 64)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_kernels.pq_decode(torch.zeros((4, 2), dtype=torch.uint8),
                               torch.zeros((2, 4, 3), dtype=torch.bfloat16))
    assert cuda_kernels.launches["scan_min"] == 0
    assert cuda_kernels.launches["pq_decode"] == 0
