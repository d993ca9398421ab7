"""Port primitives against the JAX package on the same numpy inputs:
batched distances, scalar distances, filter masks, scatter updates, and
the pin on IEEE f32 matmuls (no TF32)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vectordb_tpu import distance as jdist
from vectordb_tpu import metadata as jmeta
from vectordb_tpu_torch import distance as tdist
from vectordb_tpu_torch import metadata as tmeta
from vectordb_tpu_torch.ops import update
from vectordb_tpu_torch.vector import Vector

# One intra-op thread: these tests are small, and an OpenMP pool left
# behind in a pytest worker perturbs the thread timing of tests that
# share it (the parallel native HNSW build in tests/test_recall.py).
torch.set_num_threads(1)

METRICS = ["euclidean", "cosine", "dot_product"]


@pytest.mark.parametrize("metric", METRICS)
def test_pairwise_distances_match_jax(metric):
    rng = np.random.default_rng(3)
    q = rng.standard_normal((8, 32)).astype(np.float32)
    db = rng.standard_normal((300, 32)).astype(np.float32)
    want = np.asarray(jdist.pairwise_distances(
        jnp, jnp.asarray(q), jnp.asarray(db), jdist.DistanceMetric(metric),
        precision="highest"))
    got = tdist.pairwise_distances(torch.from_numpy(q), torch.from_numpy(db),
                                   tdist.DistanceMetric(metric)).numpy()
    # f32 summation order only: rtol 2e-5 as the JAX package's own tests
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("metric", METRICS)
def test_scalar_distances_match_jax(metric):
    rng = np.random.default_rng(4)
    a, b = rng.standard_normal((2, 16)).astype(np.float32)
    from vectordb_tpu.vector import Vector as JVector
    want = jdist.DistanceMetric(metric).distance(JVector(a), JVector(b))
    got = tdist.DistanceMetric(metric).distance(Vector(a), Vector(b))
    assert got == want


def test_prepare_device_pins_ieee_f32():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        torch.set_float32_matmul_precision("medium")
        assert tdist.prepare_device("cpu") == torch.device("cpu")
        assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cudnn.allow_tf32 is False
        assert torch.get_float32_matmul_precision() == "highest"
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def test_flat_index_construction_pins_ieee_f32():
    from vectordb_tpu_torch.index.flat import FlatIndex
    torch.set_float32_matmul_precision("high")
    try:
        FlatIndex(tdist.DistanceMetric.EUCLIDEAN, device="cpu")
        assert torch.get_float32_matmul_precision() == "highest"
        assert torch.backends.cuda.matmul.allow_tf32 is False
    finally:
        torch.set_float32_matmul_precision("highest")


_FILTERS = [
    {"op": "eq", "field": "c", "value": "1"},
    {"op": "ne", "field": "c", "value": "1"},
    {"op": "exists", "field": "t"},
    {"op": "eq", "field": "missing", "value": "x"},
    {"op": "and", "filters": [{"op": "eq", "field": "c", "value": "2"},
                              {"op": "exists", "field": "t"}]},
    {"op": "or", "filters": [{"op": "eq", "field": "c", "value": "0"},
                             {"op": "ne", "field": "t", "value": "a"}]},
]


@pytest.mark.parametrize("flt", _FILTERS, ids=lambda f: f["op"])
def test_filter_masks_match_jax(flt):
    rng = np.random.default_rng(5)
    cols = {m: m.ColumnarMetadata(64) for m in (jmeta, tmeta)}
    for slot in rng.choice(64, 50, replace=False):
        fields = {"c": str(rng.integers(3))}
        if rng.random() < 0.5:
            fields["t"] = "ab"[int(rng.integers(2))]
        for mod, col in cols.items():
            col.set_slot(int(slot), mod.Metadata(fields))
    want = cols[jmeta].compile_mask(jmeta.MetadataFilter.from_dict(flt))
    got = cols[tmeta].compile_mask(tmeta.MetadataFilter.from_dict(flt))
    assert np.array_equal(got, want)


def test_scatter_in_place_and_copy():
    buf = torch.zeros((6, 3))
    idx = torch.tensor([1, 4])
    rows = torch.ones((2, 3))
    out = update.scatter_rows_copy(buf, idx, rows)
    assert buf.sum() == 0 and out[[1, 4]].eq(1).all()
    same = update.scatter_rows(buf, idx, rows)
    assert same.data_ptr() == buf.data_ptr() and buf[[1, 4]].eq(1).all()
    vals = torch.zeros(6)
    update.scatter_values(vals, idx, torch.tensor([2.0, 3.0]))
    assert vals.tolist() == [0, 2, 0, 0, 3, 0]
    fresh = update.scatter_values_copy(vals, idx, torch.tensor([5.0, 5.0]))
    assert vals[1] == 2 and fresh[1] == 5
