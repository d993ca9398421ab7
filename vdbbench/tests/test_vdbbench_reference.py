"""The plain reference against a brute-force NumPy top-k."""

import numpy as np
import pytest
import torch

from vdbbench.references import exact_topk as ref


def _numpy_dists(q, x, metric):
    q = q.astype(np.float64)
    x = x.astype(np.float64)
    if metric == "dot":
        return -(q @ x.T)
    if metric == "euclidean":
        return np.sqrt(((q[:, None, :] - x[None, :, :]) ** 2).sum(-1))
    sim = (q @ x.T) / (np.linalg.norm(q, axis=1)[:, None]
                       * np.linalg.norm(x, axis=1)[None, :])
    return 1.0 - np.clip(sim, -1.0, 1.0)


@pytest.mark.parametrize("metric", ["euclidean", "cosine", "dot"])
@pytest.mark.parametrize("k", [1, 7, 50])
def test_topk_matches_brute_force(metric, k, monkeypatch):
    monkeypatch.setattr(ref, "BLOCK_ROWS", 64)      # several blocks
    rng = np.random.default_rng(3)
    x = rng.standard_normal((300, 24)).astype(np.float32)
    q = rng.standard_normal((9, 24)).astype(np.float32)
    want = _numpy_dists(q, x, metric)
    order = np.argsort(want, axis=1, kind="stable")[:, :k]
    d, i = ref.topk(torch.from_numpy(q), torch.from_numpy(x), metric, k)
    np.testing.assert_array_equal(i.numpy(), order)
    np.testing.assert_allclose(d.numpy(), np.take_along_axis(want, order, 1),
                               rtol=0, atol=1e-12)
    back = ref.distances_of(torch.from_numpy(q), torch.from_numpy(x), i,
                            metric)
    np.testing.assert_allclose(back.numpy(), d.numpy(), rtol=0, atol=1e-12)


def test_distances_of_marks_absent_rows():
    x = torch.randn(10, 4)
    q = torch.randn(2, 4)
    idx = torch.tensor([[0, -1], [3, 2]])
    got = ref.distances_of(q, x, idx, "euclidean")
    assert torch.isinf(got[0, 1]) and torch.isfinite(got[1]).all()


def test_tf32_round_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      -2.5, 0.0])
    got = ref.tf32_round(x)
    # 1 + 2^-11 is a tie: to even (1.0); 1 + 3 * 2^-11 rounds up
    assert got.tolist() == [1.0, 1.0 + 2 ** -10, 1.0, 1.0 + 2 ** -9,
                            -2.5, 0.0]
    bits = ref.tf32_round(torch.randn(1000)).view(torch.int32)
    assert int((bits & 0x1FFF).abs().max()) == 0


def test_tf32_control_departs_from_f64():
    torch.manual_seed(0)
    x = torch.randn(2000, 256)
    q = torch.randn(8, 256)
    d64, _ = ref.topk(q, x, "cosine", 10, "f64")
    d32, _ = ref.topk(q, x, "cosine", 10, "tf32")
    assert float((d64 - d32.double()).abs().max()) > 1e-5
