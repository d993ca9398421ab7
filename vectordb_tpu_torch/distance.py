"""Distance metrics: scalar (host) API and the batched torch formulation.

Capability parity with reference src/distance.rs:9-73 (scalar functions
carried over unchanged from ``vectordb_tpu.distance``):
  * ``DistanceMetric.{EUCLIDEAN, COSINE, DOT_PRODUCT}``
  * ``distance(v1, v2)`` with an up-front dimension check
  * cosine distance = 1 - similarity, similarity clamped to [-1, 1],
    zero vectors are an error
  * dot-product distance = -dot (so that "smaller is better" holds for
    every metric)

``pairwise_distances`` is the batched form used by the plain f32 scan
(ops/topk.py): one (Q, d) x (d, N) matmul plus row-norm corrections.
f32 matmuls must run in IEEE f32, never TF32: ``prepare_device`` pins
both PyTorch switches wherever device state is built.
"""

from __future__ import annotations

import enum

import numpy as np
import torch

from .errors import DimensionMismatchError, InvalidVectorError
from .vector import Vector, as_f32_array


class DistanceMetric(enum.Enum):
    """Supported distance metrics (reference: src/distance.rs:9-16)."""

    EUCLIDEAN = "euclidean"
    COSINE = "cosine"
    DOT_PRODUCT = "dot_product"

    # -- scalar host path (exact reference semantics) ----------------------

    def distance(self, v1: Vector, v2: Vector) -> float:
        """Distance between two vectors; smaller is always better
        (reference: src/distance.rs:20-33)."""
        if not v1.has_same_dimension(v2):
            raise DimensionMismatchError(v1.dimension, v2.dimension)
        if self is DistanceMetric.EUCLIDEAN:
            return euclidean_distance(v1, v2)
        if self is DistanceMetric.COSINE:
            return cosine_distance(v1, v2)
        return -dot_product(v1, v2)

    @classmethod
    def from_name(cls, name: str) -> "DistanceMetric":
        try:
            return cls(name.lower())
        except ValueError:
            raise ValueError(f"Unknown distance metric: {name}") from None


def euclidean_distance(v1: Vector, v2: Vector) -> float:
    """L2 distance (reference: src/distance.rs:37-44)."""
    a = as_f32_array(v1)
    b = as_f32_array(v2)
    diff = a - b
    return float(np.sqrt(np.float32(np.dot(diff, diff))))


def cosine_distance(v1: Vector, v2: Vector) -> float:
    """1 - cosine similarity, clamped; zero vectors error
    (reference: src/distance.rs:47-64)."""
    a = as_f32_array(v1)
    b = as_f32_array(v2)
    norm1 = float(np.sqrt(np.float32(np.dot(a, a))))
    norm2 = float(np.sqrt(np.float32(np.dot(b, b))))
    if norm1 == 0.0 or norm2 == 0.0:
        raise InvalidVectorError("Cannot compute cosine distance with zero vector")
    sim = float(np.dot(a, b)) / (norm1 * norm2)
    sim = max(-1.0, min(1.0, sim))
    return 1.0 - sim


def dot_product(v1: Vector, v2: Vector) -> float:
    """Plain dot product (reference: src/distance.rs:67-73)."""
    a = as_f32_array(v1)
    b = as_f32_array(v2)
    return float(np.float32(np.dot(a, b)))


def prepare_device(device) -> torch.device:
    """Resolve ``device`` and pin IEEE f32 matmuls.

    Asking for CUDA without a card raises: nothing moves to the CPU on
    its own. TF32 keeps ~10 mantissa bits, which would break the exact
    scan's |q|^2+|x|^2-2q.x cancellation, so both switches are set here,
    where every index builds its device state."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            "is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return dev


def pairwise_distances(queries: torch.Tensor, db: torch.Tensor,
                       metric: DistanceMetric, db_sq_norms=None,
                       db_norms=None) -> torch.Tensor:
    """Distances of shape (Q, N) between ``queries`` (Q, d) and ``db``
    (N, d), all f32 tensors on one device:
      * euclidean: sqrt(relu(|q|^2 + |x|^2 - 2 q.x))
      * cosine:    1 - clip(q.x / (|q| |x|), -1, 1)
      * dot:       -q.x
    Zero-norm handling for cosine is done by callers (host-side
    validation), matching reference error semantics."""
    dots = queries @ db.T
    if metric is DistanceMetric.DOT_PRODUCT:
        return -dots
    if metric is DistanceMetric.EUCLIDEAN:
        if db_sq_norms is None:
            db_sq_norms = (db * db).sum(dim=1)
        q_sq = (queries * queries).sum(dim=1, keepdim=True)
        sq = q_sq + db_sq_norms[None, :] - 2.0 * dots
        return torch.sqrt(torch.clamp(sq, min=0.0))
    if db_norms is None:
        if db_sq_norms is None:
            db_sq_norms = (db * db).sum(dim=1)
        db_norms = torch.sqrt(db_sq_norms)
    query_norms = torch.sqrt((queries * queries).sum(dim=1, keepdim=True))
    denom = query_norms * db_norms[None, :]
    sim = dots / torch.where(denom == 0.0, torch.ones_like(denom), denom)
    return 1.0 - torch.clamp(sim, -1.0, 1.0)


def validate_cosine_operands(metric: DistanceMetric, query_norm: float,
                             num_zero_norm_rows: int) -> None:
    """Reference parity: any zero vector participating in a cosine search is
    an error (reference: src/distance.rs:51-55 propagated through
    src/flat_index.rs:52-65)."""
    if metric is not DistanceMetric.COSINE:
        return
    if query_norm == 0.0 or num_zero_norm_rows > 0:
        raise InvalidVectorError("Cannot compute cosine distance with zero vector")


__all__ = [
    "DistanceMetric",
    "euclidean_distance",
    "cosine_distance",
    "dot_product",
    "pairwise_distances",
    "prepare_device",
    "validate_cosine_operands",
]
