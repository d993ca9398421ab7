"""N-dimensional float32 vector with the reference's value semantics.

Capability parity with reference src/vector.rs:8-122 (new/dimension/as_slice/
norm/normalize/normalized/from_str, checked +/- and scalar *), but backed by a
contiguous ``numpy.float32`` array so vectors move to the device without copies
or per-element Python work.
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np

from .errors import DimensionMismatchError, InvalidVectorError


class Vector:
    """A vector in n-dimensional space, stored as a contiguous float32 array."""

    __slots__ = ("_data",)

    def __init__(self, data: "Sequence[float] | np.ndarray | Iterable[float]"):
        # always copy: np.asarray would alias a caller-owned float32 array,
        # letting external mutation change our value/hash behind our back
        arr = np.array(data, dtype=np.float32, copy=True)
        if arr.ndim != 1:
            arr = arr.reshape(-1)
        self._data = np.ascontiguousarray(arr)

    # -- accessors ---------------------------------------------------------

    @property
    def dimension(self) -> int:
        return int(self._data.shape[0])

    def as_array(self) -> np.ndarray:
        """Read-only view of the underlying float32 data."""
        view = self._data.view()
        view.flags.writeable = False
        return view

    def as_list(self) -> list[float]:
        return [float(x) for x in self._data]

    def has_same_dimension(self, other: "Vector") -> bool:
        return self.dimension == other.dimension

    # -- math --------------------------------------------------------------

    def norm(self) -> float:
        """L2 norm, accumulated in float32 to match the reference numerics
        (reference: src/vector.rs:35-37)."""
        return float(np.sqrt(np.float32(np.dot(self._data, self._data))))

    def normalize(self) -> None:
        """Normalize in place; zero vectors are an error (reference: src/vector.rs:40-51)."""
        n = self.norm()
        if n == 0.0:
            raise InvalidVectorError("Cannot normalize zero vector")
        self._data = (self._data / np.float32(n)).astype(np.float32)

    def normalized(self) -> "Vector":
        v = Vector(self._data.copy())
        v.normalize()
        return v

    # -- parsing -----------------------------------------------------------

    @classmethod
    def from_str(cls, s: str) -> "Vector":
        """Parse a comma-separated string like "1.0,2.0,3.0"
        (reference: src/vector.rs:61-73)."""
        parts = s.split(",")
        values = []
        for part in parts:
            token = part.strip()
            try:
                values.append(float(token))
            except ValueError:
                raise InvalidVectorError(f"Invalid float: {part}") from None
        return cls(np.array(values, dtype=np.float32))

    # -- operators (dimension-checked, like reference src/vector.rs:76-122) --

    def __add__(self, other: "Vector") -> "Vector":
        if not isinstance(other, Vector):
            return NotImplemented
        if not self.has_same_dimension(other):
            raise DimensionMismatchError(self.dimension, other.dimension)
        return Vector(self._data + other._data)

    def __sub__(self, other: "Vector") -> "Vector":
        if not isinstance(other, Vector):
            return NotImplemented
        if not self.has_same_dimension(other):
            raise DimensionMismatchError(self.dimension, other.dimension)
        return Vector(self._data - other._data)

    def __mul__(self, scalar: float) -> "Vector":
        return Vector(self._data * np.float32(scalar))

    __rmul__ = __mul__

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, Vector):
            return NotImplemented
        return self._data.shape == other._data.shape and bool(
            np.array_equal(self._data, other._data)
        )

    def __hash__(self):
        return hash(self._data.tobytes())

    def __len__(self) -> int:
        return self.dimension

    def __repr__(self) -> str:
        return f"Vector({self.as_list()!r})"


def as_f32_array(v: "Vector | Sequence[float] | np.ndarray") -> np.ndarray:
    """Coerce Vector / sequence / array into a 1-D float32 numpy array."""
    if isinstance(v, Vector):
        return v.as_array()
    arr = np.asarray(v, dtype=np.float32)
    return arr.reshape(-1)
