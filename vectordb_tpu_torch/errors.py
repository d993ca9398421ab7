"""Error types for the vector database (unchanged from ``vectordb_tpu``).

Mirrors the error surface of the reference implementation
(reference: src/error.rs:6-31 — DimensionMismatch, VectorNotFound,
InvalidVector, IoError, SerializationError, StorageError, IndexError),
expressed as a Python exception hierarchy rooted at ``VectorDbError``.
"""

from __future__ import annotations


class VectorDbError(Exception):
    """Base class for all vector-database errors."""


class DimensionMismatchError(VectorDbError):
    """Raised when vector dimensions disagree (reference: src/error.rs:11-12)."""

    def __init__(self, expected: int, actual: int):
        self.expected = expected
        self.actual = actual
        super().__init__(f"Dimension mismatch: expected {expected}, got {actual}")


class VectorNotFoundError(VectorDbError):
    """Raised when an ID is absent from the store (reference: src/error.rs:14-15)."""

    def __init__(self, id: str):
        self.id = id
        super().__init__(f"Vector not found: {id}")


class InvalidVectorError(VectorDbError):
    """Raised for malformed vector data (reference: src/error.rs:17-18)."""

    def __init__(self, reason: str):
        self.reason = reason
        super().__init__(f"Invalid vector: {reason}")


class VdbIoError(VectorDbError):
    """Wraps OS-level I/O failures (reference: src/error.rs:20-21)."""

    def __init__(self, cause: BaseException | str):
        self.cause = cause
        super().__init__(f"IO error: {cause}")


class SerializationError(VectorDbError):
    """Raised when encoding/decoding persisted bytes fails (reference: src/error.rs:23-24)."""

    def __init__(self, reason: str):
        self.reason = reason
        super().__init__(f"Serialization error: {reason}")


class StorageError(VectorDbError):
    """Raised for storage-engine level failures (reference: src/error.rs:26-27)."""

    def __init__(self, reason: str):
        self.reason = reason
        super().__init__(f"Storage error: {reason}")


class IndexOpError(VectorDbError):
    """Raised for index-level failures (reference: src/error.rs:29-30)."""

    def __init__(self, reason: str):
        self.reason = reason
        super().__init__(f"Index error: {reason}")


class StaleSlotMaskError(VectorDbError):
    """Internal: a precompiled slot mask no longer matches the index's slot
    layout (a concurrent retrain repacked the slots between mask
    compilation and the masked scan). The store catches this and
    recompiles the mask against the new layout."""

    def __init__(self, expected_version: int, actual_version: int):
        self.expected_version = expected_version
        self.actual_version = actual_version
        super().__init__(
            f"slot mask compiled for layout v{expected_version}, index is "
            f"at v{actual_version}")
