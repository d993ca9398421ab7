"""Metadata store and filter algebra.

Capability parity with reference src/storage.rs:19-71:
  * ``Metadata`` — string->string field map
  * ``MetadataFilter`` — Eq / Ne / Exists / And / Or AST with the exact
    reference matching semantics (note: Ne matches rows where the field is
    *missing*, because ``None != Some(v)``; src/storage.rs:65)
  * the same tagged-JSON wire shape: {"op": "eq", "field": ..., "value": ...},
    {"op": "and", "filters": [...]}, etc. (serde tag="op" snake_case,
    src/storage.rs:46)

Device-side addition — ``ColumnarMetadata``: a columnar value-code store that
compiles a filter AST into a boolean mask over storage slots with vectorized
numpy comparisons. The mask is shipped to the device and applied *before*
top-k, giving exact filtered search instead of the reference's 3x over-fetch
post-filter (src/storage.rs:268-287).
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional

import numpy as np


class Metadata:
    """String->string metadata fields (reference: src/storage.rs:19-42)."""

    __slots__ = ("_fields",)

    def __init__(self, fields: Optional[Dict[str, str]] = None):
        self._fields: Dict[str, str] = dict(fields) if fields else {}

    def insert(self, key: str, value: str) -> None:
        self._fields[str(key)] = str(value)

    def get(self, key: str) -> Optional[str]:
        return self._fields.get(key)

    def fields(self) -> Dict[str, str]:
        return dict(self._fields)

    def is_empty(self) -> bool:
        return not self._fields

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, Metadata):
            return NotImplemented
        return self._fields == other._fields

    def __len__(self) -> int:
        return len(self._fields)

    def __iter__(self) -> Iterator[str]:
        return iter(self._fields)

    def __repr__(self) -> str:
        return f"Metadata({self._fields!r})"


class MetadataFilter:
    """Composable metadata filter AST (reference: src/storage.rs:45-71).

    Construct via the classmethods (``eq``, ``ne``, ``exists``, ``and_``,
    ``or_``) or parse the tagged-JSON form with ``from_dict``.
    """

    __slots__ = ("op", "field", "value", "filters")

    _LEAF_OPS = ("eq", "ne", "exists")
    _NODE_OPS = ("and", "or")

    def __init__(self, op: str, field: Optional[str] = None,
                 value: Optional[str] = None,
                 filters: Optional[List["MetadataFilter"]] = None):
        self.op = op
        self.field = field
        self.value = value
        self.filters = filters or []

    # -- constructors ------------------------------------------------------

    @classmethod
    def eq(cls, field: str, value: str) -> "MetadataFilter":
        return cls("eq", field=field, value=value)

    @classmethod
    def ne(cls, field: str, value: str) -> "MetadataFilter":
        return cls("ne", field=field, value=value)

    @classmethod
    def exists(cls, field: str) -> "MetadataFilter":
        return cls("exists", field=field)

    @classmethod
    def and_(cls, filters: List["MetadataFilter"]) -> "MetadataFilter":
        return cls("and", filters=list(filters))

    @classmethod
    def or_(cls, filters: List["MetadataFilter"]) -> "MetadataFilter":
        return cls("or", filters=list(filters))

    # -- wire format (tagged JSON, same shape as the reference) ------------

    @classmethod
    def from_dict(cls, d: dict) -> "MetadataFilter":
        if not isinstance(d, dict) or "op" not in d:
            raise ValueError("filter must be an object with an 'op' tag")
        op = d["op"]
        if op in cls._LEAF_OPS:
            field = d.get("field")
            if not isinstance(field, str):
                raise ValueError(f"filter op '{op}' requires a string 'field'")
            if op == "exists":
                return cls(op, field=field)
            value = d.get("value")
            if not isinstance(value, str):
                raise ValueError(f"filter op '{op}' requires a string 'value'")
            return cls(op, field=field, value=value)
        if op in cls._NODE_OPS:
            subs = d.get("filters")
            if not isinstance(subs, list):
                raise ValueError(f"filter op '{op}' requires a 'filters' list")
            return cls(op, filters=[cls.from_dict(s) for s in subs])
        raise ValueError(f"Unknown filter op: {op}")

    def to_dict(self) -> dict:
        if self.op == "exists":
            return {"op": self.op, "field": self.field}
        if self.op in self._LEAF_OPS:
            return {"op": self.op, "field": self.field, "value": self.value}
        return {"op": self.op, "filters": [f.to_dict() for f in self.filters]}

    # -- evaluation --------------------------------------------------------

    def matches(self, metadata: Metadata) -> bool:
        """Row-at-a-time evaluation (reference: src/storage.rs:62-70)."""
        if self.op == "eq":
            return metadata.get(self.field) == self.value
        if self.op == "ne":
            # None != value is True: missing fields match Ne, like the reference
            return metadata.get(self.field) != self.value
        if self.op == "exists":
            return metadata.get(self.field) is not None
        if self.op == "and":
            return all(f.matches(metadata) for f in self.filters)
        if self.op == "or":
            return any(f.matches(metadata) for f in self.filters)
        raise ValueError(f"Unknown filter op: {self.op}")

    def __repr__(self) -> str:
        return f"MetadataFilter({self.to_dict()!r})"


_MISSING = np.int32(-1)   # slot has no value for this field
_UNSEEN = np.int32(-2)    # filter value never inserted anywhere


class ColumnarMetadata:
    """Columnar value-code mirror of per-slot metadata.

    For each field we keep an ``int32[capacity]`` code array (-1 = missing)
    plus a value->code dict. A filter AST then compiles to vectorized numpy
    comparisons producing a ``bool[capacity]`` mask in O(fields_touched * n)
    SIMD work — no per-row Python. The mask feeds the device-side masked
    top-k for exact filtered search.
    """

    def __init__(self, capacity: int):
        self._capacity = capacity
        self._codes: Dict[str, np.ndarray] = {}
        self._value_codes: Dict[str, Dict[str, int]] = {}

    @property
    def capacity(self) -> int:
        return self._capacity

    def grow(self, new_capacity: int) -> None:
        if new_capacity <= self._capacity:
            return
        for field, arr in self._codes.items():
            grown = np.full(new_capacity, _MISSING, dtype=np.int32)
            grown[: self._capacity] = arr
            self._codes[field] = grown
        self._capacity = new_capacity

    def set_slot(self, slot: int, metadata: Metadata) -> None:
        """Record the metadata of a (re)used slot, clearing old values."""
        self.clear_slot(slot)
        for key, value in metadata.fields().items():
            codes = self._codes.get(key)
            if codes is None:
                codes = np.full(self._capacity, _MISSING, dtype=np.int32)
                self._codes[key] = codes
                self._value_codes[key] = {}
            vmap = self._value_codes[key]
            code = vmap.get(value)
            if code is None:
                code = len(vmap)
                vmap[value] = code
            codes[slot] = code

    def clear_slot(self, slot: int) -> None:
        for codes in self._codes.values():
            codes[slot] = _MISSING

    def _field_codes(self, field: str) -> Optional[np.ndarray]:
        return self._codes.get(field)

    def _code_of(self, field: str, value: str) -> np.int32:
        vmap = self._value_codes.get(field)
        if vmap is None:
            return _UNSEEN
        return np.int32(vmap.get(value, int(_UNSEEN)))

    def compile_mask(self, flt: MetadataFilter) -> np.ndarray:
        """bool[capacity] mask of slots whose metadata satisfies ``flt``."""
        op = flt.op
        if op == "eq":
            codes = self._field_codes(flt.field)
            if codes is None:
                return np.zeros(self._capacity, dtype=bool)
            return codes == self._code_of(flt.field, flt.value)
        if op == "ne":
            codes = self._field_codes(flt.field)
            if codes is None:
                return np.ones(self._capacity, dtype=bool)
            return codes != self._code_of(flt.field, flt.value)
        if op == "exists":
            codes = self._field_codes(flt.field)
            if codes is None:
                return np.zeros(self._capacity, dtype=bool)
            return codes != _MISSING
        if op == "and":
            mask = np.ones(self._capacity, dtype=bool)
            for sub in flt.filters:
                mask &= self.compile_mask(sub)
            return mask
        if op == "or":
            mask = np.zeros(self._capacity, dtype=bool)
            for sub in flt.filters:
                mask |= self.compile_mask(sub)
            return mask
        raise ValueError(f"Unknown filter op: {op}")


__all__ = ["Metadata", "MetadataFilter", "ColumnarMetadata"]
