"""Index layer: pluggable backends over integer internal IDs.

Parity with the reference index layer (src/index.rs, src/flat_index.rs,
src/hnsw/): an abstract ``Index`` contract plus ``FlatIndex`` (exact,
certified device flat scan), ``HnswIndex`` (approximate, graph traversal
on the host) and ``PqFlatIndex`` (PQ codes on the device, exact re-rank).
IVF-Flat and IVF-PQ join in later slices (ROADMAP queue 1).
"""

from .base import Index  # noqa: F401
from .flat import FlatIndex  # noqa: F401
from .hnsw import HnswIndex, HnswParams  # noqa: F401
from .pq import PqFlatIndex  # noqa: F401
