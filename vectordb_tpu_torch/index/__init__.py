"""Index layer: pluggable backends over integer internal IDs.

Parity with the reference index layer (src/index.rs, src/flat_index.rs):
an abstract ``Index`` contract plus ``FlatIndex`` (exact, certified
device flat scan) and ``PqFlatIndex`` (PQ codes on the device, exact
re-rank). HNSW, IVF-Flat and IVF-PQ join in later slices (ROADMAP
queue 1).
"""

from .base import Index  # noqa: F401
from .flat import FlatIndex  # noqa: F401
from .pq import PqFlatIndex  # noqa: F401
