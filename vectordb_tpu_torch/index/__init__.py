"""Index layer: pluggable backends over integer internal IDs.

Parity with the reference index layer (src/index.rs, src/flat_index.rs,
src/hnsw/): an abstract ``Index`` contract plus ``FlatIndex`` (exact,
certified device flat scan), ``HnswIndex`` (approximate, graph traversal
on the host, device bulk build and batched device traversal),
``IvfFlatIndex`` (inverted file: probed clusters, exact refine),
``PqFlatIndex`` (PQ codes on the device, exact re-rank) and
``IvfPqIndex`` (residual PQ codes over the IVF layout, exact re-rank).
"""

from .base import Index  # noqa: F401
from .flat import FlatIndex  # noqa: F401
from .hnsw import HnswIndex, HnswParams  # noqa: F401
from .ivf import IvfFlatIndex  # noqa: F401
from .ivfpq import IvfPqIndex  # noqa: F401
from .pq import PqFlatIndex  # noqa: F401
