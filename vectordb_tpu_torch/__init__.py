"""vectordb_tpu_torch — the PyTorch + CUDA port of ``vectordb_tpu``.

The JAX package stays the reference; this package runs the same system on
an NVIDIA Hopper GPU with PyTorch for tensor code and hand-written CUDA
kernels (``csrc/``) for what the JAX package wrote in Pallas. It imports
``torch`` and never ``jax``; the kernels are built with ``nvcc`` at first
use, never at import.

Ported so far: the exact flat-search slice — ``VectorStore`` over a
``FlatIndex`` (f32, bf16 or int8 storage) with the certified coarse
ladder (kernels K1-K7), metadata filters, radius search, the stdlib HTTP
server and the CLI; ``PqFlatIndex`` (PQ codes, decode kernel K8, exact
re-rank); the first-generation two-phase scan
(``ops.flat_kernel``, kernel K9); the durability layer
(``persistence``: WAL, snapshots and recovery in the JAX package's file
formats, the CLI's ``--data-dir`` and ``serve --durable-dir``); serving
through the native C++ front end or the query batcher; ``HnswIndex``
(the graph on the host, its checkpoint in ``hnsw_graph.npz``; the bulk
build of a large fresh batch on the flat index's kernels and the batched
traversal, kernel H1, on the card); ``IvfFlatIndex`` (k-means
clusters, probed search refined exactly by kernel K2, its trained layout
in ``ivf_state.npz``); and ``IvfPqIndex`` (residual PQ codes over the IVF
layout, decoded by K8, exact re-rank, its trained state in
``ivfpq_state.npz``).
"""

from .distance import (DistanceMetric, cosine_distance, dot_product,  # noqa: F401
                       euclidean_distance)
from .errors import (DimensionMismatchError, IndexOpError,  # noqa: F401
                     InvalidVectorError, SerializationError, StorageError,
                     VdbIoError, VectorDbError, VectorNotFoundError)
from .index import (FlatIndex, HnswIndex, HnswParams, Index,  # noqa: F401
                    IvfFlatIndex, IvfPqIndex, PqFlatIndex)
from .metadata import Metadata, MetadataFilter  # noqa: F401
from .metrics import MetricsCollector  # noqa: F401
from .store import BatchInsertItem, SearchResult, VectorStore  # noqa: F401
from .vector import Vector  # noqa: F401

__version__ = "0.1.0"
