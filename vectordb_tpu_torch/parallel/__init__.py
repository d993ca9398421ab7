"""Multi-device scaling: device meshes, sharded storage, distributed top-k.

Port of ``vectordb_tpu/parallel``: the packed database's row axis is
sharded over a ``Mesh`` of torch devices, each shard runs the
single-device pipeline (the coarse kernels, K2, K8) on its own device,
and a k-sized merge on the mesh's first device finishes. One process
drives every shard, as the JAX package's single controller does.
``dryrun_multichip`` (``parallel/dryrun.py``) drives one sharded serving
step.
"""

from .mesh import Mesh, make_mesh  # noqa: F401
from .distributed import (  # noqa: F401
    DistributedFlatIndex, make_sharded_pq_scan, make_sharded_search,
    make_sharded_search_coarse, shard_rows, sharded_coarse_supported)
from .hnsw_shards import ShardedHnswIndex  # noqa: F401
from .dryrun import dryrun_multichip  # noqa: F401
