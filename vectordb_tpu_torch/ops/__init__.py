"""Device-side tensor ops: the certified coarse scan (ops/coarse_kernel.py,
with the hand-written CUDA kernels in ops/cuda_kernels.py), the plain f32
scan and tier ladder (ops/topk.py), and scatter updates (ops/update.py).
"""

from .topk import flat_search, flat_search_batched, next_pow2  # noqa: F401
from .update import scatter_rows, scatter_values  # noqa: F401
