"""The port package stands alone: it imports torch and never JAX.

``tests/conftest.py`` imports jax into this process, so the import check
runs in a subprocess. The static check reads every module's imports.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "vectordb_tpu_torch"
MODULES = sorted(p.relative_to(ROOT).as_posix() for p in PKG.rglob("*.py")
                 if "_build" not in p.parts) + [
                     "chip_smoke.py", "tools/coarse_bodies.py",
                     "tools/profile_torch_slice.py"]

_PROBE = """
import sys
import vectordb_tpu_torch
import vectordb_tpu_torch.cli, vectordb_tpu_torch.convert
import vectordb_tpu_torch.server, vectordb_tpu_torch.ops.cuda_kernels
import vectordb_tpu_torch.index.pq, vectordb_tpu_torch.ops.pq
import vectordb_tpu_torch.ops.flat_kernel
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'triton', 'vectordb_tpu'))
print(repr(bad))
"""


def test_import_leaves_jax_and_triton_out():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_import_builds_nothing():
    """Importing builds no kernel: the build directory is made at first
    launch, not at import."""
    from vectordb_tpu_torch.ops import cuda_kernels
    assert cuda_kernels._lib.cache_info().currsize == 0


@pytest.mark.parametrize("module", MODULES)
def test_module_imports_no_jax(module):
    tree = ast.parse((ROOT / module).read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    roots = {n.split(".")[0] for n in names}
    assert not roots & {"jax", "jaxlib", "vectordb_tpu", "triton"}, roots


def test_wrappers_refuse_cpu_tensors():
    """A wrapper never falls back: a CPU tensor is an error, and the plain
    version is reached only through the launchers' device dispatch."""
    from vectordb_tpu_torch.ops import cuda_kernels
    q = torch.zeros((32, 8), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_kernels.coarse_minima_1p_sup(
            q, torch.zeros((1, 8)), torch.zeros((256, 32),
                                                dtype=torch.bfloat16),
            torch.zeros((1, 256)), torch.zeros((1, 256)), "euclidean")
    with pytest.raises(ValueError, match="CUDA"):
        cuda_kernels.refine_dots(torch.zeros((8, 2), dtype=torch.int64),
                                 torch.zeros((8, 32)), torch.zeros((64, 32)),
                                 2)
    assert sum(cuda_kernels.launches.values()) == 0
    assert all(n == 0 for body in cuda_kernels.routes.values()
               for n in body.values())


def test_cuda_device_without_card_raises():
    from vectordb_tpu_torch import DistanceMetric, VectorStore
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        VectorStore.with_flat_index(DistanceMetric.EUCLIDEAN)
