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
                     "tools/profile_torch_slice.py", "tools/serving_sweep.py"]

_PROBE = """
import sys
import vectordb_tpu_torch
import vectordb_tpu_torch.cli, vectordb_tpu_torch.convert
import vectordb_tpu_torch.server, vectordb_tpu_torch.ops.cuda_kernels
import vectordb_tpu_torch.index.pq, vectordb_tpu_torch.ops.pq
import vectordb_tpu_torch.ops.flat_kernel
import vectordb_tpu_torch.persistence
import vectordb_tpu_torch.server.native_http, vectordb_tpu_torch.server.batcher
import vectordb_tpu_torch.index.hnsw, vectordb_tpu_torch.index.hnsw_native
from vectordb_tpu_torch.server.app import start_durable, start_hnsw
import tempfile
from vectordb_tpu_torch import Vector
from vectordb_tpu_torch.persistence import EngineConfig, StorageEngine
with tempfile.TemporaryDirectory() as d:
    with StorageEngine.open(d, EngineConfig(device="cpu")) as eng:
        eng.insert("a", Vector([1.0, 2.0]))
        eng.checkpoint()
    with StorageEngine.open(d, EngineConfig(device="cpu")) as eng:
        assert eng.search(Vector([1.0, 2.0]), 1)[0].id == "a"
    hnsw = EngineConfig(index_type="hnsw", device="cpu")
    with StorageEngine.open(d + "/h", hnsw) as eng:
        eng.insert("a", Vector([1.0, 2.0]))
        eng.checkpoint()
    with StorageEngine.open(d + "/h", hnsw) as eng:
        assert eng.search(Vector([1.0, 2.0]), 1)[0].id == "a"
from vectordb_tpu_torch.server.app import AppState, serve
from vectordb_tpu_torch import VectorStore, DistanceMetric
import threading
state = AppState(VectorStore.with_flat_index(DistanceMetric.EUCLIDEAN,
                                             device="cpu"))
ready = threading.Event()
t = threading.Thread(target=serve, args=("127.0.0.1:0", state),
                     kwargs={"ready_event": ready, "batch_window_ms": 1.0},
                     daemon=True)
t.start()
assert ready.wait(60)
assert type(state.server).__name__ == "NativeHttpServer"
state.server.shutdown()
t.join(30)
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
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout


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


def _tree(path):
    return sorted((p.relative_to(path).as_posix(), p.stat().st_size,
                   p.stat().st_mtime_ns) for p in path.rglob("*"))


def test_native_build_writes_only_the_ports_build_dir(tmp_path,
                                                      monkeypatch):
    """The persistence core builds from the JAX package's sources by path
    into the port's build directory, and writes nothing beside its
    sources (the JAX loader's make target writes there). The build runs
    on a copy of the sources, so JAX builds in other test processes
    cannot race the check."""
    import shutil
    from vectordb_tpu_torch.persistence import native_lib
    assert native_lib.BUILD_DIR == PKG / "_build"
    assert native_lib.NATIVE_SRC == ROOT / "vectordb_tpu" / "persistence" \
        / "native"
    src = tmp_path / "src"
    src.mkdir()
    for name in native_lib.SOURCES:
        shutil.copy(native_lib.NATIVE_SRC / name, src / name)
    before = _tree(src)
    monkeypatch.setattr(native_lib, "NATIVE_SRC", src)
    monkeypatch.setattr(native_lib, "BUILD_DIR", tmp_path / "_build")
    so = native_lib._build()
    assert so.parent == tmp_path / "_build" and so.exists()
    assert [p.name for p in (tmp_path / "_build").iterdir()] == [so.name]
    assert _tree(src) == before


def test_native_build_failure_raises_with_the_log(tmp_path, monkeypatch):
    """A failed compile raises with the compiler's log; the Python
    backend is never taken in its place."""
    from vectordb_tpu_torch.persistence import native_lib
    for name in native_lib.SOURCES:
        (tmp_path / name).write_text("int broken( {\n")
    monkeypatch.setattr(native_lib, "NATIVE_SRC", tmp_path)
    monkeypatch.setattr(native_lib, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native_lib, "_lib", None)
    monkeypatch.delenv("VDB_TPU_NO_NATIVE", raising=False)
    with pytest.raises(RuntimeError, match="build failed") as err:
        native_lib.get_native()
    assert "walcore.cpp" in str(err.value)
    assert not list((tmp_path / "_build").iterdir())
    monkeypatch.setenv("VDB_TPU_NO_NATIVE", "1")
    assert native_lib.get_native() is None


def test_native_build_is_safe_from_six_processes_at_once(tmp_path):
    """Six processes (the Tier-1 run's xdist workers) building the native
    core into one empty build directory at once: each compiles into a
    file of its own and renames it into place, so all six load a
    complete library and one library is left."""
    code = (
        "import sys\n"
        "from pathlib import Path\n"
        "from vectordb_tpu_torch.persistence import native_lib\n"
        "native_lib.BUILD_DIR = Path(sys.argv[1])\n"
        "lib = native_lib.get_native()\n"
        "assert lib.vdb_crc32(native_lib.as_u8p(b'abc'), 3) == 0x352441C2\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    env.pop("VDB_TPU_NO_NATIVE", None)
    procs = [subprocess.Popen([sys.executable, "-c", code,
                               str(tmp_path / "_build")], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(6)]
    outs = [p.communicate(timeout=600) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1][-500:] for o in outs]
    assert all(o[0].strip() == "ok" for o in outs)
    assert [p.name for p in (tmp_path / "_build").iterdir()
            if p.suffix == ".so"] == [native_lib_name()]
    assert not [p for p in (tmp_path / "_build").iterdir()
                if p.name.endswith(".tmp")]


def native_lib_name():
    from vectordb_tpu_torch.persistence import native_lib
    return native_lib._build().name
