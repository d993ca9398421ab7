"""What the benchmark runs imports neither JAX nor the JAX package, and
its reference imports nothing of the program; both checked in a fresh
interpreter, by top-level module names compared whole."""

import json
import os
import subprocess
import sys
import shutil
import tempfile


from vdbbench.manifest import PKG, ROOT, load_manifest

FORBIDDEN = {"jax", "jaxlib", "flax", "vectordb_tpu"}
WORKLOAD = load_manifest()["workloads"][0]["name"]


def _modules_after(code: str) -> set:
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def _benchmark_modules() -> list:
    """Every module of the benchmark but its tests, by import name; a
    file whose name is no identifier (a metric's) by its path."""
    names, paths = [], []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        if "tests" in rel.parts:
            continue
        if all(p.isidentifier() for p in rel.parts):
            names.append(".".join(rel.parts))
        else:
            paths.append((rel.parts[-2], rel.parts[-1]))
    return names, paths


def test_benchmark_imports_no_jax():
    names, paths = _benchmark_modules()
    code = "\n".join(
        ["import importlib", "import vectordb_tpu_torch",
         "from vdbbench.manifest import load_module"]
        + [f"importlib.import_module({m!r})" for m in names]
        + [f"load_module({k!r}, {n!r})" for k, n in paths])
    loaded = _modules_after(code)
    assert "vectordb_tpu_torch" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    loaded = _modules_after(
        "import vdbbench.references.exact_topk, vdbbench.compare, "
        "vdbbench.trace")
    assert "vectordb_tpu_torch" not in loaded
    assert not loaded & FORBIDDEN


def test_no_card_no_result():
    # this machine has no card: the measuring path exits with no result
    out = subprocess.run(
        [sys.executable, "-m", "vdbbench", "--workload", WORKLOAD,
         "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_bare_checkout_no_result():
    # a directory that holds only the manifest and the benchmark's files
    with tempfile.TemporaryDirectory() as tmp:
        shutil.copy(ROOT / "BENCHMARK.json", tmp)
        shutil.copytree(PKG, os.path.join(tmp, "vdbbench"),
                        ignore=shutil.ignore_patterns("__pycache__"))
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        out = subprocess.run(
            [sys.executable, "-m", "vdbbench", "--workload", WORKLOAD,
             "--seed", "1", "--seconds", "1",
             "--trace", "0"], cwd=tmp, env=env, capture_output=True,
            text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
