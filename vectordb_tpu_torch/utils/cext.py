"""Build the package's host C/C++ code, and load its C extension modules.

``build`` compiles sources into ``vectordb_tpu_torch/_build/``, keyed by a
hash of the sources' bytes (and of any ``key``, such as an ABI tag), and
returns the cached shared object: the persistence core
(``persistence/native_lib.py``) and the extension modules below use it.
The build writes a temporary file and renames it into place, so processes
that build at once leave one whole file. Missing sources or a failed
build raise RuntimeError, the latter with the compiler's log; there is no
fallback.

``load("<name>")`` is the extension module ``_<name>`` built from
``csrc/<name>.c`` with the C compiler (``gcc``, or ``CC``) against the
running interpreter's headers, with no PyTorch headers.
"""

from __future__ import annotations

import hashlib
import importlib.machinery
import importlib.util
import os
import shlex
import subprocess
import sysconfig
from pathlib import Path
from types import ModuleType
from typing import Sequence

_PKG = Path(__file__).resolve().parent.parent
BUILD_DIR = _PKG / "_build"
CFLAGS = ("-O2", "-shared", "-fPIC")


def build(what: str, sources: Sequence[Path], compiler: str,
          flags: Sequence[str], stem: str, build_dir: Path,
          key: bytes = b"") -> Path:
    """``build_dir/<stem>_<hash>.so`` compiled from ``sources``, once per
    hash of their bytes and ``key``; ``what`` names the build in errors."""
    try:
        blobs = [p.read_bytes() for p in sources]
    except OSError as e:
        raise RuntimeError(f"{what} sources not found: {e}") from None
    digest = hashlib.sha256(b"".join(blobs) + key).hexdigest()[:16]
    so = build_dir / f"{stem}_{digest}.so"
    if so.exists():
        return so
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = build_dir / f".{so.name}.{os.getpid()}.tmp"
    cmd = [*shlex.split(compiler), *flags, "-o", str(tmp),
           *map(str, sources)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{what} build failed: {e}") from None
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{what} build failed ({cmd[0]} exit "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)
    return so


def _build(name: str) -> Path:
    paths = sysconfig.get_paths()
    includes = dict.fromkeys((paths["include"], paths["platinclude"]))
    abi = sysconfig.get_config_var("SOABI") or ""
    return build(f"{name}.c", [_PKG / "csrc" / f"{name}.c"],
                 os.environ.get("CC", "gcc"),
                 [*CFLAGS, *(f"-I{d}" for d in includes)], f"_{name}",
                 BUILD_DIR, abi.encode())


def load(name: str) -> ModuleType:
    """The extension module ``_<name>`` built from ``csrc/<name>.c``,
    building it if this source and interpreter have no build yet."""
    path = str(_build(name))
    full = f"{_PKG.name}._{name}"
    loader = importlib.machinery.ExtensionFileLoader(full, path)
    spec = importlib.util.spec_from_file_location(full, path, loader=loader)
    module = importlib.util.module_from_spec(spec)
    loader.exec_module(module)
    return module


__all__ = ["build", "load", "BUILD_DIR"]
