"""Keep the JAX package's native library loaded in every xdist worker.

``vectordb_tpu/persistence/native_lib.get_native`` builds ``libvdbwal.so``
with ``make`` in place, in its source directory, and gives up for the life
of the process after one failure. On a fresh tree every xdist worker calls
it while collecting (``tests/test_native_http.py`` evaluates
``native_http_available()`` in its ``pytestmark``), so the workers race to
build the same file: a worker that finds another's ``g++`` still writing
it opens a partial library, fails, and skips or fails every native test it
runs afterwards (persistence, HNSW backends, the JAX native front end the
port's serving tests compare against).

This module is collected after ``test_native_http.py`` in every worker
(files are collected in name order) and before any of those tests runs. In
a worker whose loader gave up it takes an exclusive ``flock`` on the build
directory, reloads the loader module (which clears its failure flag) and
loads the finished library, waiting a bounded time for a ``g++`` that is
still writing it. The proper repair, building to a temporary name and
``os.replace``-ing it into place, belongs to the JAX package (the port's
own loader does so: ``vectordb_tpu_torch/persistence/native_lib.py``).
"""

import fcntl
import importlib
import os
import time
from pathlib import Path

from vectordb_tpu.persistence import native_lib

_WAIT_S = 180.0      # for a build still being written by another worker
_POLL_S = 0.5


def _reload_native_library():
    """In a worker whose loader gave up, reload it under the build
    directory's lock until the library loads or the wait runs out."""
    if (os.environ.get("VDB_TPU_NO_NATIVE")
            or native_lib.get_native() is not None):
        return
    fd = os.open(Path(native_lib.__file__).parent / "native", os.O_RDONLY)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        deadline = time.monotonic() + _WAIT_S
        while True:
            importlib.reload(native_lib)
            if native_lib.get_native() is not None \
                    or time.monotonic() > deadline:
                return
            time.sleep(_POLL_S)
    finally:
        fcntl.flock(fd, fcntl.LOCK_UN)
        os.close(fd)


_reload_native_library()


def test_the_jax_native_library_is_loaded_in_this_worker(monkeypatch):
    monkeypatch.delenv("VDB_TPU_NO_NATIVE", raising=False)
    assert native_lib.get_native() is not None
