"""Durability layer: WAL, snapshots, storage engine, mmap vector files.

Port of ``vectordb_tpu/persistence`` (reference src/persistence/mod.rs:3-7).
The byte-level and syscall-sensitive paths (CRC32, WAL framing, fsync,
mmap, atomic snapshot writes) run in the JAX package's native C++ core,
which ``native_lib`` builds into this package's ``_build/``; each has a
pure-Python backend with identical bytes, run when asked for
(``VDB_TPU_NO_NATIVE=1``). Directories are interchangeable with the JAX
package's.
"""

from .engine import EngineConfig, StorageEngine  # noqa: F401
from .mmap_storage import MmapVectorStorage  # noqa: F401
from .serialization import (DatabaseSnapshot, SerializedVector,  # noqa: F401
                            WalEntry)
from .snapshot import SnapshotManager  # noqa: F401
from .wal import WriteAheadLog  # noqa: F401
