"""A readers-writer lock.

The reference guards its store with ``std::sync::RwLock`` (src/server/mod.rs:
13-16): many concurrent readers, exclusive writers. Python's stdlib has no RW
lock, so this is a small writer-preferring implementation on a Condition.
"""

from __future__ import annotations

import contextlib
import threading


class RwLock:
    def __init__(self):
        self._cond = threading.Condition()
        self._readers = 0
        self._writer = False
        self._writers_waiting = 0

    @contextlib.contextmanager
    def read(self):
        with self._cond:
            while self._writer or self._writers_waiting:
                self._cond.wait()
            self._readers += 1
        try:
            yield
        finally:
            with self._cond:
                self._readers -= 1
                if self._readers == 0:
                    self._cond.notify_all()

    @contextlib.contextmanager
    def write(self):
        with self._cond:
            self._writers_waiting += 1
            while self._writer or self._readers:
                self._cond.wait()
            self._writers_waiting -= 1
            self._writer = True
        try:
            yield
        finally:
            with self._cond:
                self._writer = False
                self._cond.notify_all()


__all__ = ["RwLock"]
