"""Cross-cutting utilities (locks, timing)."""

from .locks import RwLock  # noqa: F401
