"""The program's span table (``vectordb_tpu_torch.utils.profiling.spans``),
read after the run by the metrics whose source is ``program_span``."""

from __future__ import annotations

from typing import Optional


def self_seconds(rec, names) -> Optional[float]:
    """The summed self seconds of the spans ``names`` over the whole run,
    or None where the program keeps no span table, none of them ran, or
    the traced window holds no device operation (a run on the CPU times
    PyTorch's CPU kernels, not the card's work)."""
    tr = rec.trace
    if tr is None or not tr.ops:
        return None
    from vectordb_tpu_torch.utils import profiling
    table = getattr(profiling, "spans", None)
    if table is None:
        return None
    got = table()
    found = [got[name]["self_s"] for name in names if name in got]
    return sum(found) if found else None
