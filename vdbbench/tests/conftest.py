"""Tiny cells for the CPU tests: the shipped configurations and traffic
with their scale cut, so that a run takes a few seconds."""

import json

import pytest

from vdbbench.manifest import PKG, Cell, load_manifest


def tiny_cell(config: str, traffic: str, rows: int = 4096, dim: int = 64,
              k: int = None) -> Cell:
    """The cell ``<config>.<traffic>`` with its limits, at ``rows`` x
    ``dim``, 16 queries a call, and ``k`` where given."""
    conf = json.loads((PKG / "configs" / f"{config}.json").read_text())
    conf.update(rows=rows, dim=dim)
    traf = json.loads((PKG / "traffic" / f"{traffic}.json").read_text())
    traf.update(queries_per_call=16, pool_calls=4, warmup_calls=2,
                kept_calls=2)
    if k is not None:
        traf["k"] = k
    workload = f"{config}.{traffic}"
    limits = json.loads(
        (PKG / "cells" / f"{workload}.json").read_text())["limits"]
    return Cell.of(workload, conf, traf, limits, load_manifest())


@pytest.fixture
def tiny():
    return tiny_cell
