"""``BENCHMARK.json`` against the contract's shape and characters, and
every piece that it names found by its name. The checks are of the
entries' shape, not of the values the manifest holds today, so that a
cell, a configuration or a metric arrives as files and entries only."""

import json
import re

import pytest

from vdbbench.manifest import (MANIFEST, NAME, PKG, ROOT, UNIT, Cell,
                               load_json, load_manifest, load_module)

M = load_manifest()
LINE = re.compile(r"^[^\t\n\r]{1,200}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
LIMITED = {"violations", "dist_gap", "recall"}


def _whole(x) -> bool:
    return isinstance(x, int) and not isinstance(x, bool)


def test_top_level_keys():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert MANIFEST.stat().st_size <= 64 * 1024
    rs = M["run_seconds"]
    assert _whole(rs) and rs >= 1
    # a full check of 24 cells fits its 43200 s: 2 + 14 x 24 runs of
    # run_seconds + 60 s, 2 x 90 s a cell to compile, 1200 s spare
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200


def test_command_and_paths():
    assert 1 <= len(M["command"]) <= 32
    for word in M["command"]:
        assert LINE.match(word) and not word.startswith("/")
        assert ".." not in word
    assert 1 <= len(M["paths"]) <= 16
    for p in M["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()


def _names(section):
    return [e["name"] for e in M[section]]


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_are_unique_and_well_formed(section):
    names = _names(section)
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name
    if section in ("end_to_end", "per_layer"):
        other = _names("per_layer" if section == "end_to_end"
                       else "end_to_end")
        assert not set(names) & set(other)
        for m in M[section]:
            assert UNIT.match(m["unit"]), m["unit"]
            assert m["better"] in ("lower", "higher")


def test_config_entries():
    assert 1 <= len(M["configs"]) <= 24
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert LINE.match(c["source"]) and LINE.match(c["why"])
        assert c["file"].startswith(tuple(p + "/" for p in M["paths"]))
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"] and conf["source"] == c["source"]
        assert isinstance(c["reduced"], list) and len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and key in conf, key
        load_module("data", conf["data"]["generator"])
        load_module("references", conf["reference"])
        assert (PKG / "stores" / f"{conf['store']['kind']}.py").is_file()
    files = [c["file"] for c in M["configs"]]
    assert len(files) == len(set(files))


def test_workloads_found_by_name():
    configs = set(_names("configs"))
    assert 1 <= len(M["workloads"]) <= 24
    pairs = set()
    used = set()
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"]) and LINE.match(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        used.add(w["config"])
        cell = Cell(w["name"], M)
        load_module("drivers", cell.traffic["driver"])
        assert cell.traffic["kept_calls"] <= cell.traffic["pool_calls"]
        assert cell.limits and set(cell.limits) <= LIMITED
        for lim in cell.limits.values():
            assert len(lim) == 1 and set(lim) <= {"max", "min"}
        assert load_json("cells", w["name"])["limits"] == cell.limits
    assert used == configs
    four = sum(w["chips"] == 4 for w in M["workloads"])
    assert four <= max(1, len(M["workloads"]) // 4)


def test_metrics_found_by_name_and_reported():
    cells = set(_names("workloads"))
    assert "setup_s" in _names("end_to_end")
    assert 1 <= len(M["end_to_end"]) <= 16
    assert 1 <= len(M["per_layer"]) <= 128
    for m in M["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
        assert callable(load_module("metrics", m["name"]).read)
    e2e = {m["name"] for m in M["end_to_end"]}
    layers = {}
    for m in M["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e and LINE.match(m["layer"])
        assert set(m["workloads"]) <= cells
        assert callable(load_module("metrics", m["name"]).read)
        layers.setdefault(m["layer"].split(" ")[0], set()).add(m["layer"])
    # one spelling a layer
    assert all(len(v) == 1 for v in layers.values())
    for w in cells:
        got = Cell(w, M)
        reported = {m["name"] for m in got.metrics("end_to_end")}
        assert "setup_s" in reported and len(reported) >= 2
        assert got.metrics("per_layer")
        for m in got.metrics("per_layer"):
            assert m["moves"] in reported
