"""Finds a cell's pieces by name: the manifest at the root of the checkout
(``BENCHMARK.json``), and the files under this package that it names."""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
MANIFEST = ROOT / "BENCHMARK.json"

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load_manifest(path: Path = MANIFEST) -> dict:
    with open(path) as f:
        return json.load(f)


def _checked(name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"not a name: {name!r}")
    return name


def load_json(kind: str, name: str) -> dict:
    """``<kind>/<name>.json`` under this package."""
    with open(PKG / kind / f"{_checked(name)}.json") as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` under this package; a name that is no Python
    identifier (a metric's may hold dots) is loaded by its path."""
    path = PKG / kind / f"{_checked(name)}.py"
    if not path.is_file():
        raise FileNotFoundError(path)
    if name.isidentifier():
        return importlib.import_module(f"vdbbench.{kind}.{name}")
    modname = f"vdbbench.{kind}.{re.sub(r'[^A-Za-z0-9_]', '_', name)}"
    if modname in sys.modules:
        return sys.modules[modname]
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[modname] = mod
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One workload of the manifest with its configuration, traffic and
    limits loaded."""

    def __init__(self, workload: str, manifest: dict):
        self._load(workload, manifest)

    def _load(self, workload: str, manifest: dict) -> None:
        entries = {w["name"]: w for w in manifest["workloads"]}
        if workload not in entries:
            raise KeyError(f"no workload {workload!r} in the manifest")
        w = entries[workload]
        conf = {c["name"]: c for c in manifest["configs"]}[w["config"]]
        self.name = workload
        self.chips = int(w["chips"])
        self.config_name = conf["name"]
        self.traffic_name = w["traffic"]
        with open(ROOT / conf["file"]) as f:
            self.config = json.load(f)
        self.traffic = load_json("traffic", w["traffic"])
        self.limits = load_json("cells", workload)["limits"]
        self.manifest = manifest

    @classmethod
    def of(cls, workload: str, config: dict, traffic: dict, limits: dict,
           manifest: dict, chips: int = 1) -> "Cell":
        """A cell from its parts as they are (the tests' tiny cells)."""
        cell = cls.__new__(cls)
        cell.name, cell.chips = workload, chips
        cell.config_name = config.get("name", workload)
        cell.traffic_name = workload
        cell.config, cell.traffic, cell.limits = config, traffic, limits
        cell.manifest = manifest
        return cell

    def metrics(self, section: str) -> list:
        """The manifest's metrics of ``section`` that this cell reports."""
        return [m for m in self.manifest[section]
                if "workloads" not in m or self.name in m["workloads"]]
