"""Finds everything a cell needs by the names in ``BENCHMARK.json``.

A cell's pieces are files of their own, looked up by name:
  configs:   the ``file`` of its configuration entry
  traffic:   ``traffic/<traffic>.json``: the job kind and its parameters
  workloads: ``workloads/<cell>.json``: the cell's correctness limits
  jobs:      ``jobs/<kind>.py``: setup, window, traced run and check
  metrics:   ``metrics/<metric>.py``: one per-layer reader each
  recipes:   ``reference/recipes/<scene>.py``: the configuration's scene
             for the plain reference
Each is searched in the benchmark folders in order (a test puts a
folder of its own first), so a new cell, configuration, traffic mix,
job kind, scene recipe or metric is a new file and a new
``BENCHMARK.json`` entry.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent   # this benchmark folder
ROOT = HERE.parent                               # the checkout's root


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict          # the configuration file, as run
    traffic: dict         # the traffic file: kind and parameters
    limits: dict          # check name -> limit (workloads/<cell>.json)
    end_to_end: list      # BENCHMARK.json entries this cell reports
    per_layer: list
    spec: "Spec"


def find(folders, sub, filename):
    """``<sub>/<filename>`` in the first of `folders` that has it."""
    for folder in folders:
        path = Path(folder) / sub / filename
        if path.exists():
            return path
    raise FileNotFoundError(
        f"{sub}/{filename} in none of {[str(f) for f in folders]}")


def load(folders, sub, name):
    """The module of ``<sub>/<name>.py``, imported by its path."""
    path = find(folders, sub, f"{name}.py")
    mod_spec = importlib.util.spec_from_file_location(
        "bench_" + f"{sub}_{name}".replace(".", "_").replace("/", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


class Spec:
    def __init__(self, root=ROOT, folders=None):
        """root: where BENCHMARK.json is; folders: the benchmark folders
        to search, first match wins (default: this one)."""
        self.root = Path(root)
        self.folders = [Path(f) for f in (folders or [HERE])]
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())

    def find(self, sub, filename):
        return find(self.folders, sub, filename)

    def module(self, sub, name):
        return load(self.folders, sub, name)

    def cell(self, name):
        cells = {w["name"]: w for w in self.data["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r}; known: {sorted(cells)}")
        w = cells[name]
        conf = {c["name"]: c for c in self.data["configs"]}[w["config"]]
        config = json.loads(self._path(conf["file"]).read_text())
        traffic = json.loads(self.find("traffic", f"{w['traffic']}.json")
                             .read_text())
        own = json.loads(self.find("workloads", f"{name}.json").read_text())
        applies = lambda m: name in m.get("workloads", [name])
        return Cell(
            name=name, chips=int(w["chips"]), config=config, traffic=traffic,
            limits={k: float(v["limit"]) for k, v in own["checks"].items()},
            end_to_end=[m for m in self.data["end_to_end"] if applies(m)],
            per_layer=[m for m in self.data["per_layer"] if applies(m)],
            spec=self)

    def _path(self, rel):
        """A configuration's ``file``, relative to the root; in a test's
        folder first."""
        for folder in self.folders:
            path = folder.parent / rel
            if path.exists():
                return path
        return self.root / rel
