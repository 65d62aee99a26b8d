"""Resolve a cell of ``BENCHMARK.json`` into the files that define it.

Everything that belongs to one configuration, one traffic mix or one
metric sits in a file of its own, found by the name that
``BENCHMARK.json`` gives it:

  <paths[0]>/configs/<config>.json       sizes as run (``file`` of the entry)
  <paths[0]>/traffic/<traffic>.json      the mix's parameters
  <paths[0]>/limits/<cell>.json          the limits of the ``correct`` check
  <paths[0]>/metrics/<metric>.py         one reader per metric
  <paths[0]>/systems/<system>.py         how the port is driven
  <paths[0]>/reference/<reference>.py    the plain reference

A config names its ``system`` and its ``reference``, so a later
configuration of a family that is already here adds JSON files only.
"""
from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import json
import pathlib
from types import ModuleType
from typing import Dict, List, Optional


@dataclasses.dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    better: str
    source: str
    workloads: Optional[tuple]
    moves: Optional[str]
    reader: ModuleType


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    system: ModuleType
    reference: ModuleType
    end_to_end: List[Metric]
    per_layer: List[Metric]


def load_module(path: pathlib.Path) -> ModuleType:
    """Import the Python file at ``path`` under a name made from its
    resolved path, so two roots never share a module."""
    path = pathlib.Path(path).resolve()
    if not path.is_file():
        raise FileNotFoundError(f"no such file: {path}")
    tag = hashlib.sha1(str(path).encode()).hexdigest()[:10]
    name = f"portbench_{path.stem.replace('.', '_').replace('-', '_')}_{tag}"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: pathlib.Path) -> dict:
    return load_json(pathlib.Path(root) / "BENCHMARK.json")


def _metrics(entries, bench: pathlib.Path) -> Dict[str, Metric]:
    out = {}
    for e in entries:
        wl = e.get("workloads")
        out[e["name"]] = Metric(
            name=e["name"], unit=e["unit"], better=e["better"],
            source=e["source"],
            workloads=None if wl is None else tuple(wl),
            moves=e.get("moves"),
            reader=load_module(bench / "metrics" / f"{e['name']}.py"))
    return out


def _applies(m: Metric, cell: str) -> bool:
    return m.workloads is None or cell in m.workloads


def resolve(root, cell_name: str) -> Cell:
    """The cell ``cell_name`` with its configuration, traffic, limits,
    system, reference and the metrics it reports."""
    root = pathlib.Path(root).resolve()
    b = benchmark(root)
    bench = root / b["paths"][0]
    cells = {w["name"]: w for w in b["workloads"]}
    if cell_name not in cells:
        raise KeyError(f"no workload {cell_name!r} in BENCHMARK.json; "
                       f"have {sorted(cells)}")
    w = cells[cell_name]
    confs = {c["name"]: c for c in b["configs"]}
    conf = load_json(root / confs[w["config"]]["file"])
    traffic = load_json(bench / "traffic" / f"{w['traffic']}.json")
    limits = load_json(bench / "limits" / f"{cell_name}.json")
    e2e = [m for m in _metrics(b["end_to_end"], bench).values()
           if _applies(m, cell_name)]
    e2e_names = {m.name for m in e2e}
    per = [m for m in _metrics(b["per_layer"], bench).values()
           if (cell_name in m.workloads if m.workloads is not None
               else m.moves in e2e_names)]
    return Cell(
        name=cell_name, chips=int(w["chips"]), config=conf,
        traffic=traffic, limits=limits,
        system=load_module(bench / "systems" / f"{conf['system']}.py"),
        reference=load_module(bench / "reference"
                              / f"{conf['reference']}.py"),
        end_to_end=e2e, per_layer=per)
