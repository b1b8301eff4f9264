"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix; the configuration's file is the one ``configs`` gives it, the traffic
mix is ``traffic/<name>.json``, each per-layer metric is read by
``metrics/<name>.py``, and what one call of the cell is comes from
``kinds/<kind>.py``, the configuration's ``"kind"`` (``"scan"`` where it
names none). Adding a cell, a metric or a kind of call adds files and
entries and edits none. Every file is found under ``root``, the checkout
that holds ``BENCHMARK.json``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
DEFAULT_KIND = "scan"


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    traffic: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]
    kind: ModuleType  # ``kinds/<kind>.py``: pool, call, reference, checks
    root: Path        # the checkout the cell's files were found in


def load_spec(root: Path = ROOT) -> Dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def _module(path: Path, name: str) -> ModuleType:
    mod_spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module


def load_kind(kind: str, root: Path = ROOT) -> ModuleType:
    """``kinds/<kind>.py``: the module that says what one call of a cell
    is (its pool, call, reference and comparison)."""
    return _module(root / HERE.name / "kinds" / f"{kind}.py",
                   f"crowdbench_kind_{kind}")


def resolve(name: str, spec: Dict = None, root: Path = ROOT) -> Cell:
    """The cell ``name`` with its configuration, traffic mix, kind and the
    metrics it reports. Raises KeyError for an unknown cell."""
    spec = spec if spec is not None else load_spec(root)
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json; cells: "
                       f"{sorted(cells)}")
    w = cells[name]
    cfg = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = json.loads((root / cfg["file"]).read_text())
    traffic = json.loads(
        (root / HERE.name / "traffic" / f"{w['traffic']}.json").read_text())
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic,
                end_to_end=[m for m in spec["end_to_end"]
                            if _applies(m, name)],
                per_layer=[m for m in spec["per_layer"]
                           if _applies(m, name)],
                kind=load_kind(config.get("kind", DEFAULT_KIND), root),
                root=root)


def metric_reader(name: str, root: Path = ROOT) -> Callable:
    """``read`` of ``metrics/<name>.py``: the per-layer metric's reader."""
    return _module(root / HERE.name / "metrics" / f"{name}.py",
                   f"crowdbench_metric_{name.replace('.', '_')}").read
