"""The benchmark's manifest (``BENCHMARK.json``) and the files it names.

Everything that belongs to one configuration, traffic mix or metric sits
in a file of its own, found by name:

- ``configs/<config>.json``: the configuration as run; its ``entry`` names
  the module that runs it, ``entries/<entry>.py``;
- ``traffic/<traffic>.json``: the parameters that entry's generator reads;
- ``limits/<cell>.json``: the limit of each number that decides the cell's
  ``correct``;
- ``metrics/<metric>.py``: a reader with ``UNIT``, ``LAYER``, ``MOVES`` and
  ``read(record)``, which returns a number or None when the record holds
  nothing for it.

So a cell, a configuration or a metric is added by adding files and
manifest entries; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent  # portbench/
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    better: str
    source: str
    kind: str  # "end_to_end" or "per_layer"
    workloads: tuple | None
    bound: float | None = None
    layer: str | None = None
    moves: str | None = None

    def applies_to(self, workload: str) -> bool:
        return self.workloads is None or workload in self.workloads


@dataclass(frozen=True)
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    metrics: tuple  # the Metric entries the cell reports, end to end first


def find_manifest(root: Path | None = None) -> Path:
    """``BENCHMARK.json`` at the root of the checkout (the parent of
    ``portbench/``)."""
    path = (root or BENCH_DIR.parent) / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"no manifest at {path}")
    return path


def _load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_cell(workload: str, manifest_path: Path | None = None,
              bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell ``workload`` with its configuration, traffic and metrics."""
    manifest_path = manifest_path or find_manifest()
    m = _load_json(manifest_path)
    root = manifest_path.parent
    cells = {w["name"]: w for w in m["workloads"]}
    if workload not in cells:
        raise KeyError(f"unknown workload {workload!r}: want one of {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in m["configs"]}
    cfg_entry = configs[w["config"]]
    config = _load_json(root / cfg_entry["file"])
    traffic = _load_json(bench_dir / "traffic" / f"{w['traffic']}.json")
    metrics = []
    for kind in ("end_to_end", "per_layer"):
        for e in m[kind]:
            metric = Metric(name=e["name"], unit=e["unit"], better=e["better"],
                            source=e["source"], kind=kind,
                            workloads=tuple(e["workloads"]) if "workloads" in e else None,
                            bound=e.get("bound"), layer=e.get("layer"), moves=e.get("moves"))
            if metric.applies_to(workload):
                metrics.append(metric)
    limits = _load_json(bench_dir / "limits" / f"{workload}.json")
    return Cell(workload, w["config"], w["traffic"], int(w["chips"]), config, traffic, limits,
                tuple(metrics))


def cell_from_files(name: str, config_name: str, traffic_name: str, chips: int = 1,
                    bench_dir: Path = BENCH_DIR) -> Cell:
    """A cell that the manifest does not (yet) hold, from its files alone,
    with no metrics: for tools and tests."""
    config = _load_json(bench_dir / "configs" / f"{config_name}.json")
    traffic = _load_json(bench_dir / "traffic" / f"{traffic_name}.json")
    limits = _load_json(bench_dir / "limits" / f"{name}.json")
    return Cell(name, config_name, traffic_name, chips, config, traffic, limits, ())


def load_module(path: Path, tag: str):
    """Import the Python file ``path`` under a private module name."""
    mod_name = "portbench_" + tag + "_" + re.sub(r"[^A-Za-z0-9_]", "_", path.stem)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, bench_dir: Path = BENCH_DIR):
    """The reader module of metric ``name`` (``metrics/<name>.py``)."""
    path = bench_dir / "metrics" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"metric {name!r} has no reader at {path}")
    return load_module(path, "metric")


def entry(name: str, bench_dir: Path = BENCH_DIR):
    """The module that runs a configuration's ``entry``
    (``entries/<entry>.py``)."""
    if not NAME.match(name):
        raise ValueError(f"bad entry name {name!r}")
    return load_module(bench_dir / "entries" / f"{name}.py", "entry")
