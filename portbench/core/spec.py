"""A cell as ``BENCHMARK.json`` and its files describe it.

``BENCHMARK.json`` names the cell, its configuration, its traffic and
its chips; the files under ``portbench/`` hold the rest, each found by
that name: ``configs/<config>.json``, ``traffic/<traffic>.json``,
``workloads/<cell>.json``, ``models/<family>.py``,
``reference/<family>.py`` and ``metrics/<metric>.py``.  A new cell,
configuration or metric is new files and entries; nothing here names
one.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import json
import sys
from pathlib import Path
from typing import List, Optional

ROOT = Path(__file__).resolve().parents[2]      # the checkout
BENCH = "portbench"


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    workload: dict           # workloads/<cell>.json
    end_to_end: List[dict]   # BENCHMARK.json's metrics this cell reports
    per_layer: List[dict]
    root: str                # the directory that holds BENCHMARK.json

    @property
    def bench_dir(self) -> Path:
        return Path(self.root) / BENCH

    @property
    def family(self) -> str:
        return self.config["family"]


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str, reported: Optional[set]) -> bool:
    """A metric with ``workloads`` applies to the cells it lists; one
    without applies to every cell (end to end) or to every cell that
    reports the metric it moves (per layer)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return reported is None or metric.get("moves") in reported


def load_cell(name: str, root=ROOT) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json``; raises KeyError
    for a name it does not list."""
    root = Path(root)
    bench = _read_json(root / "BENCHMARK.json")
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries:
        raise KeyError(f"no cell {name!r} in {root / 'BENCHMARK.json'}; "
                       f"cells: {[w['name'] for w in bench['workloads']]}")
    entry = entries[0]
    base = root / BENCH
    e2e = [m for m in bench["end_to_end"] if _applies(m, name, None)]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _applies(m, name, reported)]
    return Cell(name=name, chips=int(entry["chips"]),
                config_name=entry["config"],
                config=_read_json(base / "configs" / f"{entry['config']}.json"),
                traffic_name=entry["traffic"],
                traffic=_read_json(base / "traffic" / f"{entry['traffic']}.json"),
                workload=_read_json(base / "workloads" / f"{name}.json"),
                end_to_end=e2e, per_layer=layer, root=str(root))


def load_module(path: Path, prefix: str):
    """Import the Python file ``path`` under a name of its own (file names
    here may hold dots and hyphens)."""
    path = Path(path).resolve()
    tag = hashlib.sha256(str(path).encode()).hexdigest()[:12]
    mod_name = f"portbench_{prefix}_{tag}_" + "".join(
        c if c.isalnum() else "_" for c in path.stem)
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    module = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = module
    spec.loader.exec_module(module)
    return module


def family_module(cell: Cell):
    """``models/<family>.py``: the port's model and loss."""
    return load_module(cell.bench_dir / "models" / f"{cell.family}.py",
                       "model")


def reference_module(cell: Cell):
    """``reference/<family>.py``: the plain model."""
    return load_module(cell.bench_dir / "reference" / f"{cell.family}.py",
                       "reference")


def metric_module(cell: Cell, metric: str):
    """``metrics/<metric>.py``: one per-layer metric's reader."""
    return load_module(cell.bench_dir / "metrics" / f"{metric}.py", "metric")
