"""Finding a cell's pieces by name.

Everything that belongs to one configuration, one traffic mix, one cell's
correctness limits or one metric is a file of its own, found by the name
``BENCHMARK.json`` gives it:

* ``BENCHMARK.json`` at the root of the checkout: the cells, their
  configurations and their metrics;
* a configuration's ``file`` (``bench/configs/<name>.json``): the
  published config's keys at the top level (cut as ``reduced`` lists),
  and under ``port`` the arch the measured program runs and its
  semantics;
* ``bench/traffic/<traffic>.json``: the mix and the engine's settings;
* ``bench/limits/<cell>.json``: the limit of each number ``correct``
  compares;
* ``bench/metrics/<metric>.py``: the metric's reader, ``read(run)``.

A later cell, mix or metric is a new file; no file here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType

ROOT = Path(__file__).resolve().parents[2]


@dataclasses.dataclass(frozen=True)
class Cell:
    """One entry of ``workloads`` with everything it names, loaded."""

    name: str
    chips: int
    config_name: str
    config: dict
    traffic: dict
    limits: dict
    #: the metrics this cell reports: (entry, reader module), end-to-end
    #: ones for ``--trace 0``, per-layer ones for ``--trace 1``
    end_to_end: tuple
    per_layer: tuple


def load_json(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def load_reader(root: Path, name: str) -> ModuleType:
    """The metric ``name``'s reader module, ``bench/metrics/<name>.py``."""
    path = root / "bench" / "metrics" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"metric '{name}' has no reader at {path}")
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    if not callable(getattr(module, "read", None)):
        raise TypeError(f"{path} defines no read(run)")
    return module


def _reports(metric: dict, cell: str, e2e_of_cell: set[str] | None) -> bool:
    """Whether ``cell`` reports ``metric``: the cells its ``workloads``
    list, or (a per-layer metric without the key) every cell that reports
    the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if e2e_of_cell is None:  # an end-to-end metric without the key: every cell
        return True
    return metric["moves"] in e2e_of_cell


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload '{name}' in BENCHMARK.json; known: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    entry = configs[w["config"]]
    config = load_json(root / entry["file"])
    traffic = load_json(root / "bench" / "traffic" / f"{w['traffic']}.json")
    limits = load_json(root / "bench" / "limits" / f"{name}.json")
    e2e = [m for m in bench["end_to_end"] if _reports(m, name, None)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, e2e_names)]
    return Cell(
        name=name, chips=int(w["chips"]), config_name=w["config"], config=config,
        traffic=traffic, limits=limits,
        end_to_end=tuple((m, load_reader(root, m["name"])) for m in e2e),
        per_layer=tuple((m, load_reader(root, m["name"])) for m in per_layer),
    )
