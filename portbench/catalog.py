"""Find a cell, its configuration, its window driver and its metrics by
the names ``BENCHMARK.json`` gives.

* ``portbench/cells/<cell>.json``: ``config``, ``traffic`` (the mix's
  name), ``driver``, ``params`` (the mix's parameters, read by the
  driver's generator) and ``limits`` (each number that decides
  ``correct``, with its limit);
* ``portbench/configs/<config>.json``: the deployment, its source,
  ``reduced``, ``assumed`` and ``guarantees``;
* ``portbench/drivers/<driver>.py``: the window driver;
* ``portbench/metrics/<metric>.py``: one per-layer metric's reader, a
  ``read(ctx)`` that returns a number or None;
* ``portbench/controls/<driver>.py``: the controls of a driver's cells.

Adding a cell, a configuration or a metric adds files and entries; no
file here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCHMARK = ROOT / "BENCHMARK.json"


def load_benchmark(path: Path = BENCHMARK) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _json(kind: str, name: str) -> dict:
    with open(HERE / kind / f"{name}.json", encoding="utf-8") as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``portbench/<kind>/<name>.py`` as a module (a name may hold dots)."""
    path = HERE / kind / f"{name}.py"
    modname = f"portbench.{kind}.{name.replace('.', '_').replace('-', '_')}"
    if modname in sys.modules:
        return sys.modules[modname]
    if not path.is_file():
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[modname] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[modname]
        raise
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic: str
    params: dict
    limits: dict
    driver_name: str
    end_to_end: list  # the BENCHMARK.json entries this cell reports
    per_layer: list

    @property
    def driver(self):
        return load_module("drivers", self.driver_name)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: dict | None = None) -> Cell:
    bench = load_benchmark() if bench is None else bench
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    spec = _json("cells", name)
    if (spec["config"], spec["traffic"]) != (entry["config"],
                                             entry["traffic"]):
        raise ValueError(f"cells/{name}.json names another config or "
                         f"traffic than BENCHMARK.json")
    return Cell(name=name, chips=int(entry["chips"]),
                config_name=spec["config"],
                config=_json("configs", spec["config"]),
                traffic=spec["traffic"], params=spec["params"],
                limits=spec["limits"], driver_name=spec["driver"],
                end_to_end=[m for m in bench["end_to_end"]
                            if _reports(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _reports(m, name)])
