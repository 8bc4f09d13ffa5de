"""BENCHMARK.json against the contract's shape, and every name against
its file."""

import json
import re

import pytest

from portbench import catalog

BENCH = catalog.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_and_sizes():
    assert set(BENCH) == KEYS["top"]
    assert len(json.dumps(BENCH)) <= 64 << 10
    assert 1 <= len(BENCH["paths"]) <= 16
    assert all(PATH.match(p) and ".." not in p and not p.startswith("/")
               for p in BENCH["paths"])
    assert len(BENCH["command"]) <= 32 and all(_line(w)
                                               for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[kind]:
            extra = set(entry) - KEYS[kind]
            assert extra <= ({"workloads"} if kind in (
                "end_to_end", "per_layer") else set()), (kind, extra)
            assert KEYS[kind] <= set(entry), (kind, entry["name"])


def test_names_units_and_lines():
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[kind]]
        assert len(names) == len(set(names)), kind
        assert all(NAME.match(n) for n in names), names
    metrics = [m["name"] for k in ("end_to_end", "per_layer")
               for m in BENCH[k]]
    assert len(metrics) == len(set(metrics))
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
    for c in BENCH["configs"]:
        assert _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for kind in ("end_to_end", "per_layer"):
        for m in BENCH[kind]:
            assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        assert _line(m["layer"])
        if m["name"].split(".")[0].endswith("_roofline"):
            assert m["unit"] == "%"


def test_metric_rules():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
    for cell in cells:
        reported = [n for n, m in e2e.items()
                    if cell in m.get("workloads", cells)]
        assert "setup_s" in reported and len(reported) >= 2
        assert any(cell in m["workloads"] for m in BENCH["per_layer"])


def test_four_chip_cells_within_a_quarter():
    four = sum(1 for w in BENCH["workloads"] if w["chips"] == 4)
    assert four <= max(1, len(BENCH["workloads"]) // 4)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves_to_its_files(cell):
    c = catalog.load_cell(cell, BENCH)
    assert (catalog.HERE / "cells" / f"{cell}.json").is_file()
    assert (catalog.HERE / "drivers" / f"{c.driver_name}.py").is_file()
    for fn in ("setup", "window", "release", "end_to_end", "reference",
               "check", "counters", "attempted"):
        assert callable(getattr(c.driver, fn)), fn
    assert c.limits and all(v >= 0 for v in c.limits.values())
    assert catalog.load_module("controls", c.driver_name).SYSTEMS


@pytest.mark.parametrize("config", BENCH["configs"],
                         ids=lambda c: c["name"])
def test_every_config_resolves_to_its_file(config):
    path = catalog.ROOT / config["file"]
    assert path.is_file() and path.parent == catalog.HERE / "configs"
    assert path.stem == config["name"]
    data = json.loads(path.read_text())
    assert data["source"] == config["source"]
    assert data["reduced"] == config["reduced"]
    assert set(data["reduced"]) <= set(data.get("source_values", {}))
    assert "assumed" in data and data["guarantees"]
    assert any(w["config"] == config["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_per_layer_metric_has_a_reader(metric):
    mod = catalog.load_module("metrics", metric)
    assert callable(mod.read)


def test_files_are_named_from_names():
    for path in catalog.HERE.rglob("*"):
        if "__pycache__" in path.parts:
            continue
        rel = path.relative_to(catalog.ROOT).as_posix()
        assert PATH.match(rel), rel


def test_the_chunking_constants_agree_with_the_reference():
    from portbench.reference import cdc

    ch = json.loads((catalog.HERE / "configs" / "content-import.json")
                    .read_text())["chunking"]
    assert (ch["gear_c1"], ch["gear_c2"]) == (cdc.GEAR_C1, cdc.GEAR_C2)
    assert ch["thin_bits"] == ch["min_size"].bit_length() - 1
