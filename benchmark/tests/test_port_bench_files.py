"""BENCHMARK.json and every file it names load, and keep the contract's
shape: names and units of the allowed characters, the keys each entry may
have, bounds within range, every cell's configuration, traffic, limits,
driver and per-layer readers present."""

import json
import os
import re

import pytest

from benchmark import run as H

ROOT = H.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys_and_command():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["paths"] == ["benchmark"] and 1 <= b["run_seconds"] <= 51
    assert len(b["command"]) <= 32 and all(TEXT.match(w) for w in b["command"])
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


@pytest.mark.parametrize("entry", bench()["configs"], ids=lambda e: e["name"])
def test_config_entry(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and TEXT.match(entry["source"]) and TEXT.match(entry["why"])
    assert entry["file"].startswith("benchmark/") and len(entry["reduced"]) <= 16
    cfg = H.read_json(os.path.join(ROOT, entry["file"]))
    assert cfg["name"] == entry["name"] and cfg["reduced"] == entry["reduced"]
    assert any(w["config"] == entry["name"] for w in bench()["workloads"])


@pytest.mark.parametrize("cell", bench()["workloads"], ids=lambda e: e["name"])
def test_cell_files_load(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"]) and TEXT.match(cell["why"])
    assert cell["chips"] in (1, 4)
    spec = H.cell_spec(bench(), cell["name"])
    assert os.path.exists(os.path.join(H.HERE, "drivers", spec["traffic"]["driver"] + ".py"))
    for name, lim in spec["limits"].items():
        assert NAME.match(name) and lim["limit"] >= 0
    names = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2 and spec["per_layer"]


@pytest.mark.parametrize("metric", bench()["end_to_end"] + bench()["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entry(metric):
    b = bench()
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    cells = {w["name"] for w in b["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if metric in b["end_to_end"]:
        assert set(metric) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert set(metric) <= {"name", "unit", "better", "source", "layer", "moves",
                               "workloads"}
        assert metric["source"] in ("device_trace", "program_span", "program_counter",
                                    "host_clock")
        assert TEXT.match(metric["layer"])
        assert metric["moves"] in {m["name"] for m in b["end_to_end"]}
        assert os.path.exists(os.path.join(H.HERE, "metrics", metric["name"] + ".py"))


def test_every_file_under_paths_is_named_from_name_characters():
    for dirpath, dirs, files in os.walk(H.HERE):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for n in files:
            rel = os.path.relpath(os.path.join(dirpath, n), ROOT)
            assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", rel), rel
