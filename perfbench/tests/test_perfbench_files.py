"""Every configuration, cell, driver and per-layer metric named in
BENCHMARK.json is a file of its own that the harness finds by name, and the
file keeps to the benchmark's contract."""

from __future__ import annotations

import json
import re

import pytest

from perfbench import harness

BENCH = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_the_keys_and_limits_of_the_file():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"][:2] == ["python3", "perfbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for e in BENCH[k]]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for e in BENCH["configs"] + BENCH["workloads"]:
        assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"]
    # 2 + 14 runs a cell at the full 24 cells fit the check's 43200 s
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_each_configuration_loads_by_name(entry):
    cfg = harness.config(entry["name"])
    assert entry["file"] == f"perfbench/configs/{entry['name']}.json"
    assert cfg["name"] == entry["name"] and cfg["reduced"] == entry["reduced"]
    assert len(cfg["source"]) <= 200


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda e: e["name"])
def test_each_cell_loads_by_name_with_its_driver(entry):
    cell = harness.workload(entry["name"])
    assert cell["config"] == entry["config"] and entry["traffic"] == entry["name"]
    assert cell["why"] == entry["why"] and cell["chips"] == entry["chips"] == 1
    assert hasattr(harness.driver(cell["driver"]), "Cell")
    metrics = harness.end_to_end_metrics(BENCH, entry["name"])
    assert "setup_s" in {m["name"] for m in metrics} and len(metrics) >= 2
    assert harness.per_layer_metrics(BENCH, entry["name"])


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_each_per_layer_metric_has_a_reader_and_moves_what_its_cells_report(metric):
    assert callable(harness.reader(metric["name"]))
    for cell in metric["workloads"]:
        reported = {m["name"] for m in harness.end_to_end_metrics(BENCH, cell)}
        assert metric["moves"] in reported
    if metric["name"].split(".")[0].endswith("_roofline"):
        assert metric["unit"] == "%"


def test_metrics_of_one_layer_name_it_alike():
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
