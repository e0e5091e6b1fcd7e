"""Every entry of BENCHMARK.json resolves to the files the harness finds by
name, and keeps to the benchmark's contract on names, units and bounds."""

import json
import re

import pytest

from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = harness.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["per_layer"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_resolves(entry):
    cfg = harness.read_json(harness.ROOT / entry["file"])
    assert entry["file"] == f"portbench/configs/{entry['name']}.json"
    assert cfg["source"] == entry["source"] and cfg["reduced"] == entry["reduced"] == []
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves(name):
    entry = next(w for w in BENCH["workloads"] if w["name"] == name)
    cell = harness.cell(name)
    assert cell["config"] == entry["config"] and cell["chips"] == entry["chips"] == 1
    assert cell["why"] == entry["why"] and len(entry["why"]) <= 200
    harness.config(cell["config"])
    # every cell reports set-up, another end-to-end metric and a per-layer one
    e2e = {m["name"] for m in harness.end_to_end(name, BENCH)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert harness.per_layer(name, BENCH)
    # a limit for every number its kind compares
    want = {"train": {"loss_gap", "grad_gap", "grad_gap_median", "change_gap",
                      "change_gap_worst"},
            "serve": {"prob_gap"}}
    assert set(cell["limits"]) == want[cell["kind"]]


@pytest.mark.parametrize("name", METRICS)
def test_metric_file_agrees(name):
    entry = next(m for m in BENCH["per_layer"] if m["name"] == name)
    module = harness.metric_module(name)
    assert (module.LAYER, module.UNIT, module.SOURCE, module.MOVES) == (
        entry["layer"], entry["unit"], entry["source"], entry["moves"])
    for w in entry["workloads"]:
        assert harness.cell(w)["kind"] == module.KIND
        assert entry["moves"] in {m["name"] for m in harness.end_to_end(w, BENCH)}


def test_names_units_bounds():
    names = [*CELLS, *METRICS, *(m["name"] for m in BENCH["end_to_end"]),
             *(c["name"] for c in BENCH["configs"])]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_bounds_match_perf_md():
    """Each end-to-end bound is the one PERF.md's table of end-to-end
    metrics gives it (a row: the metric in backticks first, its bound last)."""
    row = re.compile(r"^\| `([A-Za-z0-9_.-]+)` .*\| ([0-9.]+) \|$")
    stated = {}
    with open(harness.ROOT / "PERF.md") as f:
        for line in f:
            m = row.match(line.strip())
            if m:
                stated[m.group(1)] = float(m.group(2))
    assert {m["name"]: m["bound"] for m in BENCH["end_to_end"]} == {
        m["name"]: stated.get(m["name"]) for m in BENCH["end_to_end"]}


def test_every_layer_named_once():
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"], set()).add(m["name"])
    assert all("\n" not in layer and len(layer) <= 200 for layer in layers)
