"""BENCHMARK.json against the benchmark's contract, and every file a cell
names found by name."""

from __future__ import annotations

import importlib
import json
import re

import pytest

from portbench import run as R
from portbench.tests.tiny import CELLS, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return R.load_json(ROOT / "BENCHMARK.json")


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(bench["command"]) <= 32
    assert all(_line(w) and not w.startswith("/") and ".." not in w
               for w in bench["command"])
    assert 1 <= len(bench["paths"]) <= 16
    assert all(PATH.match(p) and not p.endswith("_torch")
               for p in bench["paths"])
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    assert 2 + 14 * 24 * (bench["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200


def test_names_units_and_keys(bench):
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k)
                                               for k in c["reduced"])
        names.append(c["name"])
    assert len(set(names)) == len(names)
    cells = []
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert _line(w["why"])
        cells.append((w["config"], w["traffic"]))
    assert len(set(cells)) == len(cells)
    metrics = bench["end_to_end"] + bench["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert _line(m["layer"])
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}


def test_every_cell_reports_what_it_must(bench):
    ends = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in ends and ends["setup_s"]["bound"] <= 0.25
    for w in bench["workloads"]:
        mine = [m["name"] for m in R.cell_metrics(bench, w["name"], False)]
        assert "setup_s" in mine and len(mine) >= 2
        layers = R.cell_metrics(bench, w["name"], True)
        assert layers
        for m in layers:  # each one's end-to-end metric is the cell's too
            assert m["moves"] in mine
    for m in bench["per_layer"]:
        for cell in m.get("workloads", []):
            assert cell in {w["name"] for w in bench["workloads"]}
    # metrics of one layer give it letter for letter
    by_layer = {}
    for m in bench["per_layer"]:
        by_layer.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())


@pytest.mark.parametrize("workload", CELLS)
def test_cell_files_resolve_by_name(bench, workload):
    cell, config, traffic = R.cell_files(ROOT, bench, workload)
    importlib.import_module(f"portbench.frontends.{config['frontend']}")
    importlib.import_module(f"portbench.scenes.{traffic['scene']}")
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    assert entry["file"].startswith("portbench/")
    assert config["name"] == cell["config"]
    assert config["source"] == entry["source"]
    assert config["reduced"] == entry["reduced"]
    assert all(k in config for k in config["reduced"])
    assert set(config["check"]["limits"]) == {"off_share", "mean_gap"}
    for per_layer in (False, True):
        for m in R.cell_metrics(bench, workload, per_layer):
            spec = R.metric_spec(ROOT, m["name"])
            importlib.import_module(f"portbench.readers.{spec['reader']}")
            if per_layer:
                assert spec["layer"] == m["layer"]
                assert spec["moves"] == m["moves"]


def test_every_metric_file_is_named_in_the_benchmark(bench):
    named = {m["name"] for m in bench["end_to_end"] + bench["per_layer"]}
    files = {p.name[:-len(".json")]
             for p in (ROOT / "portbench" / "metrics").glob("*.json")}
    assert files == named


def test_config_files_are_their_configs_only(bench):
    files = [c["file"] for c in bench["configs"]]
    assert len(set(files)) == len(files)
    for f in files:
        json.loads((ROOT / f).read_text())
