"""BENCHMARK.json and the files it names: found by name, and within the
contract's limits."""

import json
import re

from portbench.harness import HERE, cell_metrics, load_module

from .conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_keys_and_names(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "portbench/run.py"]
    assert bench["paths"] == ["portbench"]
    assert 1 <= bench["run_seconds"] <= 51
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in bench[group]]
        assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_every_cell_finds_its_files(bench):
    configs = {c["name"]: c for c in bench["configs"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    for cell in bench["workloads"]:
        assert cell["chips"] == 1 and len(cell["why"]) <= 200
        entry = configs[cell["config"]]
        config = json.loads((ROOT / entry["file"]).read_text())
        assert config["name"] == entry["name"] and config["reduced"] == entry["reduced"]
        traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())
        load_module("drivers", traffic["driver"]).Driver
        reports = {m["name"] for m in cell_metrics(bench, cell["name"], "end_to_end")}
        assert "setup_s" in reports and len(reports & e2e) >= 2
        assert cell_metrics(bench, cell["name"], "per_layer")
    used = {c["config"] for c in bench["workloads"]}
    assert used == set(configs)


def test_every_metric_has_a_reader_and_known_cells(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert callable(load_module("metrics", m["name"]).read)
        assert m["moves"] in e2e and set(m.get("workloads", cells)) <= cells
    for m in bench["end_to_end"]:
        assert set(m.get("workloads", cells)) <= cells
