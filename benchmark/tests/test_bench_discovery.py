"""Every file of a cell, configuration, traffic mix and per-layer metric is
found by its name in ``BENCHMARK.json``, and nothing else lies beside
them."""

from __future__ import annotations

import json
import re

import pytest

from benchmark import harness
from benchmark.tests import tiny

BENCH = json.loads((tiny.ROOT / "BENCHMARK.json").read_text())
HERE = tiny.ROOT / "benchmark"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"] and BENCH["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s"}
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"]) for m in BENCH["end_to_end"] + BENCH["per_layer"])


@pytest.mark.parametrize("cell", [c["name"] for c in BENCH["workloads"]])
def test_cell_finds_its_files(cell):
    _, entry, config, traffic, limits = harness.load_cell(tiny.ROOT, cell)
    harness.check_config(config)
    assert config["name"] == entry["config"] and traffic["name"] == entry["traffic"]
    assert limits and all(v >= 0 for v in limits.values())
    conf_entry = next(c for c in BENCH["configs"] if c["name"] == entry["config"])
    assert conf_entry["file"] == f"benchmark/configs/{entry['config']}.json"
    assert conf_entry["reduced"] == config["reduced"] and conf_entry["source"] == config["source"]


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_found(metric):
    entry = next(m for m in BENCH["per_layer"] if m["name"] == metric)
    assert entry["moves"] in {m["name"] for m in BENCH["end_to_end"]}
    assert set(entry["workloads"]) <= {c["name"] for c in BENCH["workloads"]}
    spec = harness.importlib.util.spec_from_file_location("m", HERE / "metrics" / f"{metric}.py")
    module = harness.importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    assert callable(module.read)


@pytest.mark.parametrize("folder,names", [
    ("configs", {c["name"] for c in BENCH["configs"]}),
    ("traffic", {c["traffic"] for c in BENCH["workloads"]}),
    ("limits", {c["name"] for c in BENCH["workloads"]}),
    ("metrics", {m["name"] for m in BENCH["per_layer"]}),
])
def test_every_file_is_named(folder, names):
    found = {p.name.rsplit(".", 1)[0] for p in (HERE / folder).iterdir() if p.suffix in (".json", ".py")}
    assert found == names
