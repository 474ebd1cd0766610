"""The result line of a run, at a tiny plane size on the CPU."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark.tests import tiny

END_TO_END = {"cycle_s", "cycle_p95_s", "peak_gib", "setup_s"}


def _bench():
    return json.loads((tiny.ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("cell,traced", [(c, t) for c in tiny.CELLS for t in (False, True)])
def test_result_line(cell, traced):
    result = tiny.run(cell, traced)
    assert list(result)[-1] == "checks", "the numbers compared come last"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(result)
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for name, check in result["checks"].items():
        assert check["value"] <= check["limit"], name
    bench = _bench()
    if not traced:
        assert set(result["metrics"]) == END_TO_END
    else:
        # the device's metrics need the card; the spans and the program's lines do not
        expect = {m["name"] for m in bench["per_layer"] if cell in m["workloads"] and m["source"] != "device_trace"}
        assert set(result["metrics"]) == expect
    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    for name, metric in result["metrics"].items():
        assert metric["unit"] == units[name], name
        assert metric["value"] > 0 or name == "peak_gib", name  # the CPU allocates no device memory
    json.dumps(result)


def test_same_seed_same_inputs():
    import torch

    from benchmark import harness, inputs

    _, _, config, traffic, _ = harness.load_cell(tiny.ROOT, "optflow_20k.cycif4")
    config = {**config, **tiny.override("optflow_20k.cycif4")}
    a = inputs.make_planes(config, traffic, tiny.SEED, torch.device("cpu"))
    b = inputs.make_planes(config, traffic, tiny.SEED, torch.device("cpu"))
    c = inputs.make_planes(config, traffic, tiny.SEED + 1, torch.device("cpu"))
    assert (a == b).all() and not (a == c).all()
    assert (a[0] != a[1]).any(), "a moving cycle moves"


def _run_py(cwd, env=None):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload", "optflow_20k.cycif4", "--seed",
                           str(tiny.SEED), "--seconds", "1", "--trace", "0"], cwd=cwd, capture_output=True,
                          text=True, timeout=300, env=env)


def test_run_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = _run_py(tiny.ROOT, env)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_run_refuses_in_a_directory_of_the_benchmark_alone(tmp_path):
    shutil.copy(tiny.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(tiny.ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run_py(tmp_path)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
