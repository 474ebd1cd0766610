"""The sparse-tissue cell, ``chained_8k.sparse``, at the tiny size on the
CPU: correct against the reference, and its FeatureReg keeps fewer valid
keypoint rows than the dense cell's at the same size and seed.  The
traffic's mask is cut with the plane (its blobs keep their size relative
to the plane: 512 px at 8192^2 is 32 px at 512^2)."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch

from benchmark import harness, program_trace
from benchmark.tests import tiny

CELL = "chained_8k.sparse"
METRIC = "features.keypoint_valid_pct"
TINY_PLANE = 512


def _load_cut(load):
    def load_cut(root, name):
        bench, cell, config, traffic, limits = load(root, name)
        mask = traffic["texture"]["mask"]
        if mask:
            scale = TINY_PLANE / config["plane"][0]
            traffic = {**traffic, "texture": {**traffic["texture"],
                                              "mask": {**mask, "sigma_px": mask["sigma_px"] * scale}}}
        return bench, cell, config, traffic, limits
    return load_cut


@pytest.fixture(scope="module")
def traced_runs():
    """Traced runs of the sparse cell and of its dense control, at the tiny
    size and one seed."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(harness, "load_cell", _load_cut(harness.load_cell))
        return {cell: tiny.run(cell, True) for cell in (CELL, "chained_8k.cycif4")}


def test_traffic_is_the_dense_mix_but_its_mask():
    _, _, _, dense, _ = harness.load_cell(tiny.ROOT, "chained_8k.cycif4")
    _, _, _, sparse, _ = harness.load_cell(tiny.ROOT, CELL)
    assert sparse["texture"]["mask"] == {"sigma_px": 512, "coverage": 0.1, "edge": 0.02}
    drop = ("name", "source", "texture")
    assert {k: v for k, v in sparse.items() if k not in drop} == {k: v for k, v in dense.items() if k not in drop}
    keep = ("mask", "note")
    assert ({k: v for k, v in sparse["texture"].items() if k not in keep}
            == {k: v for k, v in dense["texture"].items() if k not in keep})


def test_configuration_is_the_dense_cells_but_its_deployment():
    """The sparse deployment runs ``chained_8k``'s stages, route, precision
    and motions at its plane, so the two cells differ in the tissue alone."""
    _, _, dense, _, _ = harness.load_cell(tiny.ROOT, "chained_8k.cycif4")
    _, _, sparse, _, _ = harness.load_cell(tiny.ROOT, CELL)
    assert sparse["name"] != dense["name"] and sparse["source"] != dense["source"]
    drop = ("name", "source", "deployment", "assumed")
    assert {k: v for k, v in sparse.items() if k not in drop} == {k: v for k, v in dense.items() if k not in drop}
    assert ({k: v for k, v in sparse["assumed"].items() if k != "inputs"}
            == {k: v for k, v in dense["assumed"].items() if k != "inputs"})


def test_sparse_cell_is_correct(traced_runs):
    result = traced_runs[CELL]
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    for name, check in result["checks"].items():
        assert check["value"] <= check["limit"], name
    # on the CPU the device's metrics are left out; the counter's share is read
    assert set(result["metrics"]) == {"features.keypoint_valid_pct"}


def test_fewer_valid_keypoint_rows_than_the_dense_cell(traced_runs):
    sparse = traced_runs[CELL]["metrics"][METRIC]["value"]
    dense = traced_runs["chained_8k.cycif4"]["metrics"][METRIC]["value"]
    assert 0 < sparse < dense <= 100


def test_reader_sums_the_window(monkeypatch):
    """Valid rows over rows kept, of the counters inside the window's
    cycles alone; nothing from a port that records none."""
    t = SimpleNamespace(spans=SimpleNamespace(spans=[("cycle", 100.0, 101.0), ("cycle", 101.0, 102.0)]))

    def keypoints(t_s, rows, valid):
        return SimpleNamespace(name="features.keypoints", t_ns=round(t_s * 1e9),
                               values=dict(rows=rows, valid=torch.tensor(valid), tiles=rows // 1000,
                                           empty_tiles=torch.tensor(0)))

    found = [keypoints(100.5, 4000, 1000), keypoints(101.5, 12000, 3000),
             keypoints(99.0, 1000, 1000),  # before the window
             SimpleNamespace(name="features.knn", t_ns=round(100.6e9), values={})]
    port = SimpleNamespace(spans=lambda: [], counters=lambda: list(found))
    monkeypatch.setattr(program_trace, "_port", lambda: port)
    assert harness.read_metric(METRIC, t) == pytest.approx(25.0)
    found[:2] = []
    assert harness.read_metric(METRIC, t) is None
    monkeypatch.setattr(program_trace, "_port", lambda: None)
    assert harness.read_metric(METRIC, t) is None
