"""The z-stack cell, ``chained_8k.zstack``, at the tiny size on the CPU:
its traffic is ``cycif4``'s but for six z-planes a cycle, no plane
saturates and the z-max projection is the top plane, a traced run is
correct against the reference, and the readers of the projection's pages
and of the apply's device-to-host wait read the port's spans."""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import harness, inputs, program_trace
from benchmark.tests import tiny

CELL = "chained_8k.zstack"
CONTROL = "chained_8k.cycif4"
NEW_METRICS = {"pages.project_ms_per_plane", "pipeline.apply_fetch_ms_per_plane"}


def _planes(cell: str) -> np.ndarray:
    _, _, config, traffic, _ = harness.load_cell(tiny.ROOT, cell)
    config = {**config, **tiny.override(cell)}
    return inputs.make_planes(config, traffic, tiny.SEED, torch.device("cpu"))


def test_configuration_is_chained_8k_but_its_deployment():
    """The z-stack deployment runs ``chained_8k``'s stages, route,
    precision and motions at its plane, so the two cells differ in the
    traffic alone."""
    _, _, control, _, _ = harness.load_cell(tiny.ROOT, CONTROL)
    _, _, config, _, _ = harness.load_cell(tiny.ROOT, CELL)
    assert config["name"] != control["name"] and config["source"] != control["source"]
    drop = ("name", "source", "deployment", "assumed")
    assert {k: v for k, v in config.items() if k not in drop} == {k: v for k, v in control.items() if k not in drop}
    assert ({k: v for k, v in config["assumed"].items() if k != "inputs"}
            == {k: v for k, v in control["assumed"].items() if k != "inputs"})


def test_traffic_is_cycif4_but_its_z_planes():
    _, _, _, zstack, _ = harness.load_cell(tiny.ROOT, CELL)
    _, _, _, cycif4, _ = harness.load_cell(tiny.ROOT, CONTROL)
    assert zstack["z_planes"] == 6 and zstack["texture"]["z_gain"] == [0.8, 0.04]
    assert zstack["name"] == "zstack" and zstack["source"] != cycif4["source"]
    drop = ("name", "source", "z_planes", "texture")
    assert {k: v for k, v in zstack.items() if k not in drop} == {k: v for k, v in cycif4.items() if k not in drop}
    keep = ("z_gain", "note")
    assert ({k: v for k, v in zstack["texture"].items() if k not in keep}
            == {k: v for k, v in cycif4["texture"].items() if k not in keep})


def test_no_plane_saturates_and_the_projection_is_the_top_plane():
    """The planes of a channel differ by gain alone, so the z-max is the
    top plane, and its u8 projection is ``cycif4``'s up to rounding."""
    from benchmark.check import project

    zstack, cycif4 = _planes(CELL), _planes(CONTROL)
    assert zstack.shape[:3] == (4, 4, 6) and cycif4.shape[:3] == (4, 4, 1)
    assert int(zstack.max()) < 65535
    assert (zstack.max(axis=2) == zstack[:, :, -1]).all()
    for c in range(zstack.shape[0]):
        a = project(zstack[c], 0, "cpu").to(torch.int16)
        b = project(cycif4[c], 0, "cpu").to(torch.int16)
        assert int((a - b).abs().max()) <= 1


@pytest.fixture(scope="module")
def traced_run():
    return tiny.run(CELL, True)


def test_zstack_cell_is_correct(traced_run):
    result = traced_run
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    for name, check in result["checks"].items():
        assert check["value"] <= check["limit"], name
    # on the CPU the device's metrics are left out; the two span readers are read
    assert set(result["metrics"]) == NEW_METRICS
    assert all(m["value"] > 0 for m in result["metrics"].values())


def _span(sid, name, t0_s, t1_s, parent=None):
    return SimpleNamespace(id=sid, parent=parent, name=name, t0_ns=round(t0_s * 1e9), t1_ns=round(t1_s * 1e9))


def _window():
    return SimpleNamespace(spans=SimpleNamespace(spans=[("cycle", 100.0, 101.0), ("cycle", 101.0, 102.0)]))


def _install(monkeypatch, found):
    port = SimpleNamespace(spans=lambda: list(found), counters=lambda: [])
    monkeypatch.setattr(program_trace, "_port", lambda: port)


def test_project_reader(monkeypatch):
    """The window's projections' wall over the pages copied inside them."""
    found = [_span(1, "pages.project", 100.1, 100.16), _span(2, "pages.copy", 100.11, 100.12, 1),
             _span(3, "pages.copy", 100.13, 100.14, 1), _span(4, "pages.copy", 100.14, 100.15, 1),
             _span(5, "pages.project", 101.2, 101.22), _span(6, "pages.copy", 101.205, 101.215, 5),
             _span(7, "pages.project", 99.0, 99.5), _span(8, "pages.copy", 99.1, 99.2, 7),  # before the window
             _span(9, "pages.copy", 101.5, 101.6)]  # in no projection
    _install(monkeypatch, found)
    t = _window()
    assert harness.read_metric("pages.project_ms_per_plane", t) == pytest.approx((60 + 20) / 4)
    _install(monkeypatch, [s for s in found if s.name == "pages.project"])  # the parent's port: no pages.copy
    assert harness.read_metric("pages.project_ms_per_plane", t) is None
    monkeypatch.setattr(program_trace, "_port", lambda: None)
    assert harness.read_metric("pages.project_ms_per_plane", t) is None


def test_fetch_reader(monkeypatch):
    """The mean wall of the window's ``apply.fetch`` spans."""
    found = [_span(1, "apply.write", 100.1, 100.2), _span(2, "apply.fetch", 100.1, 100.13, 1),
             _span(3, "apply.write", 101.1, 101.2), _span(4, "apply.fetch", 101.1, 101.15, 3),
             _span(5, "apply.fetch", 99.1, 99.9)]  # before the window
    _install(monkeypatch, found)
    t = _window()
    assert harness.read_metric("pipeline.apply_fetch_ms_per_plane", t) == pytest.approx(40.0)
    _install(monkeypatch, [s for s in found if s.name == "apply.write"])  # the parent's port: no apply.fetch
    assert harness.read_metric("pipeline.apply_fetch_ms_per_plane", t) is None
    monkeypatch.setattr(program_trace, "_port", lambda: None)
    assert harness.read_metric("pipeline.apply_fetch_ms_per_plane", t) is None
