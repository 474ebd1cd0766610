"""``MICROALIGNER_TPU_FLOW_BAND_ROWS`` in the port: the band height of
every banded flow and warp when no ``band_rows`` is given, as the JAX
package reads it, so that the port's CLI honours it as the JAX CLI does.

Bars and their reasons:
* the variable against the same height given as the ``band_rows``
  attribute (or argument): bit for bit, since it is the same computation;
* the registrator against the JAX package's under the same variable:
  tests/test_torch_optflow_engine.py's bars (accept/reject identical, NMI
  within 5e-5, flow mean < 1e-3 px and max < 0.05 px);
* the CLI against the JAX CLI under the same variable:
  tests/test_torch_pipeline.py's bar (registered planes within 1 u16 level
  at >= 99.9% of pixels).
"""

import contextlib
import io

import numpy as np
import pytest
import torch

import microaligner_tpu_torch as port
from microaligner_tpu.pipeline.config import PipelineConfigReader as JReader
from microaligner_tpu.pipeline.runner import run_pipeline as j_run_pipeline
from microaligner_tpu_torch.optflow.flow_calc import band_rows_for
from microaligner_tpu_torch.pipeline import runner as trunner
from microaligner_tpu_torch.tiles import TileGrid

from test_torch_optflow_engine import MI_ATOL, _configure, _register_both, _warped_pair
from test_torch_pipeline import _config, _planes_by_cycle, _run_port, _write_config, data  # noqa: F401

torch.set_num_threads(1)

VARIABLE = "MICROALIGNER_TPU_FLOW_BAND_ROWS"


def test_band_rows_for_reads_the_variable(monkeypatch):
    grid = TileGrid.for_image((20480, 20480), 1000, 100)
    monkeypatch.delenv(VARIABLE, raising=False)
    assert band_rows_for(grid) == 1056  # the 22 Mpix default
    monkeypatch.setenv(VARIABLE, "1088")
    assert band_rows_for(grid) == 1088
    assert band_rows_for(grid, 512) == 512  # the argument wins
    monkeypatch.setenv(VARIABLE, "3")
    assert band_rows_for(grid) == 8
    monkeypatch.setenv(VARIABLE, "")
    assert band_rows_for(grid) == 1056


def test_registrator_under_the_variable(monkeypatch):
    """420 x 440 in bands of 64 rows (seven at full resolution) through the
    variable: bit-equal to ``band_rows = 64``, and within the JAX package's
    bars under the same variable."""
    monkeypatch.setenv(VARIABLE, "64")
    both = _register_both(None, use_dog=False)  # the JAX package and the port, both under the variable
    assert len(both["jscores"]) == len(both["tscores"]) == 3
    for (ja, jb), (ta, tb) in zip(both["jscores"], both["tscores"]):
        assert (ja > jb) == (ta > tb)
        assert abs(ja - ta) <= MI_ATOL and abs(jb - tb) <= MI_ATOL
    err = np.abs(both["tflow"] - both["jflow"])
    assert err.mean() < 1e-3 and err.max() < 0.05, (err.mean(), err.max())
    monkeypatch.delenv(VARIABLE)
    attr = _configure(port.OptFlowRegistrator(device="cpu"), *_warped_pair(), False)
    attr.band_rows = 64
    np.testing.assert_array_equal(both["tflow"], attr.register())


def test_cli_under_the_variable(data, tmp_path, monkeypatch):  # noqa: F811
    """tests/test_torch_pipeline.py's CycleStack in bands of 48 rows: the
    port's CLI under the variable gives the planes of the port's CLI with
    the attribute and argument set to 48 (and the variable unset), and
    agrees with the JAX CLI under the variable."""
    d, cyc1, cyc2 = data
    cfg = _config({"CycleStack": str(d / "stack.ome.tif")}, tmp_path / "jax", True)
    monkeypatch.setenv(VARIABLE, "48")
    with contextlib.redirect_stdout(io.StringIO()):
        j_run_pipeline(JReader().read_config(_write_config(tmp_path / "jax.yaml", cfg)))
        env_dir = _run_port(tmp_path, cfg, "env")
    monkeypatch.delenv(VARIABLE)

    def with_attribute(cls):
        class Banded(cls):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                self.band_rows = 48
        return Banded

    apply = trunner._apply_flow_plane
    monkeypatch.setattr(trunner, "OptFlowRegistrator", with_attribute(trunner.OptFlowRegistrator))
    monkeypatch.setattr(trunner, "Warper", with_attribute(trunner.Warper))
    monkeypatch.setattr(trunner, "_apply_flow_plane", lambda *a: apply(*a, band_rows=48))
    with contextlib.redirect_stdout(io.StringIO()):
        attr_dir = _run_port(tmp_path, cfg, "attr")
    got = _planes_by_cycle(env_dir, True)[2][2]
    for g, a in zip(got, _planes_by_cycle(attr_dir, True)[2][2]):
        np.testing.assert_array_equal(g, a)
    for g, w in zip(got, _planes_by_cycle(tmp_path / "jax", True)[2][2]):
        diff = np.abs(g.astype(np.int32) - w.astype(np.int32))
        assert (diff <= 1).mean() >= 0.999, f"max {diff.max()}, {(diff > 1).mean():.2e} beyond 1"
