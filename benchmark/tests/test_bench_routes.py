"""A configuration's route and precision are data: the run sets the
route's variables, the reference computes in the stated precision, and the
inputs' texture is the traffic mix's.  On the CPU at a tiny size, where
the port runs each kernel's plain version."""

from __future__ import annotations

import os

import pytest
import torch

from benchmark import check, harness, inputs, roofline
from benchmark.tests import tiny

AGG = "MICROALIGNER_TPU_AGG_PRECISION"
R_BF16 = "MICROALIGNER_TPU_R_BF16"


@pytest.mark.parametrize("route,flow", [
    ({}, "float32"),
    ({AGG: "default"}, "bfloat16"),
    ({AGG: "default", R_BF16: "0"}, "bfloat16_m"),
])
def test_flow_route_against_its_precision(route, flow):
    result = tiny.run("optflow_20k.cycif4", route=route, precision={"flow": flow, "warp": "float32"})
    assert result["correct"] is True, result["checks"]
    assert not any(k.startswith(harness.ROUTE_PREFIX) for k in os.environ), "the route is unset after the run"


def test_precision_that_disagrees_with_the_route_is_not_correct():
    result = tiny.run("optflow_20k.cycif4", route={AGG: "default"}, precision={"flow": "float32", "warp": "float32"})
    assert result["correct"] is False, result["checks"]


def test_environment_that_sets_a_route_variable_is_refused(monkeypatch):
    monkeypatch.setenv("MICROALIGNER_TPU_MATCH_F32", "1")
    with pytest.raises(SystemExit, match="MICROALIGNER_TPU_MATCH_F32"):
        tiny.run("optflow_20k.cycif4")


@pytest.mark.parametrize("precision", [
    {"flow": "float16", "warp": "float32"},
    {"flow": "tf32", "warp": "float32"},  # a control's, with no step below it
    {"flow": "float32"},
])
def test_precision_the_reference_cannot_take_is_refused(precision):
    config = {"OptFlowReg": tiny.OPTFLOW, "FeatureReg": None, "route": {}, "precision": precision}
    with pytest.raises(ValueError):
        harness.check_config(config)


def test_control_steps_below_each_stage():
    config = {"FeatureReg": tiny.FEATURE, "precision": {"daisy": "bfloat16", "match": "float32",
                                                        "flow": "bfloat16_m", "warp": "float32"}}
    ctrl = check.precision(config, control=True)
    assert ctrl == {"daisy": check.STAGES["daisy"]["fp8"], "match": check.STAGES["match"]["tf32"],
                    "flow": check.STAGES["flow"]["fp8_m"], "warp": 10}


@pytest.mark.parametrize("coverage", [0.1, 0.5])
def test_texture_mask_covers_its_share(coverage):
    spec = {"blur_sigmas_px": [2.0], "blur_weights": [1.0],
            "mask": {"sigma_px": 4.0, "coverage": coverage, "edge": 1e-6}}
    gen = torch.Generator().manual_seed(tiny.SEED)
    tex = inputs.texture(256, 256, spec, gen, torch.device("cpu"))
    share = float((tex > 0).float().mean())
    assert abs(share - coverage) < 0.02, share


def test_roofline_counts_the_stated_storage():
    params = {"Overlap": 100, "NumberIterationsPerLevel": 3, "NumberPyramidLevels": 3, "UseFullResImage": True}
    least = {f: roofline.register_least_s((20480, 20480), params, f) for f in roofline.FLOW_STORAGE}
    assert least["float32"] > least["bfloat16_m"] > least["bfloat16"] > 0
    assert set(roofline.FLOW_STORAGE) <= set(check.STAGES["flow"])
