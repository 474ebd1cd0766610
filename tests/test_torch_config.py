"""The port's copy of ``pipeline/config.py`` against the JAX package's
reader: the same ``PipelineConfig`` from every file in ``config_examples/``
and from configs written with ``yaml.dump``, and the same rejections."""

from pathlib import Path

import pytest
import yaml

from microaligner_tpu.pipeline.config import PipelineConfigReader as JReader
from microaligner_tpu_torch.pipeline.config import PipelineConfigReader

EXAMPLES = sorted((Path(__file__).resolve().parent.parent / "config_examples").glob("*.yaml"))


def _plain(cfg) -> dict:
    """A PipelineConfig as nested dicts of plain values."""
    reg = cfg.RegistrationParameters
    return {
        "Input": dict(vars(cfg.Input)),
        "Output": dict(vars(cfg.Output)),
        "FeatureReg": None if reg.FeatureReg is None else dict(vars(reg.FeatureReg)),
        "OptFlowReg": None if reg.OptFlowReg is None else dict(vars(reg.OptFlowReg)),
    }


def _good():
    params = dict(NumberPyramidLevels=3, NumberIterationsPerLevel=3, TileSize=1000, Overlap=100,
                  NumberOfWorkers=0, UseFullResImage=True, UseDOG=False)
    return {
        "Input": {"InputImagePaths": {"Cycle 1": {"DAPI": "/d/c1_dapi.tif", "Cy5": "/d/c1_cy5.tif"},
                                      "Cycle 2": {"DAPI": "/d/c2_dapi.tif", "Cy5": "/d/c2_cy5.tif"}},
                  "ReferenceCycle": 1, "ReferenceChannel": "DAPI"},
        "Output": {"OutputDir": "/d/out", "OutputPrefix": "x_", "SaveOutputToCycleStack": False},
        "RegistrationParameters": {"OptFlowReg": params, "FeatureReg": dict(params, UseDOG=True)},
    }


def test_examples_present():
    assert len(EXAMPLES) == 4


@pytest.mark.parametrize("path", EXAMPLES, ids=[p.stem for p in EXAMPLES])
def test_examples_read_the_same(path):
    got = _plain(PipelineConfigReader().read_config(path))
    assert got == _plain(JReader().read_config(path))
    assert got["Input"]["PipelineInputType"] in ("CycleStack", "CycleBuilder", "CyclePerImage")


def test_dumped_config_reads_the_same(tmp_path):
    path = tmp_path / "c.yaml"
    path.write_text(yaml.dump(_good(), sort_keys=False))
    got = _plain(PipelineConfigReader().read_config(path))
    assert got == _plain(JReader().read_config(path))
    assert got["Input"]["PipelineInputType"] == "CycleBuilder"


def _set(cfg, dotted, value):
    node = cfg
    *parents, leaf = dotted.split(".")
    for k in parents:
        node = node[k]
    if value is _DROP:
        del node[leaf]
    else:
        node[leaf] = value


_DROP = object()
_BAD = [
    ("RegistrationParameters.OptFlowReg.TileSize", 5, ValueError),
    ("RegistrationParameters.OptFlowReg.Overlap", 1200, ValueError),
    ("RegistrationParameters.OptFlowReg.Overlap", 5, ValueError),
    ("RegistrationParameters.OptFlowReg.NumberPyramidLevels", 9, ValueError),
    ("RegistrationParameters.OptFlowReg.NumberIterationsPerLevel", 0, ValueError),
    ("RegistrationParameters.OptFlowReg.NumberOfWorkers", -1, ValueError),
    ("RegistrationParameters.OptFlowReg.UseDOG", "yes", TypeError),
    ("RegistrationParameters.OptFlowReg.TileSize", 1000.5, TypeError),
    ("RegistrationParameters.OptFlowReg.Overlap", _DROP, KeyError),
    ("Input.ReferenceCycle", 0, ValueError),
    ("Input.InputImagePaths", {"Cycle 1": "/d/a.tif"}, ValueError),
    ("Input.InputImagePaths", {"Round 1": "/d/a.tif", "Round 2": "/d/b.tif"}, ValueError),
    ("Output", _DROP, ValueError),
]


def _case_id(field, value) -> str:
    """A test id that is the same in every process (no object addresses)."""
    return (f"drop {field}" if value is _DROP else f"{field}={value!r}")[-60:]


@pytest.mark.parametrize("field,value,exc", _BAD, ids=[_case_id(f, v) for f, v, _ in _BAD])
def test_bad_configs_rejected_like_jax(tmp_path, field, value, exc):
    cfg = _good()
    _set(cfg, field, value)
    path = tmp_path / "bad.yaml"
    path.write_text(yaml.dump(cfg, sort_keys=False))
    with pytest.raises(exc) as jax_err:
        JReader().read_config(path)
    with pytest.raises(exc) as port_err:
        PipelineConfigReader().read_config(path)
    assert str(port_err.value) == str(jax_err.value)
