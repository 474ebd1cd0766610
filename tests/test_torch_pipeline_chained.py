"""The FeatureReg and chained halves of the CLI: configs through the JAX
package's ``run_pipeline`` and through the port's ``main([cfg],
device="cpu")`` on the same files (the 240 x 250 topologies of
tests/test_pipeline_topologies.py and tests/test_auto_fallback.py).

Bars and their reasons:
* the same output file names and OME-XML, byte for byte (the port's OME
  and TIFF code is a copy of the JAX package's);
* ``feature_reg_parameters.csv``: the same header, names, padding and
  sizes; the matrices map the image corners within 0.1 px of the JAX
  package's (see tests/test_torch_feature_registrator.py);
* reference-cycle planes bit for bit;
* registered planes: interior MSE to the reference below 25% of the
  unregistered MSE after FeatureReg (which cannot undo the data's small
  elastic part) and below 5% after OptFlowReg.  They are not compared
  pixel by pixel with the JAX
  CLI's: a 0.05 px difference in the matrix moves a u16 texture by
  hundreds of levels;
* the affine apply alone, with one matrix for both packages: within one
  u16 level at >= 99.9% of pixels (truncation after another last bit).
"""

import csv

import cv2 as cv
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from microaligner_tpu.io import MemmapWriter
from microaligner_tpu.pipeline import runner as jrunner
from microaligner_tpu.pipeline.config import PipelineConfigReader as JReader
from microaligner_tpu_torch.__main__ import main
from microaligner_tpu_torch.io import TiffFile
from microaligner_tpu_torch.pipeline import runner as trunner

from test_pipeline_topologies import _ome

torch.set_num_threads(1)

H, W = 240, 250
INNER = (slice(30, -30), slice(30, -30))
FWD = np.float32([[1, 0, 5.0], [0, 1, -3.0]])


def _params(use_dog):
    return dict(NumberPyramidLevels=1, NumberIterationsPerLevel=2, TileSize=300, Overlap=50,
                NumberOfWorkers=0, UseFullResImage=True, UseDOG=use_dog)


def _write_ome(path, planes, channels):
    h, w = planes[0].shape
    mm = MemmapWriter(path, (1, len(planes), 1, h, w), np.uint16,
                      description=_ome(len(planes), 1, h, w, channels))
    for i, img in enumerate(planes):
        mm[0, i, 0] = img
    mm.close()


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("chained")
    rng = np.random.default_rng(7)
    base = cv.GaussianBlur(rng.random((H, W), dtype=np.float32), (0, 0), 2.0)
    base = cv.normalize(base, None, 0, 50000, cv.NORM_MINMAX, cv.CV_16U)
    other = (base * 0.6).astype(np.uint16)
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    elastic = lambda im: cv.remap(im, xs + 1.2 * np.sin(ys / 40), ys + 0.8 * np.cos(xs / 45),
                                  cv.INTER_LINEAR)
    shifted = lambda im: elastic(cv.warpAffine(im.astype(np.float32), FWD, (W, H)).astype(np.uint16))
    sbase, sother = shifted(base), shifted(other)
    _write_ome(d / "stack.ome.tif", [base, other, sbase, sother],
               ("c01 DAPI", "c01 Cy5", "c02 DAPI", "c02 Cy5"))
    paths = {}
    for name, img in [("c1_dapi", base), ("c1_cy5", other), ("c2_dapi", sbase), ("c2_cy5", sother)]:
        paths[name] = d / f"{name}.tif"
        cv.imwrite(str(paths[name]), img)  # plain (LZW) TIFF, no OME
    _write_ome(d / "c1.ome.tif", [base], ("DAPI",))
    _write_ome(d / "c2_small.ome.tif", [base[:220, :230].copy()], ("DAPI",))
    return d, base, other, sbase, paths


def _config(inputs, out_dir, stack_out, feature=True, optflow=True, prefix=""):
    reg = {}
    if feature:
        reg["FeatureReg"] = _params(True)
    if optflow:
        reg["OptFlowReg"] = _params(False)
    return {
        "Input": {"InputImagePaths": inputs, "ReferenceCycle": 1, "ReferenceChannel": "DAPI"},
        "Output": {"OutputDir": str(out_dir), "OutputPrefix": prefix, "SaveOutputToCycleStack": stack_out},
        "RegistrationParameters": reg,
    }


def _both(tmp, cfg):
    """Run ``cfg`` through the JAX CLI and the port's; return both output dirs."""
    dirs = []
    for name in ("jax", "port"):
        out = tmp / name
        path = tmp / f"{name}.yaml"
        path.write_text(yaml.dump(dict(cfg, Output=dict(cfg["Output"], OutputDir=str(out))),
                                  sort_keys=False))
        if name == "jax":
            jrunner.run_pipeline(JReader().read_config(path))
        else:
            main([str(path)], device="cpu")
        dirs.append(out)
    return dirs


def _pages(path):
    with TiffFile(path) as tf:
        return tf.ome_metadata, tf.series[0].shape, [tf.read_page(i) for i in range(len(tf.pages))]


def _csv(path):
    with open(path, newline="") as fh:
        return list(csv.reader(fh))


def _check_csv(port_dir, jax_dir, shape=(H, W)):
    got, want = _csv(port_dir / "feature_reg_parameters.csv"), _csv(jax_dir / "feature_reg_parameters.csv")
    assert got[0] == want[0] and len(got) == len(want)
    h, w = shape
    corners = np.array([[0, 0, 1], [w - 1, 0, 1], [0, h - 1, 1], [w - 1, h - 1, 1]], float).T
    for g, wv in zip(got[1:], want[1:]):
        assert g[0] == wv[0] and g[7:] == wv[7:]  # name, padding, size
        gm = np.array(g[1:7], float).reshape(2, 3)
        wm = np.array(wv[1:7], float).reshape(2, 3)
        assert np.abs(gm @ corners - wm @ corners).max() < 0.1


def _aligned(plane, ref):
    """Interior MSE of ``plane`` to ``ref``."""
    return float(np.mean((plane[INNER].astype(float) - ref[INNER].astype(float)) ** 2))


@pytest.fixture(scope="module")
def chained(data, tmp_path_factory):
    d, *_ = data
    tmp = tmp_path_factory.mktemp("stack_chained")
    return _both(tmp, _config({"CycleStack": str(d / "stack.ome.tif")}, None, True))


def test_chained_stack_files_ome_and_csv(chained):
    jax_dir, port_dir = chained
    names = sorted(p.name for p in port_dir.iterdir())
    assert names == sorted(p.name for p in jax_dir.iterdir()) == [
        "feature_reg_parameters.csv", "feature_reg_result_stack.tif", "optflow_reg_result_stack.tif"]
    for f in names[1:]:
        got, want = _pages(port_dir / f), _pages(jax_dir / f)
        assert got[0] == want[0] and got[1] == want[1] == (4, H, W)
    _check_csv(port_dir, jax_dir)


def test_chained_stack_planes(chained, data):
    jax_dir, port_dir = chained
    _, base, other, sbase, _ = data
    unregistered = _aligned(sbase, base)
    for f, bar in (("feature_reg_result_stack.tif", 0.25), ("optflow_reg_result_stack.tif", 0.05)):
        _, _, pages = _pages(port_dir / f)
        np.testing.assert_array_equal(pages[0], base)
        np.testing.assert_array_equal(pages[1], other)
        assert _aligned(pages[2], base) < bar * unregistered, f
    # the flow stage improves on the affine stage (the data has an elastic part)
    feat = _pages(port_dir / "feature_reg_result_stack.tif")[2][2]
    flow = _pages(port_dir / "optflow_reg_result_stack.tif")[2][2]
    assert _aligned(flow, base) < 0.5 * _aligned(feat, base)


def test_feature_reg_only_builder_in_split_out(data, tmp_path):
    """FeatureReg alone, one plain TIFF per cycle and channel in, one file
    per cycle out (tests/test_pipeline_topologies.py's topologies)."""
    d, base, other, sbase, paths = data
    builder = {"Cycle 1": {"DAPI": str(paths["c1_dapi"]), "Cy5": str(paths["c1_cy5"])},
               "Cycle 2": {"DAPI": str(paths["c2_dapi"]), "Cy5": str(paths["c2_cy5"])}}
    out = tmp_path / "port"
    cfg = _config(builder, out, False, optflow=False, prefix="b_")
    (tmp_path / "c.yaml").write_text(yaml.dump(cfg, sort_keys=False))
    main([str(tmp_path / "c.yaml")], device="cpu")
    assert sorted(p.name for p in out.iterdir()) == [
        "b_feature_reg_result_cyc001.tif", "b_feature_reg_result_cyc002.tif", "feature_reg_parameters.csv"]
    ome1, shape1, pages1 = _pages(out / "b_feature_reg_result_cyc001.tif")
    assert shape1 == (2, H, W) and 'SizeC="2"' in ome1
    np.testing.assert_array_equal(pages1[0], base)
    _, _, pages2 = _pages(out / "b_feature_reg_result_cyc002.tif")
    assert _aligned(pages2[0], base) < 0.25 * _aligned(sbase, base)
    rows = _csv(out / "feature_reg_parameters.csv")
    assert [r[0] for r in rows[1:]] == ["Cycle 1", "Cycle 2"]
    assert rows[1][1:7] == ["1.0", "0.0", "0.0", "0.0", "1.0", "0.0"]
    assert rows[2][7:] == ["0", "0", "0", "0", str(W), str(H)]


def test_auto_feature_reg_for_unequal_sizes(data, tmp_path, capsys):
    """OptFlowReg alone over per-cycle inputs of unequal size: both CLIs run
    FeatureReg first, with the OptFlowReg parameters."""
    d, *_ = data
    cfg = _config({"Cycle 1": str(d / "c1.ome.tif"), "Cycle 2": str(d / "c2_small.ome.tif")}, None, True,
                  feature=False)
    jax_dir, port_dir = _both(tmp_path, cfg)
    assert capsys.readouterr().out.count("Will try to perform FeatureReg first") == 2
    names = sorted(p.name for p in port_dir.iterdir())
    assert names == sorted(p.name for p in jax_dir.iterdir()) == [
        "feature_reg_parameters.csv", "feature_reg_result_stack.tif", "optflow_reg_result_stack.tif"]
    for f in names[1:]:
        got, want = _pages(port_dir / f), _pages(jax_dir / f)
        assert got[0] == want[0] and got[1] == want[1] == (2, H, W)
        np.testing.assert_array_equal(got[2][0], want[2][0])  # the reference cycle
    _check_csv(port_dir, jax_dir)


@pytest.mark.parametrize("t_mat", [[[1.0006, 0.0004, -5.1], [-0.0004, 1.0006, 3.2]],
                                   [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]])
def test_apply_affine_plane_matches_jax(data, t_mat):
    _, base, *_ = data
    small = base[:230, :244].copy()
    tmat = np.array(t_mat)
    inv = np.linalg.pinv(np.vstack([tmat, [0, 0, 1]]))[:2]
    warp = not np.array_equal(tmat, np.eye(2, 3))
    got = trunner._apply_affine_plane(torch.from_numpy(small), inv, H, W, torch.uint16, warp).numpy()
    want = np.asarray(jrunner._apply_affine_plane(jnp.asarray(small), inv, H, W, "uint16", warp))
    assert got.dtype == want.dtype == np.uint16 and got.shape == (H, W)
    diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert (diff <= 1).mean() >= 0.999 and (diff.max() <= 1 if warp else diff.max() == 0)
