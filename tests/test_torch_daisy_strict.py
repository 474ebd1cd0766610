"""The reference's raw DAISY descriptors (``MICROALIGNER_TPU_DAISY_NRM=0``,
cv2's ``NRM_NONE``) through the port's feature layer, against the JAX
package on the same numpy inputs:

* (a) each feature path (whole level, banded, per tile) against JAX's
  ``_find_features_tiled``;
* (b) the mirror of tests/test_features.py::test_register_strict_parity_norm
  on its pair, both modes and both DoG settings;
* (c) the host FeatureReg drivers (``FUSED_REGISTER=0``, ``FUSED_LEVEL=0``);
* (d) a small chained CLI;
* (e) ``match_descriptors`` on raw-magnitude descriptors.

The variables are set with ``monkeypatch.setenv`` for both packages, and
``jax.clear_caches()`` follows each change of their values: the JAX
package reads them while it traces; the port reads them on each call.

Bars and their reasons:
* keypoints: coords, validity and responses equal (FAST is bit-exact);
  descriptors within rtol 1e-4, atol 1e-5 (tests/test_torch_features.py's
  DAISY bar: float32 sums in other orders);
* matrices: the four corners within 0.1 px of the JAX package's (RANSAC
  draws from another random stream, tests/test_torch_feature_registrator.py);
  with DoG in strict mode the JAX package's gate rejects every round, and
  the port's must too: the identity on both sides;
* the host drivers against the port's whole route: the linear part within
  1e-4 and the translation within 0.05 px, the JAX package's bars for its
  own drivers;
* near-ties: every ratio test and nearest index equals a float64 golden.
"""

import contextlib
import io
import zlib

import cv2 as cv
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from microaligner_tpu.features import FeatureRegistrator as JReg
from microaligner_tpu.features import tile_features as jtf
from microaligner_tpu.pipeline import runner as jrunner
from microaligner_tpu.pipeline.config import PipelineConfigReader as JReader
from microaligner_tpu.tiles import TileGrid as JGrid
from microaligner_tpu_torch.__main__ import main
from microaligner_tpu_torch.features import FeatureRegistrator as TReg
from microaligner_tpu_torch.features import match as tmatch
from microaligner_tpu_torch.features import tile_features as ttf
from microaligner_tpu_torch.tiles import TileGrid

from test_torch_pipeline_chained import _check_csv, _config, data  # noqa: F401 (a fixture)

torch.set_num_threads(1)

VARIABLES = ("DAISY_NRM", "FUSED_REGISTER", "FUSED_LEVEL", "FEATURE_DENSE", "FEATURE_DENSE_MAX_MPIX")


_traced_under = {}  # the variables the JAX package's cached traces were made under


def _set(monkeypatch, **env):
    for name in VARIABLES:
        monkeypatch.delenv(f"MICROALIGNER_TPU_{name}", raising=False)
    for name, value in env.items():
        monkeypatch.setenv(f"MICROALIGNER_TPU_{name}", value)
    if env != _traced_under:
        jax.clear_caches()
        _traced_under.clear()
        _traced_under.update(env)


@pytest.fixture(scope="module", autouse=True)
def _fresh_traces():
    yield
    jax.clear_caches()  # no later test may reuse a trace made under this file's variables
    _traced_under.clear()


def _textured(rng, h, w, sigma):
    img = cv.GaussianBlur(rng.random((h, w), dtype=np.float32), (0, 0), sigma)
    return cv.normalize(img, None, 0, 255, cv.NORM_MINMAX, cv.CV_8U)


def _corners(shape):
    h, w = shape
    return np.array([[0, 0, 1], [w - 1, 0, 1], [0, h - 1, 1], [w - 1, h - 1, 1]], float).T


# -- (a) the three feature paths ------------------------------------------------

PATHS = {"whole": dict(FEATURE_DENSE="1"), "banded": dict(FEATURE_DENSE="auto", FEATURE_DENSE_MAX_MPIX="0.0001"),
         "per-tile": dict(FEATURE_DENSE="0")}


@pytest.mark.parametrize("path", list(PATHS))
def test_feature_path_matches_jax(path, monkeypatch):
    img = _textured(np.random.default_rng(5), 150, 170, 1.5)
    grid, jgrid = TileGrid.for_image(img.shape, 64, 51), JGrid.for_image(img.shape, 64, 51)
    k = 60
    _set(monkeypatch, DAISY_NRM="0", **PATHS[path])
    got = ttf.find_features_tiled(torch.from_numpy(img), grid, k)
    want = jtf._find_features_tiled(jnp.asarray(img), jgrid, k)
    for i in (0, 2, 3):  # coords, valid, responses
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-4, atol=1e-5)
    valid = got[2].numpy()
    norms = np.linalg.norm(got[1].numpy()[valid], axis=1)
    assert valid.sum() > 0 and norms.max() > 2.0  # raw: far from unit length
    # the port reads the variable on each call: no cache to clear
    _set(monkeypatch, DAISY_NRM="1", **PATHS[path])
    unit = ttf.find_features_tiled(torch.from_numpy(img), grid, k)[1].numpy()[valid]
    np.testing.assert_allclose(np.linalg.norm(unit, axis=1), 1.0, atol=1e-5)


# -- (b) the mirror of test_register_strict_parity_norm -------------------------

@pytest.fixture(scope="module")
def strict_pair():
    """tests/test_features.py::test_register_strict_parity_norm's pair and
    the matrix that undoes its warp."""
    rng = np.random.default_rng(zlib.crc32(b"tests/test_features.py::TestEndToEnd::test_register_strict_parity_norm"))
    ref = _textured(rng, 420, 440, 2.0)
    fwd = cv.getRotationMatrix2D((220.0, 210.0), 1.0, 1.0)
    fwd[0, 2] += 6.0
    fwd[1, 2] -= 4.0
    mov = cv.warpAffine(ref, fwd, (440, 420))
    return ref, mov, np.linalg.inv(np.vstack([fwd, [0, 0, 1]]))[:2]


def _register(cls, ref, mov, use_dog, full_res=True, **kw):
    """That test's registration: 1 level and the full resolution, 2
    iterations, tile 500; without ``full_res``, the level alone."""
    reg = cls(**kw)
    reg.num_pyr_lvl, reg.num_iterations, reg.tile_size, reg.use_full_res_img = 1, 2, 500, full_res
    reg.use_dog = use_dog
    reg.ref_img, reg.mov_img = ref, mov
    with contextlib.redirect_stdout(io.StringIO()):
        return reg.register()


_port_runs = {}


def _port_whole(strict_pair, nrm, use_dog, full_res=True):
    """The port's whole route under ``DAISY_NRM=nrm``, once a file."""
    key = nrm, use_dog, full_res
    if key not in _port_runs:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("MICROALIGNER_TPU_DAISY_NRM", nrm)
            _port_runs[key] = _register(TReg, *strict_pair[:2], use_dog, full_res, device="cpu")
    return _port_runs[key]


# one mode after the other, so that the JAX package traces each mode once
@pytest.mark.parametrize("nrm,use_dog", [("0", False), ("0", True), ("1", False), ("1", True)],
                         ids=["strict-no-dog", "strict-dog", "unit-norm-no-dog", "unit-norm-dog"])
def test_register_strict_parity_norm(nrm, use_dog, strict_pair, monkeypatch):
    ref, mov, expect = strict_pair
    _set(monkeypatch, DAISY_NRM=nrm)
    got = _port_whole(strict_pair, nrm, use_dog)
    want = _register(JReg, ref, mov, use_dog)
    pts = _corners(ref.shape)
    assert np.abs(got @ pts - want @ pts).max() < 0.1
    if nrm == "0" and use_dog:
        # DoG's min-max rescale moves raw descriptor magnitudes between the
        # pair: the ratio test collapses and the gate rejects every round
        assert np.abs(want - np.eye(2, 3)).max() < 1e-6
        np.testing.assert_array_equal(got, np.eye(2, 3))
    else:
        assert np.abs(got @ pts - expect @ pts).max() < 0.5


# -- (c) the host drivers -------------------------------------------------------

@pytest.mark.parametrize("variable", ["FUSED_REGISTER", "FUSED_LEVEL"])
def test_host_driver_strict(variable, strict_pair, monkeypatch):
    """The drivers on the pair's half-resolution level, without DoG."""
    ref, mov, _ = strict_pair
    strict_whole = _port_whole(strict_pair, "0", False, full_res=False)
    _set(monkeypatch, DAISY_NRM="0", **{variable: "0"})
    got = _register(TReg, ref, mov, False, full_res=False, device="cpu")
    np.testing.assert_allclose(got[:, :2], strict_whole[:, :2], atol=1e-4)
    np.testing.assert_allclose(got[:, 2], strict_whole[:, 2], atol=0.05)
    want = _register(JReg, ref, mov, False, full_res=False)
    pts = _corners(ref.shape)
    assert np.abs(got @ pts - want @ pts).max() < 0.1


def test_reference_features_follow_the_mode(strict_pair, monkeypatch):
    """Reference features cached under one mode are found again under the
    other: ``register(reuse_ref_img=True)`` never matches across modes."""
    ref, mov, _ = strict_pair
    reg = TReg(device="cpu")
    reg.num_pyr_lvl, reg.num_iterations, reg.tile_size, reg.use_full_res_img, reg.use_dog = 1, 1, 500, False, False
    reg.ref_img, reg.mov_img = ref, mov
    _set(monkeypatch, DAISY_NRM="1")
    with contextlib.redirect_stdout(io.StringIO()):
        reg.register()
        unit = reg._ref_pyr_features[0].descriptors
        _set(monkeypatch, DAISY_NRM="0")
        reg.register(reuse_ref_img=True)
    raw = reg._ref_pyr_features[0]
    assert raw.descriptors is not unit
    assert float(torch.linalg.vector_norm(raw.descriptors[raw.valid], dim=1).max()) > 2.0


# -- (d) the chained CLI --------------------------------------------------------

def test_chained_cli_strict(data, tmp_path, monkeypatch):  # noqa: F811
    """tests/test_torch_pipeline_chained.py's CycleStack through both CLIs
    under ``DAISY_NRM=0``: the CSV's matrices within 0.1 px of the JAX
    CLI's."""
    d, *_ = data
    _set(monkeypatch, DAISY_NRM="0")
    cfg = _config({"CycleStack": str(d / "stack.ome.tif")}, None, True)
    dirs = []
    for name in ("jax", "port"):
        path = tmp_path / f"{name}.yaml"
        path.write_text(yaml.dump(dict(cfg, Output=dict(cfg["Output"], OutputDir=str(tmp_path / name))),
                                  sort_keys=False))
        with contextlib.redirect_stdout(io.StringIO()):
            if name == "jax":
                jrunner.run_pipeline(JReader().read_config(path))
            else:
                main([str(path)], device="cpu")
        dirs.append(tmp_path / name)
    _check_csv(dirs[1], dirs[0])


# -- (e) near-ties of raw-magnitude descriptors ---------------------------------

def test_near_ties_of_raw_descriptors_decided_in_float64():
    """400 queries planted with d1 = 0.25 d2 (1 + e), |e| ~ 1e-7, at norms
    spread over three decades (as raw DAISY descriptors are), beside train
    rows a hundred times longer: every ratio test and nearest index equals a
    float64 golden on the same float32 descriptors, more than 256 queries
    being near-ties in one call."""
    rng = np.random.default_rng(17)
    n, d = 400, 200
    eps = rng.uniform(-3e-7, 3e-7, n)
    scale = np.exp(rng.uniform(np.log(0.05), np.log(50.0), n))
    # each query, its nearest and its runner-up: an orthonormal triple about
    # an offset of length 10, far from every other query's rows
    frames = np.linalg.qr(rng.standard_normal((n, d, 3)))[0]  # (n, d, 3)
    offset = rng.standard_normal((n, d))
    offset *= 10.0 / np.linalg.norm(offset, axis=1, keepdims=True)
    query = (offset + frames[..., 0]) * scale[:, None]
    near = (offset + frames[..., 1] * np.sqrt(1.0 + 2.0 * eps)[:, None]) * scale[:, None]  # d1 = 2 s^2 (1 + e)
    far = (offset + frames[..., 2] * np.sqrt(7.0)) * scale[:, None]  # d2 = 8 s^2
    long_rows = 5000.0 * rng.random((20, d))
    train = np.concatenate([near, far, long_rows]).astype(np.float32)
    query = query.astype(np.float32)
    qv, tv = np.ones(n, bool), np.ones(len(train), bool)
    calls, rows = tmatch.near_ties["calls"], tmatch.near_ties["rows"]
    good, idx = tmatch.match_descriptors(*(torch.from_numpy(a) for a in (train, query, tv, qv)))
    t64 = train.astype(np.float64)
    dist = np.stack([((t64 - q) ** 2).sum(-1) for q in query.astype(np.float64)])
    order = np.argsort(dist, axis=1)
    d1, d2 = np.take_along_axis(dist, order[:, :2], axis=1).T
    np.testing.assert_array_equal(good.numpy(), d1 < 0.25 * d2)
    assert 0 < good.numpy().sum() < n  # both sides of the threshold were planted
    np.testing.assert_array_equal(idx.numpy(), order[:, 0])
    assert tmatch.near_ties["calls"] == calls + 1 and tmatch.near_ties["rows"] - rows >= n
