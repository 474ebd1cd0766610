"""The feature engine's alternate routes in the port against the JAX
package's same routes, on the same numpy inputs:

* the per-tile feature path (``MICROALIGNER_TPU_FEATURE_DENSE=0``) and the
  whole-level gate (``FEATURE_DENSE`` ``auto``/``1``/``0`` and
  ``FEATURE_DENSE_MAX_MPIX``);
* the host-driven FeatureReg drivers (``MICROALIGNER_TPU_FUSED_REGISTER=0``,
  ``MICROALIGNER_TPU_FUSED_LEVEL=0``).

Every variable is set with ``monkeypatch.setenv`` for both packages, and
``jax.clear_caches()`` follows each change: the JAX package reads
``FEATURE_DENSE`` while it traces.

Bars and their reasons:
* the three feature paths: coords, validity and responses equal (FAST is
  bit-exact on each), and matching recovers the translation within 0.5 px
  (JAX's ``test_three_paths_agree``, through the per-tile path);
* the per-tile path against JAX's: coords, validity and responses equal,
  descriptors within rtol 1e-4, atol 1e-5 (tests/test_torch_features.py's
  DAISY bar: float32 sums in other orders);
* the drivers against the port's whole route: the linear part within 1e-4
  and the translation within 0.05 px, the JAX package's bars for its own
  drivers (tests/test_features.py::test_fused_register_matches_legacy_driver,
  on that test's pair); against the JAX package's same driver, the four
  corners within 0.1 px (tests/test_torch_feature_registrator.py: RANSAC
  draws from another random stream).
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

from microaligner_tpu.features import FeatureRegistrator as JReg
from microaligner_tpu.features import tile_features as jtf
from microaligner_tpu.tiles import TileGrid as JGrid
from microaligner_tpu_torch.features import FeatureRegistrator as TReg
from microaligner_tpu_torch.features import tile_features as ttf
from microaligner_tpu_torch.tiles import TileGrid

torch.set_num_threads(1)

DRIVER_VARIABLES = ("FUSED_REGISTER", "FUSED_LEVEL", "FEATURE_DENSE", "FEATURE_DENSE_MAX_MPIX")


def _textured(rng, h, w, sigma):
    img = cv.GaussianBlur(rng.random((h, w), dtype=np.float32), (0, 0), sigma)
    return cv.normalize(img, None, 0, 255, cv.NORM_MINMAX, cv.CV_8U)


def _seeded(nodeid: str):
    """The rng that tests/conftest.py's ``rng`` fixture gives ``nodeid``:
    a mirrored JAX test's own inputs."""
    return np.random.default_rng(zlib.crc32(nodeid.encode()))


def _set(monkeypatch, **env):
    for name in DRIVER_VARIABLES:
        monkeypatch.delenv(f"MICROALIGNER_TPU_{name}", raising=False)
    for name, value in env.items():
        monkeypatch.setenv(f"MICROALIGNER_TPU_{name}", value)
    jax.clear_caches()


@pytest.fixture(autouse=True)
def _fresh_traces():
    yield
    jax.clear_caches()  # no later test may reuse a trace made under this test's variables


PATHS = {"dense": dict(FEATURE_DENSE="1"), "per-tile": dict(FEATURE_DENSE="0"),
         "banded": dict(FEATURE_DENSE="auto", FEATURE_DENSE_MAX_MPIX="0.0001")}


def test_three_paths_agree(monkeypatch):
    """JAX's ``test_three_paths_agree`` in the port, on that test's inputs:
    the three paths' keypoints agree, and matching through the per-tile
    path recovers the translation."""
    img = _textured(_seeded("tests/test_features.py::TestFeaturePathDispatch::test_three_paths_agree"),
                    300, 320, 1.5)
    mov = cv.warpAffine(img, np.float32([[1, 0, 5.0], [0, 1, -3.0]]), (320, 300))
    feats = {}
    for name, env in PATHS.items():
        _set(monkeypatch, **env)
        feats[name] = (ttf.find_features(img, 128, device="cpu"), ttf.find_features(mov, 128, device="cpu"))
    dense = feats["dense"][0]
    for name in ("per-tile", "banded"):
        f = feats[name][0]
        for attr in ("valid", "coords", "responses"):
            np.testing.assert_array_equal(getattr(f, attr).numpy(), getattr(dense, attr).numpy())
    # through the per-tile path (a knn over 45k x 45k slots takes about 45 s a
    # match on one CPU thread; the other two paths' matching is tested in
    # tests/test_torch_features.py and tests/test_torch_feature_registrator.py)
    fr, fm = feats["per-tile"]
    np.testing.assert_allclose(ttf.match_features(fr, fm)[:, 2], [-5.0, 3.0], atol=0.5)


def test_per_tile_path_matches_jax():
    img = _textured(np.random.default_rng(5), 150, 170, 1.5)
    grid, jgrid = TileGrid.for_image(img.shape, 64, 51), JGrid.for_image(img.shape, 64, 51)
    k = 60
    got = ttf._find_features_per_tile(torch.from_numpy(img), grid, k, True)
    # the JAX tile map runs inside a trace, over no mesh
    want = jax.jit(jtf._find_features_per_tile, static_argnums=(1, 2, 3, 4))(jnp.asarray(img), jgrid, k, None, True)
    for i in (0, 2, 3):  # coords, valid, responses
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-4, atol=1e-5)
    assert int(got[2].sum()) > 0


@pytest.mark.parametrize("env", [{}, dict(FEATURE_DENSE="0"), dict(FEATURE_DENSE="1"),
                                 dict(FEATURE_DENSE_MAX_MPIX="0.05"), dict(FEATURE_DENSE_MAX_MPIX="0.07"),
                                 dict(FEATURE_DENSE="auto", FEATURE_DENSE_MAX_MPIX="1e-9")],
                         ids=["default", "0", "1", "max-0.05", "max-0.07", "auto-tiny"])
def test_dense_gate_matches_jax(env, monkeypatch):
    _set(monkeypatch, **env)
    for shape, tile in (((240, 250), 128), ((20480, 20480), 1000), ((5000, 5200), 1000)):
        grid, jgrid = TileGrid.for_image(shape, tile, 51), JGrid.for_image(shape, tile, 51)
        assert ttf._dense_level_enabled(grid) == jtf._dense_level_enabled(jgrid)
        assert ttf._per_tile_forced() == jtf._per_tile_forced()


# -- the host-driven FeatureReg drivers -----------------------------------------

def _corners(shape):
    h, w = shape
    return np.array([[0, 0, 1], [w - 1, 0, 1], [0, h - 1, 1], [w - 1, h - 1, 1]], float).T


def _configure(reg, ref, mov):
    reg.num_pyr_lvl, reg.num_iterations, reg.tile_size = 2, 2, 500
    reg.use_full_res_img = True
    reg.ref_img, reg.mov_img = ref, mov
    return reg


@pytest.fixture(scope="module")
def legacy_pair():
    """tests/test_features.py::test_fused_register_matches_legacy_driver's
    pair and the port's whole-route matrix on it."""
    rng = _seeded("tests/test_features.py::TestEndToEnd::test_fused_register_matches_legacy_driver")
    ref = _textured(rng, 420, 440, 2.0)
    fwd = cv.getRotationMatrix2D((220.0, 210.0), 1.0, 1.0)
    fwd[0, 2] += 6.0
    fwd[1, 2] -= 4.0
    mov = cv.warpAffine(ref, fwd, (440, 420))
    with pytest.MonkeyPatch.context() as mp:
        _set(mp)
        whole = _configure(TReg(device="cpu"), ref, mov).register()
    return ref, mov, whole


@pytest.mark.parametrize("variable", ["FUSED_REGISTER", "FUSED_LEVEL"])
def test_host_driver_matches_whole_and_jax(variable, legacy_pair, monkeypatch):
    ref, mov, whole = legacy_pair
    _set(monkeypatch, **{variable: "0"})
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        got = _configure(TReg(device="cpu"), ref, mov).register()
    log = buf.getvalue()
    assert log.count("Pyramid factor") == 3 and log.count("    Iteration") == 6
    np.testing.assert_allclose(got[:, :2], whole[:, :2], atol=1e-4)
    np.testing.assert_allclose(got[:, 2], whole[:, 2], atol=0.05)
    with contextlib.redirect_stdout(io.StringIO()):
        want = _configure(JReg(), ref, mov).register()
    pts = _corners(ref.shape)
    assert np.abs(got @ pts - want @ pts).max() < 0.1


def test_host_driver_without_reference_features(monkeypatch):
    """A blank reference has no features: the per-level driver logs why, as
    the JAX package does, and returns the identity."""
    ref = np.zeros((220, 230), np.uint8)
    mov = _textured(np.random.default_rng(3), 220, 230, 2.0)
    _set(monkeypatch, FUSED_REGISTER="0")
    logs, mats = [], []
    for reg in (TReg(device="cpu"), JReg()):
        reg.num_pyr_lvl, reg.num_iterations, reg.tile_size, reg.use_full_res_img = 1, 2, 500, False
        reg.ref_img, reg.mov_img = ref, mov
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            mats.append(reg.register())
        logs.append(buf.getvalue())
    assert logs[0] == logs[1]
    assert "No usable reference features" in logs[0]
    np.testing.assert_array_equal(mats[0], np.eye(2, 3))
    np.testing.assert_array_equal(mats[1], np.eye(2, 3))


def test_host_helpers_match_jax():
    mats = [np.array([[1.01, -0.02, 3.5], [0.02, 1.01, -2.25]]), np.array([[0.99, 0.01, -1.0], [-0.01, 0.99, 0.5]])]
    np.testing.assert_array_equal(TReg._multiply_transform_matrices(mats), JReg._multiply_transform_matrices(mats))
    np.testing.assert_array_equal(TReg._rescale_t_mat(mats[0], 0.25), JReg._rescale_t_mat(mats[0], 0.25))
    t, j = TReg(device="cpu"), JReg()
    for mat in (mats[0], np.array([[5.0, 0, 0], [0, 5.0, 0]]), np.array([[1.0, 0, 500.0], [0, 1.0, 0]])):
        assert t._check_if_valid_transform(mat, (100, 100)) == j._check_if_valid_transform(mat, (100, 100))
    img = _textured(np.random.default_rng(4), 250, 230, 2.0)
    pyr, factors = t._generate_img_pyr(torch.from_numpy(img))
    jpyr, jfactors = j._generate_img_pyr(img)
    assert factors == jfactors == [2]
    for a, b in zip(pyr, jpyr):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
