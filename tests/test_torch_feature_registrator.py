"""The port's FeatureRegistrator against the JAX package's on the same
synthetic pairs, and against the known transform.

Bars and their reasons:
* the four image corners mapped by the port's matrix lie within 0.1 px of
  those mapped by the JAX package's: the descriptors, distances and RANSAC
  draws differ in their last bits or their random stream (see
  tests/test_torch_features.py), and the final least squares averages the
  difference away;
* within 0.5 px of the truth at the corners (ROADMAP queue 1, item 10);
* the validity gates and pyramid factors exactly as the JAX package's.
"""

import cv2 as cv
import numpy as np
import pytest
import torch

from microaligner_tpu.features import FeatureRegistrator as JReg
from microaligner_tpu_torch.features import FeatureRegistrator as TReg
from microaligner_tpu_torch.features import registrator as treg
from microaligner_tpu_torch.features import tile_features as ttf

torch.set_num_threads(1)


def _textured(rng, h, w, sigma=2.0):
    img = cv.GaussianBlur(rng.random((h, w), dtype=np.float32), (0, 0), sigma)
    return cv.normalize(img, None, 0, 255, cv.NORM_MINMAX, cv.CV_8U)


def _configure(reg, ref, mov, levels, iters, use_dog=True):
    reg.num_pyr_lvl = levels
    reg.num_iterations = iters
    reg.tile_size = 500
    reg.use_full_res_img = True
    reg.use_dog = use_dog
    reg.ref_img = ref
    reg.mov_img = mov
    return reg


def _corners(shape):
    h, w = shape
    return np.array([[0, 0, 1], [w - 1, 0, 1], [0, h - 1, 1], [w - 1, h - 1, 1]], float).T


CASES = {
    # tests/test_features.py::test_registrator_recovers_rotation_translation
    "rot1.5-420x440": (420, 440, 1.5, 1.0, (8.0, -5.0), 1, 2, 0),
    # tests/test_features.py::TestHardTransforms, without noise: 460 x 480,
    # rotation and scale
    "rot3-scale1.02-460x480": (460, 480, 3.0, 1.02, (6.0, -4.0), 1, 2, 13),
}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    h, w, angle, scale, (dx, dy), levels, iters, seed = CASES[request.param]
    ref = _textured(np.random.default_rng(seed), h, w)
    fwd = cv.getRotationMatrix2D((w / 2.0, h / 2.0), angle, scale)
    fwd[0, 2] += dx
    fwd[1, 2] += dy
    mov = cv.warpAffine(ref, fwd, (w, h))
    want = _configure(JReg(), ref, mov, levels, iters).register()
    truth = np.linalg.inv(np.vstack([fwd, [0, 0, 1]]))[:2]
    return ref, mov, levels, iters, want, truth


def test_registrator_matches_jax_and_truth(case, capsys):
    ref, mov, levels, iters, want, truth = case
    reg = _configure(TReg(device="cpu"), ref, mov, levels, iters)
    got = reg.register()
    pts = _corners(ref.shape)
    assert np.abs(got @ pts - want @ pts).max() < 0.1
    assert np.abs(got @ pts - truth @ pts).max() < 0.5
    out = capsys.readouterr().out
    assert out.count("Pyramid factor") == levels + 1 and out.count("    Iteration") == (levels + 1) * iters
    # transform_img rounds and keeps the dtype
    warped = reg.transform_img(mov, got)
    inner = (slice(50, -50), slice(50, -50))
    before = np.mean((mov[inner].astype(float) - ref[inner].astype(float)) ** 2)
    after = np.mean((warped[inner].astype(float) - ref[inner].astype(float)) ** 2)
    assert warped.dtype == np.uint8 and after < 0.1 * before


def test_pyramid_factors_and_gates_match_jax():
    img = np.full((420, 900), 7, np.uint8)
    for levels, full in ((3, False), (2, True), (5, False)):
        t, j = TReg(device="cpu"), JReg()
        for reg in (t, j):
            reg.num_pyr_lvl, reg.use_full_res_img = levels, full
            reg.ref_img = img
        assert t._pyr_factors() == j._pyr_factors()
    for mat in (np.array([[5.0, 0, 0], [0, 5.0, 0]]), np.array([[0.1, 0, 0], [0, 0.1, 0]]), np.eye(2, 3),
                np.array([[0.0, 0, 3], [0, 0.0, 1]]), np.array([[1.0, 0, 500.0], [0, 1.0, 0]])):
        est = torch.from_numpy(np.vstack([mat, [0, 0, 1]]).astype(np.float32))
        assert bool(treg._valid_transform_traced(est, (100, 100))) == (
            JReg._check_if_proper_scale(mat) and JReg._check_if_inside_borders(mat, (100, 100)))


def test_too_small_for_pyramid_raises():
    img = np.full((150, 150), 128, np.uint8)
    reg = TReg(device="cpu")
    reg.num_pyr_lvl, reg.use_full_res_img = 2, False
    reg.ref_img = reg.mov_img = img
    with pytest.raises(ValueError, match="too small for any pyramid"):
        reg.register()


def _entry_point(name):
    import microaligner_tpu_torch as port
    from microaligner_tpu_torch.optflow.flow_calc import TileFlowCalc

    img = np.zeros((20, 20), np.uint8)
    calls = {
        "FeatureRegistrator": lambda: port.FeatureRegistrator().device,
        "OptFlowRegistrator": lambda: port.OptFlowRegistrator().device,
        "Warper": lambda: port.Warper().device,
        "TileFlowCalc": lambda: TileFlowCalc().device,
        "transform_img_with_tmat": lambda: port.transform_img_with_tmat(
            img, (24, 24), np.array([[1.0, 0.0, 2.0], [0.0, 1.0, 0.0]])),
        "find_features": lambda: ttf.find_features(img, 1000),
    }
    return calls[name]


@pytest.mark.parametrize("name", ["FeatureRegistrator", "OptFlowRegistrator", "Warper", "TileFlowCalc",
                                  "transform_img_with_tmat", "find_features"])
def test_entry_points_default_to_the_card(name):
    """With no device named, an entry point runs on the first CUDA device;
    without a card it raises instead of running on the CPU."""
    call = _entry_point(name)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match=r"torch.cuda.is_available\(\) is False"):
            call()
    elif name not in ("transform_img_with_tmat", "find_features"):
        assert call().type == "cuda"
