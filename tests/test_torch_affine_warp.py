"""The port's affine warps (``ops/affine_tiled.py`` and ``ops/warp.py``:
K1 one band of rows at a time) against the JAX package's exact gather,
tiled path and traced path, and cv2, with the bars of
tests/test_affine_tiled.py; ``transform_img_with_tmat`` and the reference
tiling API (``tiles/compat.py``) against the JAX package.

Bars and their reasons:
* against the JAX exact gather: max < 0.05 and MSE < 1e-6 on a 0-255
  image (both sample the same coordinates; the JAX gather adds the
  displacement to absolute float32 coordinates, the port keeps it apart);
* against cv2: interior MSE < 1e-3 (cv2 quantizes coordinates to 1/32 px);
* the traced (device-matrix) warp against the host one: 255e-4 (a float32
  adjugate inverse against a float64 pinv);
* ``transform_img_with_tmat``: u16 planes within one level of the JAX
  package's at >= 99.9% of pixels (truncation after another last bit can
  step one level); the identity path bit for bit;
* bands: any band height gives the same planes within 1e-3 on 0-255 (each
  band rounds its own float32 constant of the displacement).
"""

import cv2 as cv
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from microaligner_tpu.ops import affine_tiled as jat
from microaligner_tpu.ops import warp as jw
from microaligner_tpu.tiles import compat as jcompat
from microaligner_tpu_torch.ops import affine_tiled as tat
from microaligner_tpu_torch.ops import kernel_sample
from microaligner_tpu_torch.ops import warp as tw
from microaligner_tpu_torch.tiles import compat as tcompat

torch.set_num_threads(1)


def _textured(rng, h, w, sigma=2.0):
    img = cv.GaussianBlur(rng.random((h, w), dtype=np.float32), (0, 0), sigma)
    return cv.normalize(img, None, 0, 255, cv.NORM_MINMAX).astype(np.float32)


def _exact(img, t_mat, out_shape=None):
    inv = tw.inverse_of(t_mat)
    h, w = out_shape or img.shape
    return np.asarray(jw._affine_warp_core(jnp.asarray(img), jnp.asarray(inv, jnp.float32), h, w))


@pytest.mark.parametrize("t_mat", [
    [[1.0, 0.0, 17.0], [0.0, 1.0, -23.0]],  # pure translation
    [[1.002, 0.0008, -6.4], [-0.0008, 1.002, 9.1]],  # similarity
    [[0.998, -0.0012, 140.2], [0.0012, 0.998, -77.5]],  # big translation
    [[0.966, -0.259, 40.0], [0.259, 0.966, -30.0]],  # 15 degrees: outside JAX's band contract
    [[1.0, 0.0, 300.0], [0.0, 1.0, -210.0]],  # pulls zeros into the frame
])
def test_affine_warp_matches_jax_exact_gather(rng, t_mat):
    img = _textured(rng, 300, 340)
    got = tw.affine_warp(torch.from_numpy(img), np.array(t_mat)).numpy()
    want = _exact(img, np.array(t_mat))
    assert np.abs(got - want).max() < 0.05
    assert float(np.mean((got - want) ** 2)) < 1e-6


def test_affine_warp_matches_jax_tiled_path_and_cv2(rng):
    h, w = 600, 640
    img = _textured(rng, h, w)
    t_mat = np.array([[1.001, 0.0006, 8.25], [-0.0006, 1.001, -15.75]])
    got = tw.affine_warp(torch.from_numpy(img), t_mat).numpy()
    tiled = np.asarray(jat.affine_warp_tiled(jnp.asarray(img), tw.inverse_of(t_mat), h, w))
    assert np.abs(got - tiled).max() < 0.05
    theirs = cv.warpAffine(img, t_mat.astype(np.float32), (w, h))
    assert float(np.mean((got[8:-8, 8:-8] - theirs[8:-8, 8:-8]) ** 2)) < 1e-3


def test_affine_warp_dsize_and_bands(rng):
    img = _textured(rng, 90, 110)
    t_mat = np.array([[1.01, 0.02, 3.3], [-0.02, 0.99, -4.7]])
    inv = tw.inverse_of(t_mat)
    src = torch.from_numpy(img)
    whole = tat.affine_warp_bands(src, inv, 120, 100)
    for rows in (1, 7, 64):
        assert float((tat.affine_warp_bands(src, inv, 120, 100, band_rows=rows) - whole).abs().max()) < 1e-3
    want = _exact(img, t_mat, (120, 100))
    assert np.abs(whole.numpy() - want).max() < 0.05
    # the window form of K1 is a slice of the whole-plane sampling
    fx = torch.from_numpy(rng.normal(0, 3, (1, 90, 110)).astype(np.float32))
    fy = torch.from_numpy(rng.normal(0, 3, (1, 90, 110)).astype(np.float32))
    full = kernel_sample.sample_displaced(src[None], fx, fy)
    part = kernel_sample.sample_displaced(src[None], fx[:, 30:50].contiguous(), fy[:, 30:50].contiguous(),
                                          row0=30)
    assert torch.equal(part, full[:, 30:50])


@pytest.mark.parametrize("fwd", [
    [[1.0004, 0.0003, 6.4], [-0.0003, 1.0004, -9.1]],
    [[0.955, -0.296, 10.0], [0.296, 0.955, 5.0]],  # strong rotation
    [[1.0, 0.0, 2.5], [0.0, 1.0, -1.5]],
])
def test_affine_warp_traced_matches_jax(rng, fwd):
    img = rng.random((300, 280)).astype(np.float32) * 255
    fwd = np.float32(fwd)
    got = tat.affine_warp_traced(torch.from_numpy(img), torch.from_numpy(fwd)).numpy()
    want = np.asarray(jax.jit(jat.affine_warp_traced)(jnp.asarray(img), jnp.asarray(fwd)))
    host = tw.affine_warp(torch.from_numpy(img), fwd).numpy()
    assert np.max(np.abs(got - want)) < 255 * 1e-4
    assert np.max(np.abs(got - host)) < 255 * 1e-4


def test_affine_warp_traced_identity_and_singular(rng):
    img = rng.random((64, 70)).astype(np.float32)
    eye = torch.eye(2, 3)
    assert torch.equal(tat.affine_warp_traced(torch.from_numpy(img), eye), torch.from_numpy(img))
    singular = tat.affine_warp_traced(torch.from_numpy(img), torch.zeros(2, 3)).numpy()
    np.testing.assert_array_equal(singular, np.full_like(img, img[0, 0]))


@pytest.mark.parametrize("dtype,target,t_mat", [
    (np.uint16, (260, 270), [[1.0008, 0.0003, 5.2], [-0.0003, 1.0008, -3.1]]),
    (np.uint8, (250, 250), [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]),
    (np.float32, (250, 263), [[0.999, 0.01, -2.0], [-0.01, 0.999, 7.5]]),
])
def test_transform_img_with_tmat_matches_jax(rng, dtype, target, t_mat):
    hi = {np.uint16: 60000, np.uint8: 255, np.float32: 1.0}[dtype]
    img = (_textured(rng, 240, 250) / 255 * hi).astype(dtype)
    got = tw.transform_img_with_tmat(img, target, np.array(t_mat), device="cpu")
    want = np.asarray(jw.transform_img_with_tmat(img, target, np.array(t_mat)))
    assert got.dtype == want.dtype == dtype and got.shape == want.shape == target
    if t_mat == [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]:
        np.testing.assert_array_equal(got, want)
    elif dtype == np.float32:
        assert np.abs(got - want).max() < 1e-4
    else:
        diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
        assert (diff <= 1).mean() >= 0.999 and diff.max() <= 2


@pytest.mark.parametrize("shape,tile,overlap", [((100, 130), 40, 10), ((57, 91), 25, 7)])
def test_compat_tiling_matches_jax(rng, shape, tile, overlap):
    arr = rng.integers(0, 255, shape).astype(np.uint8)
    got_tiles, got_info = tcompat.split_image_into_tiles_of_size(arr, tile, tile, overlap)
    want_tiles, want_info = jcompat.split_image_into_tiles_of_size(arr, tile, tile, overlap)
    assert got_info == want_info
    for g, w in zip(got_tiles, want_tiles):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(tcompat.stitch_image(got_tiles, got_info), arr)
    np.testing.assert_array_equal(tcompat.get_tile(arr, 30, 70, 10, 50, overlap),
                                  jcompat.get_tile(arr, 30, 70, 10, 50, overlap))
    pad = {"top": 3, "left": 0}
    assert (tcompat.get_slices(arr, 0, 40, 0, 40, pad, overlap)
            == jcompat.get_slices(arr, 0, 40, 0, 40, pad, overlap))
