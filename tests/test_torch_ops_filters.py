"""Port's padding, separable filters, DoG, pyramids and min-max normalisation
against the JAX package on the same numpy inputs (JAX on the CPU).

Float results agree to rtol 1e-6 / atol 1e-4 on the 0-255 scale: both sides
sum the taps in the same order, but XLA contracts each multiply-add into one
FMA under ``jit`` (one rounding instead of two), so sums differ in the last
bits.  Integer outputs of dyadic kernels (pyramids, min-max) are exact; the
DoG's Gaussian taps are not dyadic, so the same last-bit differences can move
a value across a .5 rounding tie (bar below).
"""

import cv2 as cv
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from microaligner_tpu.ops import filters as jf
from microaligner_tpu.ops import pad as jpad
from microaligner_tpu_torch.ops import filters as tf
from microaligner_tpu_torch.ops import kernel_dog
from microaligner_tpu_torch.ops import pad as tpad

torch.set_num_threads(1)

RTOL, ATOL = 1e-6, 1e-4


def _img(rng, shape, dtype=np.uint8):
    hi = 256 if dtype == np.uint8 else 65536
    return rng.integers(0, hi, size=shape).astype(dtype)


@pytest.mark.parametrize("bigger,smaller", [(10, 10), (11, 10), (13, 10), (14, 10), (1000, 333)])
def test_calculate_padding_size(bigger, smaller):
    assert tpad.calculate_padding_size(bigger, smaller) == jpad.calculate_padding_size(bigger, smaller)


@pytest.mark.parametrize("target", [(40, 50), (41, 53), (37, 44)])
def test_pad_to_shape(rng, target):
    img = _img(rng, (37, 44), np.uint16)
    want, wpad = jpad.pad_to_shape(img, target)
    got_np, gpad = tpad.pad_to_shape(img, target)
    got_t, tpad_ = tpad.pad_to_shape(torch.from_numpy(img), target)
    assert gpad == wpad == tpad_
    np.testing.assert_array_equal(got_np, np.asarray(want))
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want))


@pytest.mark.parametrize("kx,ky", [(5, 3), (9, 9), (41, 41)])
def test_sep_filter2d(rng, kx, ky):
    img = (rng.random((37, 52)) * 255).astype(np.float32)
    kxv = jf.gaussian_kernel(kx, 0.0)
    kyv = jf.gaussian_kernel(ky, 2.5)
    want = np.asarray(jf.sep_filter2d(jnp.asarray(img), kxv, kyv))
    got = tf.sep_filter2d(torch.from_numpy(img), kxv, kyv).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("ksize,sigma", [(3, 0), (7, 0), (9, 0), (41, 5), (41, 9)])
def test_gaussian_kernel_and_blur(rng, ksize, sigma):
    np.testing.assert_array_equal(tf.gaussian_kernel(ksize, sigma), jf.gaussian_kernel(ksize, sigma))
    img = (rng.random((60, 48)) * 255).astype(np.float32)
    want = np.asarray(jf.gaussian_blur(jnp.asarray(img), ksize, sigma))
    got = tf.gaussian_blur(torch.from_numpy(img), ksize, sigma).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_sep_filter2d_kernel_longer_than_axis(rng):
    """The REFLECT_101 fold repeats on an axis shorter than the kernel."""
    img = (rng.random((6, 40)) * 255).astype(np.float32)
    k = jf.gaussian_kernel(21, 4.0)
    want = np.asarray(jf.sep_filter2d(jnp.asarray(img), k, k))
    got = tf.sep_filter2d(torch.from_numpy(img), k, k).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.float32])
def test_minmax_normalize(rng, dtype):
    img = _img(rng, (45, 61), np.uint16).astype(dtype)
    want_f = np.asarray(jf.minmax_normalize_f32(jnp.asarray(img)))
    got_f = tf.minmax_normalize_f32(torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(got_f * 255, want_f * 255, rtol=RTOL, atol=ATOL)
    want_u = np.asarray(jf.minmax_normalize_u8(jnp.asarray(img)))
    got_u = tf.minmax_normalize_u8(torch.from_numpy(img)).numpy()
    assert got_u.dtype == np.uint8
    np.testing.assert_array_equal(got_u, want_u)


def test_minmax_constant_image():
    img = np.full((8, 9), 7, np.uint8)
    np.testing.assert_array_equal(
        tf.minmax_normalize_u8(torch.from_numpy(img)).numpy(),
        np.asarray(jf.minmax_normalize_u8(jnp.asarray(img))),
    )


def _dog_composed(img: torch.Tensor, low_sigma: int = 5, high_sigma: int = 9) -> torch.Tensor:
    """The DoG as the filters compose it, written out here as the reference
    of its plain version (K7's CPU path)."""
    fimg = tf.minmax_normalize_f32(img)
    ksize = low_sigma * 8 + 1
    return tf.minmax_normalize_u8(tf.gaussian_blur(fimg, ksize, high_sigma) - tf.gaussian_blur(fimg, ksize, low_sigma))


@pytest.mark.parametrize("shape", [(96, 110), (7, 300), (45, 13)])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.float32])
def test_dog(rng, dtype, shape):
    raw = _img(rng, shape, np.uint16 if dtype == np.float32 else dtype)
    img = cv.GaussianBlur(raw.astype(np.float32), (0, 0), 2.0).astype(dtype)
    want = np.asarray(jf.dog(img, True))
    got_t = tf.dog(torch.from_numpy(img), True)
    assert torch.equal(got_t, _dog_composed(torch.from_numpy(img)))
    got = got_t.numpy()
    assert got.dtype == np.uint8
    # an FMA under jit moves a value across a .5 tie now and then: one level
    # at most, on at most 0.5% of pixels
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 5e-3


def test_dog_passthrough(rng):
    img = _img(rng, (32, 32))
    t = torch.from_numpy(img)
    assert tf.dog(t, False) is t
    zeros = torch.zeros((32, 32), dtype=torch.uint8)
    np.testing.assert_array_equal(tf.dog(zeros, True).numpy(), np.asarray(jf.dog(zeros.numpy(), True)))
    np.testing.assert_array_equal(tf.dog_traced(zeros, True).numpy(), zeros.numpy())


@pytest.mark.parametrize("shape", [(96, 110), (7, 300), (1, 5), (300, 2)])
@pytest.mark.parametrize("low,high", [(5, 9), (3, 7), (10, 18)])
def test_dog_kernel_args(shape, low, high):
    """The taps, radius and fold tables K7's wrapper hands the kernel are the
    plain version's: ``_taps(gaussian_kernel(ksize, sigma))`` of both sigmas
    and ``_reflect101_index`` of both axes."""
    ksize = low * 8 + 1
    args = kernel_dog.kernel_args(*shape, ksize, low, high)
    r = args.radius
    assert r == low * 4
    assert args.taps.dtype == torch.float32 and args.taps.shape == (2, ksize)
    assert args.taps[0].tolist() == tf._taps(tf.gaussian_kernel(ksize, low))
    assert args.taps[1].tolist() == tf._taps(tf.gaussian_kernel(ksize, high))
    assert args.folds.dtype == torch.int32 and args.folds.numel() == shape[0] + shape[1] + 4 * r
    for table, size in ((args.folds[: shape[0] + 2 * r], shape[0]), (args.folds[shape[0] + 2 * r :], shape[1])):
        assert torch.equal(table.long(), tf._reflect101_index(size, r, "cpu"))
        assert int(table.min()) >= 0 and int(table.max()) < size


def test_dog_u8_takes_the_plain_version_on_the_cpu(rng):
    img = torch.from_numpy(_img(rng, (40, 52)))
    calls, launches = kernel_dog.dog_plain.calls, kernel_dog.dog_u8.launches
    got = tf.dog_traced(img, True)
    assert kernel_dog.dog_plain.calls == calls + 1 and kernel_dog.dog_u8.launches == launches
    assert torch.equal(got, kernel_dog.dog_plain(img, 41, 5, 9))


@pytest.mark.parametrize("shape,dtype,ksize", [((3, 40, 50), torch.uint8, 41), ((40,), torch.uint8, 41),
                                               ((40, 50), torch.int32, 41), ((40, 50), torch.float64, 41),
                                               ((40, 50), torch.uint8, 83), ((40, 50), torch.uint8, 40)])
def test_dog_u8_refuses(shape, dtype, ksize):
    """K7's wrapper refuses what the kernel does not take, on either device:
    a tensor that is not 2-D, a dtype other than u8, u16 or float32, and a
    kernel size that is even or above 81."""
    with pytest.raises(ValueError, match="dog_u8"):
        kernel_dog.dog_u8(torch.zeros(shape, dtype=dtype), ksize, 5, 9)


@pytest.mark.parametrize("shape", [(100, 100), (101, 103), (37, 64)])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.float32])
def test_pyr_down(rng, shape, dtype):
    img = _img(rng, shape, np.uint16).astype(dtype)
    want = np.asarray(jf.pyr_down(jnp.asarray(img)))
    got = tf.pyr_down(torch.from_numpy(img)).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    if dtype == np.float32:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    else:
        np.testing.assert_array_equal(got, want)  # dyadic taps: exact sums


@pytest.mark.parametrize(
    "src_shape,dst_shape",
    [((50, 60), (100, 120)), ((50, 60), (99, 119)), ((50, 60), (101, 121))],
)
def test_pyr_up(rng, src_shape, dst_shape):
    img = (rng.random(src_shape) * 255).astype(np.float32)
    want = np.asarray(jf.pyr_up(jnp.asarray(img), dst_shape))
    got = tf.pyr_up(torch.from_numpy(img), dst_shape).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, cv.pyrUp(img, dstsize=dst_shape[::-1]), atol=1e-3)


@pytest.mark.parametrize("dst_shape", [(200, 240), (102, 120), (100, 118), (98, 120), (100, 123)])
def test_pyr_up_refuses_what_cv_refuses(rng, dst_shape):
    """A ``dstsize`` off twice the input (+-1 when odd) fails ``cv.pyrUp``'s
    assertion; the port raises instead of returning another shape."""
    img = (rng.random((50, 60)) * 255).astype(np.float32)
    with pytest.raises(cv.error):
        cv.pyrUp(img, dstsize=dst_shape[::-1])
    with pytest.raises(ValueError, match="dstsize"):
        tf.pyr_up(torch.from_numpy(img), dst_shape)
    with pytest.raises(ValueError, match="dstsize"):
        tf.pyr_up(torch.from_numpy(np.stack([img, img], -1)), dst_shape)


def test_pyr_up_flow_and_u8(rng):
    flow = (rng.random((40, 50, 2)) * 6 - 3).astype(np.float32)
    want = np.asarray(jf.pyr_up(jnp.asarray(flow), (81, 99)))
    got = tf.pyr_up(torch.from_numpy(flow), (81, 99)).numpy()
    assert got.shape == (81, 99, 2)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    img = _img(rng, (40, 50))
    np.testing.assert_array_equal(
        tf.pyr_up(torch.from_numpy(img), (80, 100)).numpy(),
        np.asarray(jf.pyr_up(jnp.asarray(img), (80, 100))),
    )


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_max_project_u8(rng, dtype):
    """The z-max projection of pipeline/runner.py's reference channel
    (utils/pages.py): the JAX package's max over pages, then its u8 min-max."""
    from microaligner_tpu_torch.utils.pages import max_project_u8

    planes = [_img(rng, (33, 41), dtype) for _ in range(3)]
    want = np.asarray(jf.minmax_normalize_u8(jnp.asarray(np.maximum.reduce(planes))))
    np.testing.assert_array_equal(max_project_u8(planes, "cpu").numpy(), want)
    with pytest.raises(ValueError):
        max_project_u8([], "cpu")
