"""K1 and the port's warp module against the JAX package.

K1's plain version is held against the Pallas kernel run in interpret mode
(``pallas_sample_displaced(..., interpret=True)``, exact only for integer
displacements in the band [-band, band-1]) and against the exact gather
``_sample_take_one``, including displacements far beyond the band.  The bar
is atol 1e-5 on unit-range data: both sides blend the same four taps with the
same weights; the banded kernel sums them in another order.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from microaligner_tpu.ops import warp as jw
from microaligner_tpu.ops.pallas_sample import pallas_sample_displaced
from microaligner_tpu_torch.ops import cuda_lib, kernel_sample, warp as tw

torch.set_num_threads(1)

ATOL = 1e-5


def _case(rng, shape, spread):
    img = rng.random(shape).astype(np.float32)
    fx = ((rng.random(shape) - 0.5) * spread).astype(np.float32)
    fy = ((rng.random(shape) - 0.5) * spread).astype(np.float32)
    return img, fx, fy


def _plain(img, fx, fy):
    return kernel_sample.sample_displaced(*(torch.from_numpy(a) for a in (img, fx, fy))).numpy()


@pytest.mark.parametrize("shape,band", [((2, 40, 50), 4), ((1, 37, 51), 7), ((1, 16, 130), 7)])
def test_plain_matches_pallas_interpret(rng, shape, band):
    # displacements whose floor stays in [-band, band - 1], the kernel's contract
    img, fx, fy = _case(rng, shape, 2 * band - 1)
    want = np.asarray(pallas_sample_displaced(img, fx, fy, band=band, interpret=True))
    np.testing.assert_allclose(_plain(img, fx, fy), want, atol=ATOL)


@pytest.mark.parametrize("shape,spread", [((2, 40, 50), 4.0), ((1, 33, 47), 40.0), ((1, 8, 300), 41.0)])
def test_plain_matches_exact_gather(rng, shape, spread):
    """Any displacement, far beyond the TPU band (up to +-20 px), H < 16 and
    widths that are no multiple of 32."""
    img, fx, fy = _case(rng, shape, spread)
    flow = jnp.stack([jnp.asarray(fx), jnp.asarray(fy)], axis=-1)
    want = np.asarray(jax.vmap(jw._sample_take_one)(jnp.asarray(img)[..., None], flow))[..., 0]
    np.testing.assert_allclose(_plain(img, fx, fy), want, atol=ATOL)


def test_plain_zero_flow_is_identity(rng):
    img, _, _ = _case(rng, (1, 20, 30), 0)
    z = np.zeros_like(img)
    np.testing.assert_array_equal(_plain(img, z, z), img)


def test_dispatch_counts_and_checks(rng):
    img, fx, fy = (torch.from_numpy(a) for a in _case(rng, (1, 12, 14), 3))
    before = (kernel_sample.sample_displaced_plain.calls, kernel_sample.sample_displaced.launches)
    kernel_sample.sample_displaced(img, fx, fy)
    assert kernel_sample.sample_displaced_plain.calls == before[0] + 1
    assert kernel_sample.sample_displaced.launches == before[1]  # CPU: never the kernel
    with pytest.raises(TypeError):
        kernel_sample.sample_displaced(img.double(), fx, fy)
    with pytest.raises(ValueError):
        kernel_sample.sample_displaced(img, fx[:, :5], fy)
    with pytest.raises(ValueError):
        kernel_sample.sample_displaced(img.transpose(1, 2), fx.transpose(1, 2), fy.transpose(1, 2))
    with pytest.raises(ValueError):  # the CUDA launch grid's limit, checked before a launch
        cuda_lib.check_grid("sample_displaced", 70000, 1)


@pytest.mark.parametrize("dtype", [np.float32, np.uint8, np.uint16])
def test_bilinear_remap(rng, dtype):
    img = (rng.random((30, 40)) * (250 if dtype != np.float32 else 1)).astype(dtype)
    mx = (rng.random((25, 33)) * 46 - 3).astype(np.float32)
    my = (rng.random((25, 33)) * 36 - 3).astype(np.float32)
    want = np.asarray(jw.bilinear_remap(jnp.asarray(img), jnp.asarray(mx), jnp.asarray(my)))
    got = tw.bilinear_remap(torch.from_numpy(img), torch.from_numpy(mx), torch.from_numpy(my)).numpy()
    assert got.dtype == want.dtype
    if dtype == np.float32:
        np.testing.assert_allclose(got, want, atol=ATOL)
    else:  # rounding half to even: last-bit differences may cross a .5 tie
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
        assert (got != want).mean() < 1e-3


def test_warp_with_flow_and_batched(rng):
    img = rng.random((2, 36, 44)).astype(np.float32)
    flow = ((rng.random((2, 36, 44, 2)) - 0.5) * 9).astype(np.float32)
    want = np.asarray(jw.warp_with_flow_batched(jnp.asarray(img), jnp.asarray(flow)))
    got = tw.warp_with_flow_batched(torch.from_numpy(img), torch.from_numpy(flow)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    want1 = np.asarray(jw.warp_with_flow(jnp.asarray(img[0]), jnp.asarray(flow[0])))
    got1 = tw.warp_with_flow(torch.from_numpy(img[0]), torch.from_numpy(flow[0])).numpy()
    np.testing.assert_allclose(got1, want1, atol=ATOL)
    got_parts = tw.warp_with_flow_parts_batched(
        torch.from_numpy(img), torch.from_numpy(flow[..., 0]), torch.from_numpy(flow[..., 1])
    ).numpy()
    np.testing.assert_array_equal(got_parts, got)


def test_sample_displaced_batched_channels(rng):
    imgs = rng.random((2, 30, 34, 2)).astype(np.float32)
    flows = ((rng.random((2, 30, 34, 2)) - 0.5) * 30).astype(np.float32)
    want = np.asarray(jw.sample_displaced_batched(jnp.asarray(imgs), jnp.asarray(flows)))
    got = tw.sample_displaced_batched(torch.from_numpy(imgs), torch.from_numpy(flows)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def _smooth_flow(h, w, mag, phase):
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    return np.stack([mag * np.sin(ys / 17 + phase), mag * np.cos(xs / 23 + phase)], -1).astype(np.float32)


@pytest.mark.parametrize("mag1,mag2", [(1.5, 0.7), (12.0, 3.0)])
def test_compose_flows(mag1, mag2):
    f1 = _smooth_flow(40, 52, mag1, 0.3)
    f2 = _smooth_flow(40, 52, mag2, 1.1)
    want = np.asarray(jw.compose_flows(jnp.asarray(f1), jnp.asarray(f2)))
    got = tw.compose_flows(torch.from_numpy(f1), torch.from_numpy(f2)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL * max(mag1, 1))
    wantb = np.asarray(jw.compose_flows_batched(jnp.asarray(f1)[None], jnp.asarray(f2)[None]))
    gotb = tw.compose_flows_batched(torch.from_numpy(f1)[None], torch.from_numpy(f2)[None]).numpy()
    np.testing.assert_allclose(gotb, wantb, atol=ATOL * max(mag1, 1))


def test_compose_flows_short_circuits():
    """``max() == 0`` returns the other flow verbatim, also for an all
    non-positive flow, as merge_two_flows does."""
    f1 = -np.abs(_smooth_flow(20, 24, 2.0, 0.0))
    f2 = _smooth_flow(20, 24, 1.0, 0.5)
    for a, b in ((f1, f2), (f2, f1), (np.zeros_like(f1), f2)):
        want = np.asarray(jw.compose_flows(jnp.asarray(a), jnp.asarray(b)))
        got = tw.compose_flows(torch.from_numpy(a), torch.from_numpy(b)).numpy()
        np.testing.assert_array_equal(got, want)
