"""Farneback: the plain versions of K2, K3 and K4 against the Pallas kernels
they replace (interpret mode) and the XLA paths, the whole ``farneback``
against the JAX package, and the cv2 bars of tests/test_farneback.py.

Bars and their reasons:
* K2 and K4: |port - JAX| <= 1e-5 * max|JAX| + 1e-6.  Same products and
  sums; XLA contracts multiply-adds into FMAs, so values differ in their
  last bits, relative to the largest value.
* K3: fx and fy within 1e-4 px where the 2x2 system is conditioned
  (|det| > 1e-2).  The aggregation sums 99 x 99 window taps in another order
  (the JAX side as block-banded matmuls); the solve divides by det, and
  where det is near its 1e-3 regulariser it amplifies those differences
  without bound.
* farneback flow: mean < 1e-4 px and max < 1e-2 px against the JAX package.
"""

import importlib

import cv2 as cv
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from microaligner_tpu.ops.pallas_agg import pallas_smooth5_solve, pallas_smooth_w
from microaligner_tpu.ops.pallas_matrices import pallas_update_matrices
from microaligner_tpu.ops.pallas_poly import pallas_poly_exp5, pallas_poly_pair_m
from microaligner_tpu_torch.ops import kernel_agg, kernel_matrices, kernel_poly
from microaligner_tpu_torch.optflow import farneback as tfb

# the JAX package's optflow/__init__ re-exports a function named farneback
jfb = importlib.import_module("microaligner_tpu.optflow.farneback")

torch.set_num_threads(1)


def _assert_rel(got, want, rel=1e-5, floor=1e-6):
    want = np.asarray(want, np.float32)
    bound = rel * np.abs(want).max() + floor
    err = np.abs(np.asarray(got) - want).max()
    assert err <= bound, f"max abs err {err} > {bound}"


def _padded_pair(rng, n, h, w):
    movs = (rng.random((n, h, w)) * 255).astype(np.float32)
    refs = (rng.random((n, h, w)) * 255).astype(np.float32)
    pad = lambda x: jnp.pad(jax.vmap(jfb._pre_smooth)(jnp.asarray(x)), ((0, 0), (1, 1), (1, 1)), mode="edge")
    return movs, refs, np.array(pad(movs)), np.array(pad(refs))


@pytest.mark.parametrize("n,h,w", [(2, 50, 70), (1, 9, 33), (1, 24, 140)])
def test_k2_plain_matches_pallas_and_xla(rng, n, h, w):
    movs, refs, sp0, sp1 = _padded_pair(rng, n, h, w)
    coeffs = jfb._poly_coeff_tuple(1, 1.7)
    got = kernel_poly.poly_pair_m(torch.from_numpy(sp0), torch.from_numpy(sp1), coeffs)
    if h >= 16:  # the Pallas kernel's row block needs 16 rows
        want = pallas_poly_pair_m(jnp.asarray(sp0), jnp.asarray(sp1), coeffs, interpret=True)
        for g, wv in zip(got, want):
            _assert_rel(g.numpy(), wv)
    r0 = jax.vmap(lambda x: jfb._poly_exp_cf(jfb._pre_smooth(x), 1, 1.7))(jnp.asarray(movs))
    r1 = jax.vmap(lambda x: jfb._poly_exp_cf(jfb._pre_smooth(x), 1, 1.7))(jnp.asarray(refs))
    m0 = jax.vmap(jfb._update_matrices_zero_flow_cf)(r0, r1)
    for g, wv in zip(got, (r0, r1, m0)):
        _assert_rel(g.numpy(), wv)


@pytest.mark.parametrize("n", [2, 3])
def test_poly_exp_general_n(rng, n):
    img = (rng.random((30, 41)) * 255).astype(np.float32)
    want = np.asarray(jfb._poly_exp_cf(jnp.asarray(img), n, 1.1 + 0.3 * n))
    got = tfb._poly_exp_cf(torch.from_numpy(img), n, 1.1 + 0.3 * n).numpy()
    _assert_rel(got, want)
    np.testing.assert_array_equal(tfb.poly_exp(torch.from_numpy(img), n, 1.1 + 0.3 * n).numpy(),
                                  np.moveaxis(got, 0, -1))


def _pipeline_matrices(rng, h, w):
    """Well-conditioned equations from the real pipeline (as
    tests/test_pallas_agg.py builds them)."""
    img = jnp.asarray(cv.GaussianBlur(rng.random((h, w)).astype(np.float32), (0, 0), 2.0) * 255)
    mov = jnp.roll(img, 2, axis=1)
    r0 = jfb._poly_exp_cf(jfb._pre_smooth(mov), 1, 1.7)
    r1 = jfb._poly_exp_cf(jfb._pre_smooth(img), 1, 1.7)
    one = jfb._update_matrices_zero_flow_cf(r0, r1)
    return np.asarray(jnp.stack([one, one * 1.25]))


@pytest.mark.parametrize("h,w,win", [(70, 100, 31), (150, 260, 99), (12, 45, 11)])
def test_k3_plain_matches_pallas_and_xla(rng, h, w, win):
    M = _pipeline_matrices(rng, h, w)
    fx, fy = kernel_agg.smooth5_solve(torch.from_numpy(M), win)
    s = np.asarray(jfb._smooth5_mxu(jnp.asarray(M), win))
    ok = np.abs(s[:, 0] * s[:, 2] - s[:, 1] ** 2 + 1e-3) > 1e-2
    assert ok.sum() > 300  # enough conditioned pixels to compare
    wants = [jfb._update_flow_gaussian_xla(jnp.asarray(M), win)]
    if h >= 16:
        wants.append(pallas_smooth5_solve(jnp.asarray(M), win, interpret=True))
    for rx, ry in wants:
        np.testing.assert_allclose(fx.numpy()[ok], np.asarray(rx)[ok], atol=1e-4)
        np.testing.assert_allclose(fy.numpy()[ok], np.asarray(ry)[ok], atol=1e-4)


@pytest.mark.parametrize("h,w,win", [(70, 100, 31), (256, 128, 99)])
def test_k3_row_pass_matches_pallas(rng, h, w, win):
    """K3's row pass alone against ``pallas_smooth_w`` in interpret mode."""
    M = rng.random((2, 5, h, w)).astype(np.float32)
    got = kernel_agg.smooth_w(torch.from_numpy(M), win).numpy()
    want = np.asarray(pallas_smooth_w(jnp.asarray(M), win, interpret=True))
    np.testing.assert_allclose(got, want, atol=1e-5)  # unit-range sums, another order


def test_k3_smooth_matches_banded_operator(rng):
    """Pass 1 alone equals the replicate-border operator of the JAX package."""
    x = rng.random((1, 5, 20, 90)).astype(np.float32)
    got = kernel_agg.smooth_axis_plain(torch.from_numpy(x), kernel_agg.agg_kernel(51), -1).numpy()
    want = x @ jfb._banded_smooth_matrix(90, 51)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _k4_inputs(rng, n, h, w, spread):
    R0 = rng.standard_normal((n, 5, h, w)).astype(np.float32)
    R1 = rng.standard_normal((n, 5, h, w)).astype(np.float32)
    fx = ((rng.random((n, h, w)) - 0.5) * spread).astype(np.float32)
    fy = ((rng.random((n, h, w)) - 0.5) * spread).astype(np.float32)
    return R0, R1, fx, fy


@pytest.mark.parametrize("h,w", [(12, 9), (40, 57)])
def test_edge_scale_and_inbounds_maps(rng, h, w):
    np.testing.assert_array_equal(tfb._edge_scale_map(h, w, "cpu").numpy(),
                                  np.asarray(jfb._edge_scale_map(h, w)))
    fx = ((rng.random((2, h, w)) - 0.5) * 8).astype(np.float32)
    fy = ((rng.random((2, h, w)) - 0.5) * 8).astype(np.float32)
    np.testing.assert_array_equal(
        tfb._inbounds_map(torch.from_numpy(fx), torch.from_numpy(fy)).numpy(),
        np.asarray(jfb._inbounds_map(jnp.asarray(fx), jnp.asarray(fy), h, w)),
    )


@pytest.mark.parametrize("n,h,w,spread", [(2, 64, 96, 6.0), (1, 40, 150, 13.0)])
def test_k4_plain_matches_pallas(rng, n, h, w, spread):
    R0, R1, fx, fy = _k4_inputs(rng, n, h, w, spread)
    got = kernel_matrices.update_matrices(*(torch.from_numpy(a) for a in (R0, R1, fx, fy)))
    want = pallas_update_matrices(*(jnp.asarray(a) for a in (R0, R1, fx, fy)), band=7, interpret=True)
    _assert_rel(got.numpy(), want)


@pytest.mark.parametrize("n,h,w,spread", [(1, 30, 47, 40.0), (1, 10, 70, 3.0)])
def test_k4_plain_matches_exact_path(rng, n, h, w, spread):
    """Displacements beyond any band (and H < 16) take the JAX package's
    exact gather; the port has one path for all of them."""
    R0, R1, fx, fy = _k4_inputs(rng, n, h, w, spread)
    got = kernel_matrices.update_matrices(*(torch.from_numpy(a) for a in (R0, R1, fx, fy)))
    want = jfb._update_matrices_batched_cf(*(jnp.asarray(a) for a in (R0, R1, fx, fy)))
    _assert_rel(got.numpy(), want)


def _shifted_pair(rng, h=160, w=180, dx=1.5, dy=-1.0):
    base = cv.GaussianBlur(rng.random((h + 40, w + 40), dtype=np.float32), (0, 0), 3.0)
    base = cv.normalize(base, None, 0, 255, cv.NORM_MINMAX, cv.CV_8U)
    m = np.float32([[1, 0, -dx], [0, 1, -dy]])
    shifted = cv.warpAffine(base, m, (w + 40, h + 40))
    return shifted[20 : 20 + h, 20 : 20 + w], base[20 : 20 + h, 20 : 20 + w]


@pytest.mark.parametrize("num_iter,win", [(1, 51), (3, 51), (3, 99)])
def test_farneback_matches_jax_and_cv(rng, num_iter, win):
    mov, ref = _shifted_pair(rng)
    got = tfb.farneback(mov, ref, win_size=win, num_iter=num_iter).numpy()
    want = np.asarray(jfb.farneback(mov, ref, win_size=win, num_iter=num_iter))
    err = np.abs(got - want)
    assert err.mean() < 1e-4 and err.max() < 1e-2, (err.mean(), err.max())
    theirs = cv.calcOpticalFlowFarneback(
        mov, ref, None, pyr_scale=0.5, levels=0, winsize=win, iterations=num_iter,
        poly_n=1, poly_sigma=1.7, flags=cv.OPTFLOW_FARNEBACK_GAUSSIAN,
    )
    err_cv = np.abs(got - theirs)
    assert err_cv.mean() < 1e-3 and err_cv.max() < 0.05, (err_cv.mean(), err_cv.max())


def test_farneback_recovers_translation(rng):
    mov, ref = _shifted_pair(rng, dx=2.0, dy=1.0)
    inner = tfb.farneback(mov, ref, win_size=51, num_iter=3).numpy()[40:-40, 40:-40]
    assert abs(np.median(inner[..., 0]) - 2.0) < 0.3
    assert abs(np.median(inner[..., 1]) - 1.0) < 0.3


def test_farneback_general_poly_n(rng):
    mov, ref = _shifted_pair(rng, h=60, w=70)
    got = tfb.farneback(mov, ref, win_size=21, num_iter=2, poly_n=2, poly_sigma=1.5).numpy()
    want = np.asarray(jfb.farneback(mov, ref, win_size=21, num_iter=2, poly_n=2, poly_sigma=1.5))
    err = np.abs(got - want)
    assert err.mean() < 1e-4 and err.max() < 1e-2


@pytest.mark.parametrize("n,h,w", [(2, 50, 70), (1, 20, 140)])
def test_k6_plain_matches_pallas_and_k2(rng, n, h, w):
    """K6's wrapper on CPU tensors (its plain version) against
    ``pallas_poly_exp5`` in interpret mode, and bit for bit against K2's
    expansions (the route switch below relies on it)."""
    movs, refs, sp0, sp1 = _padded_pair(rng, n, h, w)
    coeffs = jfb._poly_coeff_tuple(1, 1.7)
    before = (kernel_poly.poly_exp5_plain.calls, kernel_poly.poly_exp5.launches)
    got = kernel_poly.poly_exp5(torch.from_numpy(sp0), coeffs)
    assert kernel_poly.poly_exp5_plain.calls == before[0] + 1
    assert kernel_poly.poly_exp5.launches == before[1]  # CPU: never the kernel
    _assert_rel(got.numpy(), pallas_poly_exp5(jnp.asarray(sp0), coeffs, interpret=True))
    r0, _, _ = kernel_poly.poly_pair_m(torch.from_numpy(sp0), torch.from_numpy(sp1), coeffs)
    assert torch.equal(got, r0)
    with pytest.raises(ValueError):
        kernel_poly.poly_exp5(torch.from_numpy(sp0).double(), coeffs)
    with pytest.raises(ValueError):
        kernel_poly.poly_exp5(torch.from_numpy(sp0)[0], coeffs)


@pytest.mark.parametrize("num_iter,win", [(1, 31), (3, 51)])
def test_unpaired_route_equals_default_route(rng, monkeypatch, num_iter, win):
    """``MICROALIGNER_TPU_PALLAS_POLY=1`` sends ``_farneback_core_parts``
    through K6 (two expansions, then the zero-flow combine) instead of K2;
    the flow is the same bit for bit, and the variable is read per call."""
    mov, ref = _shifted_pair(rng, h=90, w=110)
    movs = torch.from_numpy(mov.astype(np.float32))[None]
    refs = torch.from_numpy(ref.astype(np.float32))[None]
    monkeypatch.delenv("MICROALIGNER_TPU_PALLAS_POLY", raising=False)
    calls = kernel_poly.poly_pair_m_plain.calls
    want = tfb._farneback_core_parts(movs, refs, win, num_iter, 1, 1.7)
    assert kernel_poly.poly_pair_m_plain.calls == calls + 1
    monkeypatch.setenv("MICROALIGNER_TPU_PALLAS_POLY", "1")
    calls = (kernel_poly.poly_pair_m_plain.calls, kernel_poly.poly_exp5_plain.calls)
    got = tfb._farneback_core_parts(movs, refs, win, num_iter, 1, 1.7)
    assert kernel_poly.poly_pair_m_plain.calls == calls[0]
    assert kernel_poly.poly_exp5_plain.calls == calls[1] + 2
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    jflow = np.asarray(jfb.farneback(mov, ref, win_size=win, num_iter=num_iter))
    err = np.abs(torch.stack([got[0][0], got[1][0]], -1).numpy() - jflow)
    assert err.mean() < 1e-4 and err.max() < 1e-2


def test_farneback_rejects_zero_iterations():
    with pytest.raises(ValueError):
        tfb.farneback(np.zeros((20, 20), np.uint8), np.zeros((20, 20), np.uint8), num_iter=0)
