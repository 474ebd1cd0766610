"""Farneback's reduced-precision route (``MICROALIGNER_TPU_AGG_PRECISION``,
``MICROALIGNER_TPU_R_BF16``): the port's selectors, the bf16 entries of K2,
K4 and K3 (their plain versions, which the CPU runs) and the whole route,
against the JAX package on the same numpy inputs, its Pallas kernels in
interpret mode.

Bars and their reasons:
* selectors: equal to the JAX package's on its TPU, for every value of both
  variables; unset is the port's stated departure (float32 at every window),
  asserted as such.
* K2 and K4 outputs: |port - JAX| <= 1e-4 max|JAX| for float32 outputs;
  for bf16 ones 2^-7 |JAX| more, and at most 3% of the values differ.
  Before the rounding the two differ by up to 3e-5 of the largest value
  (XLA contracts multiply-adds into FMAs; measured on these textures); two
  values that close round to the same bf16 value or to neighbours one unit
  apart, at most 2^-7 of the value (measured: 1.3% of the values of K2,
  0.02% of K4's).
* K3's row pass: within one bf16 unit of JAX (2^-7 |JAX|) on at most 1% of
  the values, the rest equal (XLA sums the band in another order, and a sum
  can round to the neighbouring bf16 value).  Flows, where the 2x2 system
  is conditioned (|det| > 1e-2): within 1e-4 px, the f32 K3 test's bar, on
  99% of the pixels, and within 1e-3 px on all: a pass-1 value one unit
  apart moves the flow around it by up to 3.0e-4 px (measured; elsewhere
  1.2e-6 px, pass 2's order).
* the whole bf16 route against the JAX package's bf16 route composed from
  its kernels: flow mean < 5e-4 px, max < 1e-2 px.  The bf16 values that
  round apart in K2, K3 and K4 (above) carry through three iterations
  (measured: mean 1.1e-4 px, max 1.2e-3 px on K2's branch); the f32 route's
  bar against JAX is mean 1e-4 and max 1e-2 px.
* against ``cv.calcOpticalFlowFarneback``: mean < 1e-3 px, max < 0.05 px,
  the JAX package's bars (``tests/test_farneback.py``).
* meshes of 2 against one device, and unset against ``highest``: bit-equal.
"""

import importlib

import cv2 as cv
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microaligner_tpu.ops.pallas_agg import pallas_smooth5_solve, pallas_smooth_w
from microaligner_tpu.ops.pallas_matrices import pallas_update_matrices
from microaligner_tpu.ops.pallas_poly import pallas_poly_pair_m
from microaligner_tpu_torch.ops import kernel_agg, kernel_matrices, kernel_poly
from microaligner_tpu_torch.optflow import farneback as tfb
from microaligner_tpu_torch.parallel import use_tile_mesh
from microaligner_tpu_torch.parallel.mesh import get_tile_mesh
from microaligner_tpu_torch.tiles import TileGrid

jfb = importlib.import_module("microaligner_tpu.optflow.farneback")

torch.set_num_threads(1)

AGG = "MICROALIGNER_TPU_AGG_PRECISION"
RBF = "MICROALIGNER_TPU_R_BF16"
CPU = torch.device("cpu")
BF16 = torch.bfloat16
F32 = torch.float32
J_DTYPES = {F32: jnp.float32, BF16: jnp.bfloat16}


def _np32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _bf16_rounding_bar(got, want, max_share=0.03):
    """K2's and K4's bar (see the module docstring)."""
    g, w = _np32(got), _np32(want)
    err = np.abs(g - w)
    bf16 = got.dtype == BF16
    bound = (2.0**-7 * np.abs(w) if bf16 else 0.0) + 1e-4 * np.abs(w).max()
    assert (err <= bound).all(), f"max excess {(err - bound).max()}"
    if bf16:
        assert (err > 0).mean() <= max_share, (err > 0).mean()


def _textured_pair(rng, n, h, w):
    """(n, h, w) float32 movs and refs: a smooth texture and a copy moved by
    (1, -1) px, each batch entry scaled apart."""
    base = cv.GaussianBlur(rng.random((h + 8, w + 8), dtype=np.float32), (0, 0), 2.0) * 255
    scale = np.linspace(1.0, 0.6, n, dtype=np.float32).reshape(n, 1, 1)
    movs = (base[4 : 4 + h, 4 : 4 + w][None] * scale).astype(np.float32)
    refs = (base[3 : 3 + h, 5 : 5 + w][None] * scale).astype(np.float32)
    return movs, refs


def _padded(x: np.ndarray) -> np.ndarray:
    s = jax.vmap(jfb._pre_smooth)(jnp.asarray(x))
    return np.array(jnp.pad(s, ((0, 0), (1, 1), (1, 1)), mode="edge"))


def _shifted_pair(rng, h=160, w=180, dx=1.5, dy=-1.0):
    base = cv.GaussianBlur(rng.random((h + 40, w + 40), dtype=np.float32), (0, 0), 3.0)
    base = cv.normalize(base, None, 0, 255, cv.NORM_MINMAX, cv.CV_8U)
    m = np.float32([[1, 0, -dx], [0, 1, -dy]])
    shifted = cv.warpAffine(base, m, (w + 40, h + 40))
    return shifted[20 : 20 + h, 20 : 20 + w], base[20 : 20 + h, 20 : 20 + w]


# -- (a) the selectors ---------------------------------------------------------

PRECISION_NAMES = {jax.lax.Precision.DEFAULT: "default", jax.lax.Precision.HIGH: "highest",
                   jax.lax.Precision.HIGHEST: "highest"}  # HIGH rounds up, as pallas_agg._prec does


@pytest.mark.parametrize("winsize", [11, 99])
@pytest.mark.parametrize("r_bf16", [None, "0", "1"])
@pytest.mark.parametrize("agg", [None, "default", "high", "highest", "DEFAULT"])
def test_selectors_match_the_jax_package_on_its_tpu(monkeypatch, agg, r_bf16, winsize):
    """Each selector against the JAX function of its name, with
    ``jax.default_backend`` reporting a TPU (off the TPU the JAX package
    keeps float32 storage whatever the variables say).  Unset, the port
    computes in float32 at every window; the JAX package's TPU route takes
    bf16 from window 49 on."""
    for var, value in ((AGG, agg), (RBF, r_bf16)):
        if value is None:
            monkeypatch.delenv(var, raising=False)
        else:
            monkeypatch.setenv(var, value)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    got = (tfb._agg_precision(winsize), tfb._m_storage_dtype(winsize), tfb._r_storage_dtype(winsize))
    want = (PRECISION_NAMES[jfb._agg_precision(winsize)],
            {jnp.float32: F32, jnp.bfloat16: BF16}[jfb._m_storage_dtype(winsize)],
            {jnp.float32: F32, jnp.bfloat16: BF16}[jfb._r_storage_dtype(winsize)])
    if agg is None:
        assert got == ("highest", F32, F32)  # the port's departure
        jax_unset_bf16 = winsize >= jfb._BF16_MIN_WINSIZE
        assert want[0] == ("default" if jax_unset_bf16 else "highest")
        assert want[1] == (BF16 if jax_unset_bf16 else F32)
    else:
        assert got == want
    assert tfb._BF16_MIN_WINSIZE == jfb._BF16_MIN_WINSIZE


def test_selectors_refuse_other_values(monkeypatch):
    """A value that names no precision raises in both packages (the JAX
    package's dict lookup raises KeyError)."""
    monkeypatch.setenv(AGG, "medium")
    with pytest.raises(KeyError):
        jfb._agg_precision(99)
    for fn in (tfb._agg_precision, tfb._m_storage_dtype, tfb._r_storage_dtype):
        with pytest.raises(ValueError, match="medium"):
            fn(99)
    movs = torch.zeros((1, 20, 20))
    with pytest.raises(ValueError, match="medium"):
        tfb._farneback_core_parts(movs, movs, 11, 1, 1, 1.7)


# -- (b) K2 --------------------------------------------------------------------

@pytest.mark.parametrize("n,h,w", [(2, 40, 70), (1, 24, 141)])
@pytest.mark.parametrize("rdt,mdt", [(BF16, BF16), (F32, BF16), (BF16, F32), (F32, F32)],
                         ids=["r-bf16-m-bf16", "r-f32-m-bf16", "r-bf16-m-f32", "r-f32-m-f32"])
def test_k2_typed_plain_matches_pallas(rng, n, h, w, rdt, mdt):
    """K2's plain version with ``r_dtype``/``m_dtype`` against
    ``pallas_poly_pair_m`` in interpret mode; M0 comes from the float32
    expansions, before they are rounded."""
    movs, refs = _textured_pair(rng, n, h, w)
    sp0, sp1 = _padded(movs), _padded(refs)
    coeffs = jfb._poly_coeff_tuple(1, 1.7)
    got = kernel_poly.poly_pair_m(torch.from_numpy(sp0), torch.from_numpy(sp1), coeffs, r_dtype=rdt, m_dtype=mdt)
    want = pallas_poly_pair_m(jnp.asarray(sp0), jnp.asarray(sp1), coeffs, m_dtype=J_DTYPES[mdt],
                              r_dtype=J_DTYPES[rdt], interpret=True)
    assert [g.dtype for g in got] == [rdt, rdt, mdt]
    for g, wv in zip(got, want):
        _bf16_rounding_bar(g, wv)
    r0, r1, m0 = kernel_poly.poly_pair_m_plain(torch.from_numpy(sp0), torch.from_numpy(sp1), coeffs)
    assert torch.equal(got[0], r0.to(rdt)) and torch.equal(got[1], r1.to(rdt))
    assert torch.equal(got[2], m0.to(mdt))  # from the unrounded expansions


# -- (c) K4 --------------------------------------------------------------------

@pytest.mark.parametrize("n,h,w,spread", [(2, 48, 96, 6.0), (1, 20, 131, 3.0)])
@pytest.mark.parametrize("rdt,mdt", [(BF16, BF16), (F32, BF16)], ids=["r-bf16-m-bf16", "r-f32-m-bf16"])
def test_k4_typed_plain_matches_pallas(rng, n, h, w, spread, rdt, mdt):
    """K4's plain version on bf16 (or float32) R with bf16 ``out_dtype``
    against ``pallas_update_matrices`` (band 4: the flows stay inside it)."""
    R0 = torch.from_numpy(rng.standard_normal((n, 5, h, w)).astype(np.float32)).to(rdt)
    R1 = torch.from_numpy(rng.standard_normal((n, 5, h, w)).astype(np.float32)).to(rdt)
    fx = torch.from_numpy(((rng.random((n, h, w)) - 0.5) * spread).astype(np.float32))
    fy = torch.from_numpy(((rng.random((n, h, w)) - 0.5) * spread).astype(np.float32))
    got = kernel_matrices.update_matrices(R0, R1, fx, fy, out_dtype=mdt)
    jr = [jnp.asarray(r.float().numpy()).astype(J_DTYPES[rdt]) for r in (R0, R1)]
    want = pallas_update_matrices(*jr, jnp.asarray(fx.numpy()), jnp.asarray(fy.numpy()), band=4,
                                  interpret=True, out_dtype=J_DTYPES[mdt])
    assert got.dtype == mdt and want.dtype == J_DTYPES[mdt]
    _bf16_rounding_bar(got, want)
    # the arithmetic is float32 on the widened loads, rounded once on store
    assert torch.equal(got, kernel_matrices.update_matrices_plain(R0.float(), R1.float(), fx, fy).to(mdt))
    assert torch.equal(kernel_matrices.zero_flow_matrices(R0, R1, mdt),
                       kernel_matrices.zero_flow_matrices(R0.float(), R1.float()).to(mdt))


def test_typed_wrappers_refuse_other_dtypes():
    """No entry takes float16 (nor mixed R): the wrappers raise before any
    device is touched, so a CUDA tensor of such a dtype raises too."""
    sp = torch.zeros((1, 10, 12))
    coeffs = tfb._poly_coeff_tuple(1, 1.7)
    r = torch.zeros((1, 5, 8, 10))
    f = torch.zeros((1, 8, 10))
    bad = [lambda: kernel_poly.poly_pair_m(sp, sp, coeffs, r_dtype=torch.float16),
           lambda: kernel_poly.poly_pair_m(sp, sp, coeffs, m_dtype=torch.float64),
           lambda: kernel_matrices.update_matrices(r.to(BF16), r, f, f),
           lambda: kernel_matrices.update_matrices(r.half(), r.half(), f, f),
           lambda: kernel_matrices.update_matrices(r, r, f, f, out_dtype=torch.float16),
           lambda: kernel_matrices.update_matrices(r, r, f.to(BF16), f.to(BF16)),
           lambda: kernel_agg.smooth5_solve(r.half(), 11),
           lambda: kernel_agg.smooth_w(r.half(), 11)]
    for fn in bad:
        with pytest.raises(ValueError):
            fn()


# -- (d) K3 --------------------------------------------------------------------

def _bf16_matrices(rng, n, h, w) -> torch.Tensor:
    """Well-conditioned bf16 M0 from the port's own K2 on a moved texture."""
    movs, refs = _textured_pair(rng, n, h, w)
    coeffs = tfb._poly_coeff_tuple(1, 1.7)
    return kernel_poly.poly_pair_m_plain(
        tfb._pad_replicate1(tfb._pre_smooth(torch.from_numpy(movs))),
        tfb._pad_replicate1(tfb._pre_smooth(torch.from_numpy(refs))), coeffs, BF16, BF16)[2]


@pytest.mark.parametrize("n,h,w,win", [
    pytest.param(2, 40, 70, 11, id="win11"),
    pytest.param(1, 12, 45, 11, id="win11-h12"),
    pytest.param(1, 130, 150, 49, id="win49-ragged-width"),
    pytest.param(1, 40, 70, 49, id="win49-h-and-w-below-2r"),
    pytest.param(2, 33, 61, 99, id="win99-h-and-w-below-2r"),
    pytest.param(1, 110, 130, 99, id="win99-h-below-2r-ragged-width"),
])
def test_k3_bf16_plain_matches_pallas(rng, monkeypatch, n, h, w, win):
    """K3's plain version on bf16 M against ``pallas_smooth5_solve`` and
    ``pallas_smooth_w`` in interpret mode (the JAX kernels read the
    precision while they trace: the variable is set, and their caches
    cleared, for the test)."""
    monkeypatch.setenv(AGG, "default")
    jax.clear_caches()
    M = _bf16_matrices(rng, n, h, w)
    jM = jnp.asarray(M.float().numpy()).astype(jnp.bfloat16)
    row = kernel_agg.smooth_w(M, win)
    want_row = pallas_smooth_w(jM, win, interpret=True)
    assert row.dtype == BF16 and want_row.dtype == jnp.bfloat16
    g, wr = _np32(row), _np32(want_row)
    err = np.abs(g - wr)
    assert (err <= 2.0**-7 * np.abs(wr)).all() and (err > 0).mean() <= 0.01
    fx, fy = kernel_agg.smooth5_solve(M, win)
    rx, ry = pallas_smooth5_solve(jM, win, interpret=True)
    assert fx.dtype == F32 and fy.dtype == F32
    s = kernel_agg.smooth_axis_plain(row, kernel_agg.agg_kernel(win), -2).numpy()
    ok = np.abs(s[:, 0] * s[:, 2] - s[:, 1] ** 2 + 1e-3) > 1e-2
    assert ok.mean() > 0.5
    for got, want in ((fx, rx), (fy, ry)):
        err = np.abs(got.numpy()[ok] - np.asarray(want)[ok])
        assert err.max() <= 1e-3 and (err > 1e-4).mean() <= 0.01, (err.max(), (err > 1e-4).mean())
    jax.clear_caches()


@pytest.mark.parametrize("win", [11, 49, 99])
@pytest.mark.parametrize("n", [1, 2, 5, 60, 130])
def test_bf16_coefficients_are_the_tpu_operators(win, n):
    """Every coefficient the bf16 route applies, gathered into a dense
    operator, is the JAX package's banded operator rounded to bf16: the
    folded edge coefficients included, on axes shorter than the window."""
    taps = kernel_agg.agg_kernel(win)
    r = win // 2
    table = kernel_agg._bf16_table(taps.tobytes(), n).numpy()
    dense = np.zeros((n, n), np.float32)
    for i in range(n):
        for k in range(2 * r + 1):
            if table[k, i]:
                assert dense[min(max(i + k - r, 0), n - 1), i] == 0  # one coefficient a pixel
            dense[min(max(i + k - r, 0), n - 1), i] += table[k, i]
    want = torch.from_numpy(jfb._banded_smooth_matrix(n, win)).to(BF16).float().numpy()
    np.testing.assert_array_equal(dense, want)
    # the tensor-core kernels' table (B fragments, lane by lane, one slot a 32-output group):
    # gathered by pixel, the same operator
    bits, gl, gt = kernel_agg.tc_factor_table(n, win)
    vals = torch.from_numpy(bits).view(BF16).float().numpy()  # (slots, steps, 2, 32, 8)
    s, p, lane, e = np.meshgrid(*(np.arange(d) for d in vals.shape[1:]), indexing="ij")
    k = 16 * s + 2 * (lane % 4) + e % 2 + 8 * (e // 2 % 2)
    j = 8 * (2 * p + e // 4) + lane // 4
    dense_tc = np.zeros((n, n), np.float32)
    for g in range(kernel_agg.tc_groups(n, win)[0]):
        src, out = 32 * g - kernel_agg.tc_halo(r) + k, 32 * g + j
        on_axis = (src >= 0) & (src < n) & (out < n)
        slot = vals[g if g < gl else gl if g < gt else gl + 1 + g - gt]
        dense_tc[src[on_axis], out[on_axis]] = slot[on_axis]
        assert not slot[~on_axis].any()  # what falls outside the axis multiplies zero
    np.testing.assert_array_equal(dense_tc, want)


@pytest.mark.parametrize("kernel", ["agg_rows_tc_kernel", "agg_cols_solve_tc_kernel"])
def test_bf16_blocks_fit_shared_memory(kernel):
    """K3's bf16 entry (``csrc/agg_tc.cu``): a block's staged bf16 sources
    fit the 227 KB a block can have at the largest window, and the four
    blocks its launch bounds ask for fit an SM at the main path's window."""
    assert kernel_agg.block_shared_bytes(kernel, kernel_agg.MAX_HALF_WINDOW) <= 232448
    assert 4 * (kernel_agg.block_shared_bytes(kernel, 99 // 2) + 1024) <= 233472


# -- (e), (f) the whole route ----------------------------------------------------

def _jax_bf16_route(movs, refs, win, num_iter, paired, rdt=jnp.bfloat16, mdt=jnp.bfloat16):
    """The JAX package's bf16 route, composed from its functions in its
    core's order (its own core keeps float32 off the TPU)."""
    movs, refs = jnp.asarray(movs), jnp.asarray(refs)
    if paired:
        sp0, sp1 = _padded(np.asarray(movs)), _padded(np.asarray(refs))
        r0, r1, m = pallas_poly_pair_m(jnp.asarray(sp0), jnp.asarray(sp1), jfb._poly_coeff_tuple(1, 1.7),
                                       m_dtype=mdt, r_dtype=rdt, interpret=True)
    else:
        r0 = jfb._poly_exp_batched(movs, 1, 1.7).astype(rdt)
        r1 = jfb._poly_exp_batched(refs, 1, 1.7).astype(rdt)
        m = jax.vmap(jfb._update_matrices_zero_flow_cf)(r0, r1).astype(mdt)
    fx = fy = None
    for i in range(num_iter):
        fx, fy = pallas_smooth5_solve(m, win, interpret=True)
        if i < num_iter - 1:
            m = pallas_update_matrices(r0, r1, fx, fy, band=4, interpret=True, out_dtype=mdt)
    return np.asarray(fx), np.asarray(fy)


@pytest.mark.parametrize("branch", ["paired", "unpaired"])
@pytest.mark.parametrize("r_bf16", ["1", "0"])
def test_bf16_core_matches_composed_jax_route(rng, monkeypatch, branch, r_bf16):
    """``_farneback_core_parts`` under ``default`` on both stage-2
    branches (K2; ``PALLAS_POLY=1``, K6 then the rounding), with bf16 R and
    with ``R_BF16=0``, against the JAX package's route composed from its
    kernels."""
    monkeypatch.setenv(AGG, "default")
    monkeypatch.setenv(RBF, r_bf16)
    if branch == "unpaired":
        monkeypatch.setenv(tfb.PALLAS_POLY_ENV, "1")
    else:
        monkeypatch.delenv(tfb.PALLAS_POLY_ENV, raising=False)
    jax.clear_caches()
    movs, refs = _textured_pair(rng, 2, 48, 72)
    got = tfb._farneback_core_parts(torch.from_numpy(movs), torch.from_numpy(refs), 49, 3, 1, 1.7)
    rdt = jnp.bfloat16 if r_bf16 == "1" else jnp.float32
    monkeypatch.delenv(tfb.PALLAS_POLY_ENV, raising=False)  # the JAX side composes its branch itself
    want = _jax_bf16_route(movs, refs, 49, 3, branch == "paired", rdt=rdt)
    jax.clear_caches()
    for g, wv in zip(got, want):
        err = np.abs(g.numpy() - wv)
        assert err.mean() < 5e-4 and err.max() < 1e-2, (err.mean(), err.max())


@pytest.mark.parametrize("num_iter,win", [(1, 51), (3, 51), (3, 99)])
def test_bf16_route_within_the_cv_bars(rng, monkeypatch, num_iter, win):
    """The bf16 route against OpenCV at the JAX package's bars; and not
    the float32 route's flow, bit for bit (the variable took effect)."""
    mov, ref = _shifted_pair(rng)
    f32 = tfb.farneback(mov, ref, win_size=win, num_iter=num_iter).numpy()
    monkeypatch.setenv(AGG, "default")
    got = tfb.farneback(mov, ref, win_size=win, num_iter=num_iter).numpy()
    theirs = cv.calcOpticalFlowFarneback(
        mov, ref, None, pyr_scale=0.5, levels=0, winsize=win, iterations=num_iter,
        poly_n=1, poly_sigma=1.7, flags=cv.OPTFLOW_FARNEBACK_GAUSSIAN,
    )
    err = np.abs(got - theirs)
    assert err.mean() < 1e-3 and err.max() < 0.05, (err.mean(), err.max())
    assert not np.array_equal(got, f32)


# -- the routes: R_BF16=0, meshes of 2, unset against highest ----------------------

class _DtypeSpy:
    """Wraps the kernels ``_farneback_core_parts`` calls and records the
    dtypes each was given."""

    def __init__(self, monkeypatch):
        self.seen = set()
        for name in ("smooth5_solve", "update_matrices", "zero_flow_matrices", "poly_pair_m"):
            real = getattr(tfb, name)
            monkeypatch.setattr(tfb, name, self._spy(name, real))

    def _spy(self, name, real):
        def call(*args, **kwargs):
            out = real(*args, **kwargs)
            outs = out if isinstance(out, tuple) else (out,)
            tensors = [a for a in args if isinstance(a, torch.Tensor)]
            self.seen.add((name, tuple(t.dtype for t in tensors), tuple(o.dtype for o in outs)))
            return out
        return call


@pytest.mark.parametrize("route", ["banded", "per_tile", "step", "poly_n2", "unpaired"])
def test_r_bf16_0_gives_f32_r_with_bf16_m_on_every_route(rng, monkeypatch, route):
    """Under ``default`` with ``R_BF16=0`` every route stores R in float32
    and M in bfloat16: K2 writes (f32, f32, bf16), K4 reads f32 R and
    writes bf16 M, K3 reads bf16 M."""
    from microaligner_tpu_torch.optflow.flow_calc import calc_flow_tiled
    from microaligner_tpu_torch.parallel.step import make_sharded_register_step

    monkeypatch.setenv(AGG, "default")
    monkeypatch.setenv(RBF, "0")
    spy = _DtypeSpy(monkeypatch)
    ref, mov = _shifted_pair(rng, 150, 170)
    grid = TileGrid.for_image(ref.shape, 60, 20)
    tr, tm = torch.from_numpy(ref), torch.from_numpy(mov)
    if route == "banded":
        monkeypatch.setenv("MICROALIGNER_TPU_FLOW_BAND_ROWS", "64")
        calc_flow_tiled(tr, tm, grid, 31, 2, 64)
    elif route == "per_tile":
        monkeypatch.setenv("MICROALIGNER_TPU_FLOW_DENSE", "0")
        calc_flow_tiled(tr, tm, grid, 31, 2)
    elif route == "step":
        make_sharded_register_step(get_tile_mesh([CPU]), grid, 31, 2)(tr, tm)
    elif route == "poly_n2":
        tfb._farneback_core_parts(tm[None].float(), tr[None].float(), 31, 2, 2, 1.5)
    else:
        monkeypatch.setenv(tfb.PALLAS_POLY_ENV, "1")
        tfb._farneback_core_parts(tm[None].float(), tr[None].float(), 31, 2, 1, 1.7)
    names = {s[0] for s in spy.seen}
    assert {"smooth5_solve", "update_matrices"} <= names
    assert names & {"poly_pair_m", "zero_flow_matrices"}
    for name, ins, outs in spy.seen:
        if name == "poly_pair_m":
            assert outs == (F32, F32, BF16)
        elif name == "zero_flow_matrices":
            assert ins == (F32, F32) and outs == (BF16,)
        elif name == "update_matrices":
            assert ins == (F32, F32, F32, F32) and outs == (BF16,)
        else:
            assert ins == (BF16,) and outs == (F32, F32)


@pytest.mark.parametrize("route", ["banded", "per_tile", "step"])
def test_bf16_route_on_a_mesh_of_2_equals_one_device(rng, monkeypatch, route):
    """The banded and per-tile routes and the sharded step under
    ``default``, on a CPU mesh of 2 against the same route on one device:
    bit-equal (a shard runs the same batched functions on the same rows)."""
    from microaligner_tpu_torch.optflow.flow_calc import calc_flow_tiled
    from microaligner_tpu_torch.parallel.step import make_sharded_register_step

    monkeypatch.setenv(AGG, "default")
    ref, mov = _shifted_pair(rng, 150, 170)
    grid = TileGrid.for_image(ref.shape, 60, 20)
    tr, tm = torch.from_numpy(ref), torch.from_numpy(mov)
    if route == "per_tile":
        monkeypatch.setenv("MICROALIGNER_TPU_FLOW_DENSE", "0")
    outs = {}
    for k in (1, 2):
        with use_tile_mesh([CPU] * k) as mesh:
            if route == "step":
                outs[k] = make_sharded_register_step(mesh, grid, 31, 2)(tr, tm)
            else:
                outs[k] = (calc_flow_tiled(tr, tm, grid, 31, 2, 48),)
    for a, b in zip(outs[1], outs[2]):
        assert torch.equal(a, b)
    monkeypatch.delenv(AGG)
    if route == "step":
        f32 = make_sharded_register_step(get_tile_mesh([CPU]), grid, 31, 2)(tr, tm)[1]
    else:
        f32 = calc_flow_tiled(tr, tm, grid, 31, 2, 48)
    assert not torch.equal(outs[1][1 if route == "step" else 0], f32)  # the variable took effect


@pytest.mark.parametrize("value", ["high", "highest"])
@pytest.mark.parametrize("branch", ["paired", "unpaired"])
def test_unset_is_the_float32_route_bit_for_bit(rng, monkeypatch, value, branch):
    """With the variables unset, ``_farneback_core_parts`` is bit-equal to
    a call under ``high`` or ``highest`` (``R_BF16`` alone changes nothing),
    and every matrix it passes is float32."""
    if branch == "unpaired":
        monkeypatch.setenv(tfb.PALLAS_POLY_ENV, "1")
    movs, refs = (torch.from_numpy(a) for a in _textured_pair(rng, 2, 40, 50))
    monkeypatch.delenv(AGG, raising=False)
    monkeypatch.setenv(RBF, "1")
    spy = _DtypeSpy(monkeypatch)
    want = tfb._farneback_core_parts(movs, refs, 99, 3, 1, 1.7)
    assert all(dt == F32 for _, ins, outs in spy.seen for dt in ins + outs)
    monkeypatch.setenv(AGG, value)
    got = tfb._farneback_core_parts(movs, refs, 99, 3, 1, 1.7)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
