"""FeatureReg's bf16 operand route (``MICROALIGNER_TPU_MATCH_F32``,
``MICROALIGNER_TPU_DAISY_EXACT``): the port's selectors, its bf16 knn cross
term, its bf16 blur products, DAISY and FeatureRegistrator on that route,
against the JAX package's bf16 arithmetic on the same numpy inputs.

The JAX package takes bf16 operands only off its CPU.  Its knn route is
reached here with ``microaligner_tpu.features.match.jax`` replaced by a proxy
whose ``default_backend()`` says ``"tpu"``; its blur route with
``microaligner_tpu.features.daisy.gaussian_blur_mxu`` replaced by a blur
composed from its own operator tables rounded to bf16 and contracted with
``preferred_element_type=float32`` (XLA's CPU ignores DEFAULT precision, so
this composition is the TPU's arithmetic: bf16 operands, float32 sums).
Both patches and every variable are set through ``monkeypatch``, and
``jax.clear_caches()`` follows each change (the JAX package reads them while
it traces).  The port takes the bf16 route on the CPU when it is given the
dtype, or, for FeatureRegistrator, when its route reader is asked for a
CUDA device's route.

Bars and their reasons (u = 2^-24, the float32 unit roundoff):
* selectors: equal to the route the JAX package takes for each value of
  each variable (unset, ``0``, ``1``, another) on its CPU and off it,
  observed from the JAX package itself.
* knn distances: within 2 * 605 u (|q|^2 + max |t|^2) of JAX's, twice the
  bound on one float32 evaluation of the mixed formula (features/match.py);
  good and nearest index equal to JAX's outside the port's near-tie set, and
  equal to a float64 golden of the mixed formula everywhere.
* blur: within the float32 summation bound of both axes' products,
  2 (n + 2) u sum |op| |x| an axis (XLA and the CPU's BLAS sum in other
  orders), except where the first axis's float32 output rounds to
  neighbouring bf16 values on the two sides: there one bf16 unit of it
  (2^-8 relative) times its operator weight more, on at most 1% of the
  values.
* DAISY descriptors: within 5e-4 of JAX's on unit-norm rows, and 5e-4 of
  the row's norm on raw ones, ten times inside the JAX package's bf16
  against float32 bar (5e-3, scripts/tpu_parity_check.py::_feature).
* FeatureRegistrator against the JAX package's on its bf16 route: the
  first round's match count equal (its inputs are the same on both sides,
  so it shows the two routes' descriptors and knn agree), and the four
  corners within 0.1 px, the port's bar against the JAX package on the
  float32 route (tests/test_torch_feature_registrator.py): later rounds
  start from RANSAC estimates drawn from another random stream, so the
  linear part differs by up to 1.4e-4 on this pair (5.6e-5 on the float32
  route), and the JAX package's bars for its own drivers (1e-4 linear,
  0.05 px) do not apply between the packages.  Within the port: the
  JAX package's host-driver variables (``FUSED_REGISTER=0``,
  ``FUSED_LEVEL=0``, which the port ignores), the per-tile path
  (``FEATURE_DENSE=0``; one tile a level on this pair) and a CPU mesh of 2
  bit-equal to the whole route on one device; each taking the bf16 route
  in every blur product and every knn (recorded).
  ``reuse_ref_img`` finds the reference features again when ``DAISY_EXACT``
  changes, and keeps them when only ``MATCH_F32`` does.
"""

import contextlib
import io
import types
import zlib

import cv2 as cv
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microaligner_tpu.features import FeatureRegistrator as JReg
from microaligner_tpu.features import daisy as jdaisy
from microaligner_tpu.features import match as jmatch
from microaligner_tpu.ops import filters as jfilt
from microaligner_tpu_torch.features import FeatureRegistrator as TReg
from microaligner_tpu_torch.features import daisy as tdaisy
from microaligner_tpu_torch.features import match as tmatch
from microaligner_tpu_torch.features import registrator as treg
from microaligner_tpu_torch.features import routes
from microaligner_tpu_torch.ops import filters as tfilt
from microaligner_tpu_torch.parallel import use_tile_mesh

torch.set_num_threads(1)

BF16 = torch.bfloat16
F32 = torch.float32
U = 2.0**-24
VARIABLES = ("MATCH_F32", "DAISY_EXACT", "DAISY_NRM", "FUSED_REGISTER", "FUSED_LEVEL", "FEATURE_DENSE",
             "FEATURE_DENSE_MAX_MPIX")


def _set(monkeypatch, **env):
    for name in VARIABLES:
        monkeypatch.delenv(f"MICROALIGNER_TPU_{name}", raising=False)
    for name, value in env.items():
        monkeypatch.setenv(f"MICROALIGNER_TPU_{name}", value)
    jax.clear_caches()


@pytest.fixture(autouse=True)
def _fresh_traces():
    yield
    jax.clear_caches()  # no later test may reuse a trace made under this test's patches


def _backend_proxy(backend: str):
    """``jax`` with ``default_backend()`` saying ``backend``."""
    proxy = types.ModuleType("jax")
    proxy.__getattr__ = lambda name: getattr(jax, name)
    proxy.default_backend = lambda: backend
    return proxy


def _jax_blur_bf16(x, ksize, sigma, precision=jax.lax.Precision.HIGHEST):
    """The JAX package's ``gaussian_blur_mxu`` at DEFAULT precision on a
    TPU: its operators and operands rounded to bf16, float32 sums.  HIGHEST
    (``DAISY_EXACT=1``) is its own float32 blur."""
    if precision == jax.lax.Precision.HIGHEST:
        return jfilt.gaussian_blur_mxu(x, ksize, sigma, precision=precision)
    block = jfilt._BANDED_BLOCK

    def product(eq, a, b):
        return jnp.einsum(eq, a.astype(jnp.bfloat16), b.astype(jnp.bfloat16), preferred_element_type=jnp.float32)

    def one_axis(arr, axis, size):
        lead = axis in (-2, arr.ndim - 2)
        if size <= block + ksize - 1:
            op = jnp.asarray(jfilt._blur_operator(size, ksize, float(sigma)))
            return product("ij,...jw->...iw", op, arr) if lead else product("...hj,wj->...hw", arr, op)
        r = (ksize - 1) // 2
        nb = -(-size // block)
        pad = [(0, 0)] * arr.ndim
        pad[axis] = (r, r)
        xp = jnp.pad(arr, pad, mode="reflect")
        pad[axis] = (0, nb * block - size)
        xp = jnp.pad(xp, pad)
        band = jnp.asarray(jfilt._toeplitz_band(block, ksize, float(sigma)))
        eq = "ij,...jw->...iw" if lead else "ij,...j->...i"
        outs = [product(eq, band, jax.lax.slice_in_dim(xp, j * block, j * block + block + 2 * r, axis=axis))
                for j in range(nb)]
        return jax.lax.slice_in_dim(jnp.concatenate(outs, axis=axis), 0, size, axis=axis)

    return one_axis(one_axis(x, -2, x.shape[-2]), -1, x.shape[-1])


@pytest.fixture
def jax_bf16(monkeypatch):
    """The JAX package's bf16 route on the CPU: its knn as on a TPU, its
    DAISY blurs as DEFAULT precision on a TPU."""
    _set(monkeypatch)
    monkeypatch.setattr(jmatch, "jax", _backend_proxy("tpu"))
    monkeypatch.setattr(jdaisy, "gaussian_blur_mxu", _jax_blur_bf16)
    jax.clear_caches()


# -- selectors ------------------------------------------------------------------

def _jax_knn_route(monkeypatch, backend: str) -> torch.dtype:
    """The operands the JAX package's knn takes on ``backend`` under the
    current variables, observed: its d1 against a float32 evaluation."""
    rng = np.random.default_rng(1)
    q, t = rng.random((8, 200), np.float32), rng.random((16, 200), np.float32)
    with monkeypatch.context() as mp:
        mp.setattr(jmatch, "jax", _backend_proxy(backend))
        jax.clear_caches()
        d1 = np.asarray(jmatch.knn_top2(q, t, np.ones(8, bool), np.ones(16, bool), chunk=8)[0])
    jax.clear_caches()
    exact = ((q[:, None].astype(np.float64) - t[None]) ** 2).sum(-1).min(1)
    return F32 if np.abs(d1 - exact).max() < 1e-3 else BF16


def _jax_daisy_route(monkeypatch, backend: str) -> torch.dtype:
    """The operands of the JAX package's DAISY blur products on
    ``backend`` under the current variables: the precision its
    ``_blur_chw`` asks for (DEFAULT is float32 on XLA's CPU, bf16 on a
    TPU)."""
    seen = []
    with monkeypatch.context() as mp:
        mp.setattr(jdaisy, "gaussian_blur_mxu", lambda x, k, s, precision: seen.append(precision) or x)
        jdaisy._blur_chw(jnp.zeros((1, 40, 40), jnp.float32), 3.5)
    default = seen == [jax.lax.Precision.DEFAULT]
    return BF16 if default and backend != "cpu" else F32


@pytest.mark.parametrize("value", [None, "0", "1", "2"], ids=["unset", "0", "1", "2"])
def test_selectors_follow_the_jax_rule(value, monkeypatch):
    for variable, selector, observe in (("MATCH_F32", routes.match_operand_dtype, _jax_knn_route),
                                        ("DAISY_EXACT", routes.daisy_operand_dtype, _jax_daisy_route)):
        _set(monkeypatch, **({} if value is None else {variable: value}))
        for device, backend in (("cpu", "cpu"), (torch.device("cuda"), "tpu")):
            assert selector(device) == observe(monkeypatch, backend), (variable, value, device)
    # unset on the card is the bf16 route; the CPU is float32 whatever the value
    if value is None:
        assert routes.match_operand_dtype("cuda:0") == routes.daisy_operand_dtype("cuda:0") == BF16


# -- the knn cross term -----------------------------------------------------------

def _descriptors(rng, n, d=200, raw=False):
    x = rng.random((n, d)).astype(np.float32) ** 3  # DAISY-like: non-negative, skewed
    if raw:
        return (x * np.exp(rng.uniform(-2.0, 2.0, (n, 1)))).astype(np.float32)
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _mixed64(query, train):
    """The bf16 route's distances in float64: float64 norms of the
    unrounded descriptors, the float64 product of the bf16-rounded ones."""
    qb, tb = (torch.from_numpy(a).to(BF16).double().numpy() for a in (query, train))
    q64, t64 = query.astype(np.float64), train.astype(np.float64)
    return np.maximum((q64 * q64).sum(1)[:, None] + (t64 * t64).sum(1)[None] - 2.0 * qb @ tb.T, 0.0)


@pytest.mark.parametrize("raw", [False, True], ids=["unit", "raw"])
def test_knn_bf16_matches_jax(raw, jax_bf16):
    rng = np.random.default_rng(11 + raw)
    train = _descriptors(rng, 700, raw=raw)
    # queries near train rows, so that the ratio test passes for some
    query = (train[rng.integers(0, 700, 400)] + 0.02 * _descriptors(rng, 400, raw=raw)).astype(np.float32)
    qv, tv = rng.random(400) > 0.05, rng.random(700) > 0.05
    got = [a.numpy() for a in tmatch.knn_top2(*(torch.from_numpy(a) for a in (query, train, qv, tv)), chunk=128,
                                              operand_dtype=BF16)]
    want = [np.asarray(a) for a in jmatch.knn_top2(query, train, qv, tv, chunk=128)]
    f32 = tmatch.knn_top2(*(torch.from_numpy(a) for a in (query, train, qv, tv)), operand_dtype=F32)[0].numpy()
    qn = (query.astype(np.float64) ** 2).sum(1)
    bound = 2 * 605 * U * (qn + (train.astype(np.float64) ** 2).sum(1)[tv].max())
    assert (np.abs(got[0] - want[0]) <= bound).all() and (np.abs(got[1] - want[1]) <= bound).all()
    # the route is the bf16 one, not the float32 one
    assert np.abs(got[0] - f32).max() > 4 * bound.max()

    good, idx = (a.numpy() for a in tmatch.match_descriptors(*(torch.from_numpy(a) for a in (train, query, tv, qv)),
                                                              operand_dtype=BF16))
    jgood, jidx = (np.asarray(a) for a in jmatch.match_descriptors(train, query, tv, qv))
    d1, d2 = got[0].astype(np.float64), got[1].astype(np.float64)
    scale = qn + (tmatch._KAPPA[BF16] * np.sqrt(qn) + np.sqrt(d2)) ** 2
    tie = (np.abs(d1 - 0.25 * d2) <= tmatch._TIE_TOL[BF16] * scale) & qv
    np.testing.assert_array_equal(good[~tie], jgood[~tie])
    np.testing.assert_array_equal(idx[~tie & good], jidx[~tie & good])
    assert 0 < good.sum() < qv.sum()
    dist = _mixed64(query, train) + np.where(tv, 0.0, np.inf)[None]
    order = np.argsort(dist, axis=1, kind="stable")
    g1, g2 = np.take_along_axis(dist, order[:, :2], axis=1).T
    np.testing.assert_array_equal(good, (g1 < 0.25 * g2) & qv)
    np.testing.assert_array_equal(idx[good], order[good, 0])


def test_near_ties_of_bf16_operands_decided_in_float64():
    """400 queries planted on the ratio threshold of the mixed formula, at
    norms spread over three decades, beside train rows a hundred times
    longer: every element of a query and its two rows lies a quarter of a
    bf16 unit off a bf16 value, and the runner-up's norm is tuned within its
    rounding interval, so d1 - 0.25 d2 of the mixed formula is within
    float32 rounding of 0.  Every ratio test and nearest index equals a
    float64 golden of the mixed formula on the same float32 descriptors."""
    rng = np.random.default_rng(23)
    n, d = 400, 200
    scale = np.exp(rng.uniform(np.log(0.05), np.log(50.0), n))
    frames = np.linalg.qr(rng.standard_normal((n, d, 3)))[0]
    offset = rng.standard_normal((n, d))
    offset *= 10.0 / np.linalg.norm(offset, axis=1, keepdims=True)

    def bf16_grid(x):
        """x rounded to bf16, and a quarter of each element's bf16 unit."""
        xb = torch.from_numpy(x).to(BF16).double().numpy()
        return xb, np.ldexp(0.25, np.frexp(np.abs(xb))[1] - 8)

    qb, qq = bf16_grid((offset + frames[..., 0]) * scale[:, None])
    nb, nq = bf16_grid((offset + frames[..., 1]) * scale[:, None])
    fb, fq = bf16_grid((offset + frames[..., 2] * np.sqrt(7.0)) * scale[:, None])
    query = qb + qq * rng.choice([-1.0, 1.0], (n, d))
    near = nb + nq * rng.choice([-1.0, 1.0], (n, d))
    # far = fb + a fq sign(fb), a in [-1, 1] (so far still rounds to fb): solve
    # d1 = 0.25 d2 (1 + e) for a, a quadratic |far|^2 = A + 2 a B + a^2 C
    e = rng.uniform(-3e-7, 3e-7, n)
    qn = (query**2).sum(1)
    d1 = qn + (near**2).sum(1) - 2.0 * (qb * nb).sum(1)
    target = 4.0 * d1 / (1.0 + e) - qn + 2.0 * (qb * fb).sum(1)  # the |far|^2 that plants the tie
    s = np.sign(fb) * fq
    A, B, C = (fb**2).sum(1), (fb * s).sum(1), (s**2).sum(1)
    a = (-B + np.sqrt(B * B - C * (A - target))) / C
    keep = np.isfinite(a) & (np.abs(a) <= 0.99)
    assert keep.mean() > 0.9
    far = fb + a[:, None] * s
    query, near, far = (x[keep].astype(np.float32) for x in (query, near, far))
    m = len(query)
    long_rows = (5000.0 * rng.random((20, d))).astype(np.float32)
    train = np.concatenate([near, far, long_rows])
    qv, tv = np.ones(m, bool), np.ones(len(train), bool)
    calls, rows = tmatch.near_ties["calls"], tmatch.near_ties["rows"]
    good, idx = (a.numpy() for a in tmatch.match_descriptors(*(torch.from_numpy(a) for a in (train, query, tv, qv)),
                                                              operand_dtype=BF16))
    dist = _mixed64(query, train)
    order = np.argsort(dist, axis=1, kind="stable")
    g1, g2 = np.take_along_axis(dist, order[:, :2], axis=1).T
    np.testing.assert_array_equal(good, g1 < 0.25 * g2)
    assert 0 < good.sum() < m  # both sides of the threshold were planted
    np.testing.assert_array_equal(idx, order[:, 0])
    assert tmatch.near_ties["calls"] == calls + 1 and tmatch.near_ties["rows"] - rows >= m


# -- the blur products --------------------------------------------------------------

BLUR_CASES = {  # (shape, sigma): DAISY's ring increments; 600 > BANDED_BLOCK + 63 - 1 takes the band
    "dense": ((2, 70, 90), 3.5),
    "banded-rows": ((2, 600, 64), 7.826238),
    "banded-cols": ((1, 48, 640), 6.0621778),
}


def _blur_bound(x, ksize, sigma):
    """Per-value bounds on two float32 evaluations of the bf16 blur of
    ``x`` (C, H, W) that sum each product in another order: ``tight`` when
    both sides round the first axis's output to the same bf16 values,
    ``loose`` when any of them rounds to its neighbour on one side."""
    h, w = x.shape[-2:]
    r = (ksize - 1) // 2
    bh, bw = (tfilt._blur_operator(n, ksize, sigma).astype(np.float64) for n in (h, w))
    # terms an output sums: the operator's row, or the band's window
    nh, nw = ((n if n <= tfilt.BANDED_BLOCK + ksize - 1 else tfilt.BANDED_BLOCK + 2 * r) for n in (h, w))
    xb = torch.from_numpy(x).to(BF16).double().numpy()
    y1 = np.einsum("ij,cjw->ciw", bh, np.abs(xb))  # the Gaussian's taps are positive
    unit = np.ldexp(1.0, np.frexp(y1)[1] - 8)  # one bf16 unit of each first-axis value
    tight = 2 * (nw + 2) * U * np.einsum("ciw,vw->civ", y1, bw) * 1.01
    return tight, tight + np.einsum("ciw,vw->civ", unit, bw)


@pytest.mark.parametrize("case", list(BLUR_CASES))
def test_blur_bf16_matches_the_tpu_arithmetic(case):
    shape, sigma = BLUR_CASES[case]
    ksize = int(round(sigma * 4)) * 2 + 1
    x = np.random.default_rng(3).random(shape).astype(np.float32)
    got = tfilt.gaussian_blur_mxu(torch.from_numpy(x), ksize, sigma, BF16)
    assert got.dtype == F32
    got = got.numpy().astype(np.float64)
    want = np.asarray(_jax_blur_bf16(jnp.asarray(x), ksize, sigma, jax.lax.Precision.DEFAULT), np.float64)
    f32 = tfilt.gaussian_blur_mxu(torch.from_numpy(x), ksize, sigma).numpy()
    tight, loose = _blur_bound(x, ksize, sigma)
    diff = np.abs(got - want)
    assert (diff <= loose).all(), float((diff - loose).max())
    assert (diff > tight).mean() <= 0.01
    assert np.abs(got - f32).max() > 10 * tight.max()  # the bf16 route, not the float32 one


# -- DAISY ----------------------------------------------------------------------------

@pytest.mark.parametrize("normalize", [True, False], ids=["unit", "raw"])
def test_daisy_bf16_matches_jax(normalize, jax_bf16):
    rng = np.random.default_rng(31)
    img = (cv.GaussianBlur(rng.random((130, 150), np.float32), (0, 0), 1.5) * 255).astype(np.float32)
    pts = rng.uniform([0, 0], [149, 129], (60, 2)).astype(np.float32)
    got = tdaisy.daisy_at_points(torch.from_numpy(img), torch.from_numpy(pts), normalize, BF16).numpy()
    want = np.asarray(jdaisy.daisy_at_points(jnp.asarray(img), jnp.asarray(pts), normalize))
    f32 = tdaisy.daisy_at_points(torch.from_numpy(img), torch.from_numpy(pts), normalize, F32).numpy()
    diff = np.abs(got - want)
    bar = 5e-4 * (1.0 if normalize else np.linalg.norm(want, axis=1, keepdims=True))
    assert (diff <= bar).all(), float((diff / bar).max())
    assert np.abs(got - f32).max() > 10 * diff.max()  # the bf16 route, not the float32 one


# -- FeatureRegistrator ------------------------------------------------------------------

def _textured(rng, h, w, sigma):
    img = cv.GaussianBlur(rng.random((h, w), dtype=np.float32), (0, 0), sigma)
    return cv.normalize(img, None, 0, 255, cv.NORM_MINMAX, cv.CV_8U)


@pytest.fixture(scope="module")
def legacy_pair():
    """tests/test_features.py::test_fused_register_matches_legacy_driver's
    pair (the rng that tests/conftest.py gives that test) and its truth."""
    rng = np.random.default_rng(zlib.crc32(b"tests/test_features.py::TestEndToEnd::"
                                           b"test_fused_register_matches_legacy_driver"))
    ref = _textured(rng, 420, 440, 2.0)
    fwd = cv.getRotationMatrix2D((220.0, 210.0), 1.0, 1.0)
    fwd[0, 2] += 6.0
    fwd[1, 2] -= 4.0
    mov = cv.warpAffine(ref, fwd, (440, 420))
    return ref, mov, np.linalg.inv(np.vstack([fwd, [0, 0, 1]]))[:2]


def _register(reg, ref, mov, reuse=False, levels=2, log=None, tile=500):
    reg.num_pyr_lvl, reg.num_iterations, reg.tile_size, reg.use_full_res_img = levels, 2, tile, True
    if not reuse:
        reg.ref_img = ref
    reg.mov_img = mov
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        tmat = reg.register(reuse_ref_img=reuse)
    if log is not None:
        log.extend(line for line in buf.getvalue().splitlines() if "Good matches" in line)
    return tmat


@pytest.fixture
def card_route(monkeypatch):
    """The port's FeatureRegistrator on the CPU takes the route the
    variables give a CUDA device; every blur product's and knn's operand
    dtype is recorded."""
    read = treg._read_route
    monkeypatch.setattr(treg, "_read_route", lambda device: read(torch.device("cuda")))
    seen = {"blur": [], "knn": []}
    blur, top2 = tdaisy.gaussian_blur_mxu, tmatch._top2

    def blur_spy(x, ksize, sigma, operand_dtype=F32):
        seen["blur"].append(operand_dtype)
        return blur(x, ksize, sigma, operand_dtype)

    def top2_spy(query, train, t_valid, chunk, operand_dtype=F32):
        seen["knn"].append(operand_dtype)
        return top2(query, train, t_valid, chunk, operand_dtype)

    monkeypatch.setattr(tdaisy, "gaussian_blur_mxu", blur_spy)
    monkeypatch.setattr(tmatch, "_top2", top2_spy)
    return seen


def _routes_taken(seen) -> set:
    assert seen["blur"] and seen["knn"]
    return set(seen["blur"]) | set(seen["knn"])


@pytest.fixture(scope="module")
def whole_bf16(legacy_pair):
    """The port's whole route on the bf16 route, one device."""
    ref, mov, _ = legacy_pair
    with pytest.MonkeyPatch.context() as mp:
        _set(mp)
        read = treg._read_route
        mp.setattr(treg, "_read_route", lambda device: read(torch.device("cuda")))
        return _register(TReg(device="cpu"), ref, mov)


def test_feature_registrator_bf16_matches_jax(legacy_pair, whole_bf16, jax_bf16, card_route):
    ref, mov, truth = legacy_pair
    logs = [], []
    got = _register(TReg(device="cpu"), ref, mov, log=logs[0])
    assert _routes_taken(card_route) == {BF16}
    np.testing.assert_array_equal(got, whole_bf16)
    want = _register(JReg(), ref, mov, log=logs[1])
    assert logs[0][0] == logs[1][0]
    h, w = ref.shape
    pts = np.array([[0, 0, 1], [w - 1, 0, 1], [0, h - 1, 1], [w - 1, h - 1, 1]], float).T
    assert np.abs(got @ pts - want @ pts).max() < 0.1
    assert np.abs(got @ pts - truth @ pts).max() < 0.5


@pytest.mark.parametrize("route", ["FUSED_REGISTER=0", "FUSED_LEVEL=0", "FEATURE_DENSE=0", "mesh-2",
                                   "FEATURE_DENSE=0 mesh-2"])
def test_routes_take_bf16(route, legacy_pair, whole_bf16, card_route, monkeypatch):
    ref, mov, _ = legacy_pair
    env = dict(part.split("=") for part in route.split() if "=" in part)
    _set(monkeypatch, **env)
    with use_tile_mesh([torch.device("cpu")] * (2 if "mesh-2" in route else 1)):
        got = _register(TReg(device="cpu"), ref, mov)
    assert _routes_taken(card_route) == {BF16}
    np.testing.assert_array_equal(got, whole_bf16)


def test_reuse_follows_daisy_exact(legacy_pair, card_route, monkeypatch):
    """``reuse_ref_img`` keeps the reference features while the DAISY route
    is the same, and finds them again when ``DAISY_EXACT`` changes; the knn
    route of each register is its own."""
    ref, mov = (img[:240, :260] for img in legacy_pair[:2])
    _set(monkeypatch)
    reg = TReg(device="cpu")
    first = _register(reg, ref, mov, levels=1, tile=300)
    cached = reg._ref_pyr_features
    n_blur = len(card_route["blur"])
    assert _register(reg, ref, mov, reuse=True, levels=1, tile=300).tolist() == first.tolist()
    assert reg._ref_pyr_features is cached  # the reference was not found again
    assert len(card_route["blur"]) < 2 * n_blur
    monkeypatch.setenv("MICROALIGNER_TPU_MATCH_F32", "1")
    card_route["knn"].clear()
    _register(reg, ref, mov, reuse=True, levels=1, tile=300)
    assert reg._ref_pyr_features is cached and set(card_route["knn"]) == {F32}
    monkeypatch.setenv("MICROALIGNER_TPU_DAISY_EXACT", "1")
    card_route["blur"].clear()
    exact = _register(reg, ref, mov, reuse=True, levels=1, tile=300)
    assert reg._ref_pyr_features is not cached
    # the reference's levels were found again with the moving side's rounds, all float32
    assert set(card_route["blur"]) == {F32} and len(card_route["blur"]) == n_blur
    np.testing.assert_array_equal(exact, _register(TReg(device="cpu"), ref, mov, levels=1, tile=300))
