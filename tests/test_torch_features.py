"""The port's feature engine (FAST, DAISY, knn, RANSAC, tiled extraction,
matching) and DAISY's blur operators against the JAX package on the same
numpy inputs (JAX on the CPU), with the cv2 and numpy goldens of
tests/test_features.py and tests/test_daisy_golden.py.

Bars and their reasons:
* FAST score maps, top-k indices, responses and validity: bit-exact against
  JAX and against cv2.  All integer arithmetic; the top-k key is tie-free.
* DAISY descriptors: rtol 1e-4, atol 1e-5 against JAX.  Both sum the ring
  blurs' float32 products, in other orders, and XLA contracts the bilinear
  blend into FMAs.  The numpy golden keeps its own 2e-4 relative bar.
* Blur operators: 1e-5 on unit-range data (float32 sums in other orders).
* knn: the same nearest index; d1 and d2 within 1e-4 relative (float32
  sums in other orders).  Ratio tests within float32 rounding of their
  threshold: the decision of exact arithmetic (a float64 golden).
* RANSAC: the port draws other hypotheses than JAX's threefry, so the bar
  is at transform level: the four corners mapped by the two matrices agree
  within 0.05 px on a match set with 30% outliers.
* tiled features: coords, validity and responses bit-exact against JAX
  (dense and banded paths); descriptors as DAISY.
"""

import cv2 as cv
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from microaligner_tpu.features import daisy as jd
from microaligner_tpu.features import fast as jfast
from microaligner_tpu.features import match as jmatch
from microaligner_tpu.features import ransac as jransac
from microaligner_tpu.features import tile_features as jtf
from microaligner_tpu.ops import filters as jfilt
from microaligner_tpu.tiles import TileGrid as JGrid
from microaligner_tpu_torch.features import daisy as td
from microaligner_tpu_torch.features import fast as tfast
from microaligner_tpu_torch.features import match as tmatch
from microaligner_tpu_torch.features import ransac as transac
from microaligner_tpu_torch.features import tile_features as ttf
from microaligner_tpu_torch.ops import filters as tfilt
from microaligner_tpu_torch.tiles import TileGrid

from test_daisy_golden import np_daisy

torch.set_num_threads(1)


def _textured(rng, h, w, sigma=1.5):
    img = cv.GaussianBlur(rng.random((h, w), dtype=np.float32), (0, 0), sigma)
    return cv.normalize(img, None, 0, 255, cv.NORM_MINMAX, cv.CV_8U)


@pytest.mark.parametrize("seed,shape", [(1, (120, 130)), (7, (97, 180))])
def test_fast_score_map_matches_jax_and_cv2(seed, shape):
    img = _textured(np.random.default_rng(seed), *shape)
    got = tfast.fast_score_map(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jfast.fast_score_map(jnp.asarray(img))))
    det = cv.FastFeatureDetector_create(threshold=1, nonmaxSuppression=True,
                                        type=cv.FAST_FEATURE_DETECTOR_TYPE_9_16)
    cvset = {(int(k.pt[0]), int(k.pt[1])): k.response for k in det.detect(img)}
    ours = {(x, y): float(got[y, x]) for y, x in zip(*np.nonzero(got))}
    assert set(cvset) == set(ours)
    assert all(abs(cvset[c] - ours[c]) < 0.5 for c in cvset)


def test_fast_u16_scores_match_jax(rng):
    img = (_textured(rng, 60, 70).astype(np.uint16) * 200)
    np.testing.assert_array_equal(tfast.fast_score_map(torch.from_numpy(img)).numpy(),
                                  np.asarray(jfast.fast_score_map(jnp.asarray(img))))


def test_fast_topk_and_grid_match_jax(rng):
    img = _textured(rng, 96, 128)
    got = tfast.fast_detect_topk(torch.from_numpy(img), 150)
    want = jfast.fast_detect_topk(jnp.asarray(img), 150)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    got = tfast.fast_detect_topk_grid(torch.from_numpy(img), 48, 64, 40)
    want = jfast.fast_detect_topk_grid(jnp.asarray(img), 48, 64, 40)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_topk_stable_sort_branch_keeps_scan_order():
    """Rows past 8.4 Mpix overflow the int32 key and take the stable sort:
    ties keep scan order (numpy's stable argsort is the golden)."""
    n = 2920 * 2920
    rng = np.random.default_rng(3)
    s = np.zeros(n, np.int32)
    s[rng.integers(0, n, 500)] = rng.integers(1, 4, 500)
    idx, resp, valid = tfast._topk_rows(torch.from_numpy(s), 300, 1)
    want = np.argsort(-s, kind="stable")[:300]
    np.testing.assert_array_equal(idx.numpy(), want)
    np.testing.assert_array_equal(resp.numpy(), s[want].astype(np.float32))
    np.testing.assert_array_equal(valid.numpy(), s[want] >= 1)


@pytest.mark.parametrize("shape,ksize,sigma", [((2, 40, 50), 29, 3.5), ((1, 600, 30), 49, 6.06),
                                               ((1, 20, 700), 63, 7.83), ((3, 9, 12), 29, 3.5)])
def test_blur_mxu_matches_jax(rng, shape, ksize, sigma):
    x = rng.random(shape).astype(np.float32)
    got = tfilt.gaussian_blur_mxu(torch.from_numpy(x), ksize, sigma).numpy()
    want = np.asarray(jfilt.gaussian_blur_mxu(jnp.asarray(x), ksize, sigma,
                                              precision=jax.lax.Precision.HIGHEST))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def daisy_img():
    return _textured(np.random.default_rng(11), 150, 140, sigma=2.0).astype(np.float32)


def _daisy_points(rng):
    pts = np.stack([rng.uniform(-5, 145, 40), rng.uniform(-5, 155, 40)], axis=-1)
    return np.concatenate([pts, [[0.0, 0.0], [139.0, 149.0], [70.25, 3.5]]]).astype(np.float32)


@pytest.mark.parametrize("normalize", [True, False])
def test_daisy_matches_jax(rng, daisy_img, normalize):
    pts = _daisy_points(rng)
    got = td.daisy_at_points(torch.from_numpy(daisy_img), torch.from_numpy(pts), normalize).numpy()
    want = np.asarray(jd.daisy_at_points(jnp.asarray(daisy_img), jnp.asarray(pts), normalize))
    assert got.shape == (len(pts), td.DAISY_DIM)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_daisy_matches_numpy_golden(rng, daisy_img):
    pts = _daisy_points(rng)[:12]
    got = td.daisy_at_points(torch.from_numpy(daisy_img), torch.from_numpy(pts), normalize=False).numpy()
    want = np_daisy(daisy_img, pts)
    assert np.max(np.abs(got - want)) / np.abs(want).max() < 2e-4


def _desc(rng, n, d=200):
    x = rng.random((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.mark.parametrize("q,t,chunk", [(300, 260, 4096), (130, 50, 32)])
def test_knn_top2_matches_jax(rng, q, t, chunk):
    query, train = _desc(rng, q), _desc(rng, t)
    train[:20] = query[:20] + 0.01 * rng.random((20, 200)).astype(np.float32)  # clear nearest
    qv, tv = rng.random(q) > 0.1, rng.random(t) > 0.1
    d1, d2, i1 = tmatch.knn_top2(*(torch.from_numpy(a) for a in (query, train, qv, tv)), chunk=chunk)
    w1, w2, wi = (np.asarray(a) for a in jmatch.knn_top2(*(jnp.asarray(a) for a in (query, train, qv, tv))))
    np.testing.assert_array_equal(i1.numpy(), wi)
    np.testing.assert_allclose(d1.numpy(), w1, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(d2.numpy(), w2, rtol=1e-4, atol=1e-6)
    good, idx = tmatch.match_descriptors(*(torch.from_numpy(a) for a in (train, query, tv, qv)))
    jgood, jidx = jmatch.match_descriptors(*(jnp.asarray(a) for a in (train, query, tv, qv)))
    np.testing.assert_array_equal(good.numpy(), np.asarray(jgood))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))


def test_ratio_near_ties_decided_in_float64(rng):
    """Queries planted with d1 = 0.25 d2 (1 + e), |e| ~ 1e-7, below
    float32's resolution of the distances: every ratio test and nearest
    index equals a float64 golden on the same float32 descriptors."""
    n, d = 48, 200
    basis = np.linalg.qr(rng.standard_normal((d, d)))[0]
    eps = rng.uniform(-3e-7, 3e-7, n)
    # query i, its nearest and its runner-up share an offset 4 o_i that
    # keeps the other queries' rows at a squared distance of 32 or more
    offset = 4.0 * basis[3::4][:n]
    query = basis[0::4][:n] + offset
    near = basis[1::4][:n] * np.sqrt(1.0 + 2.0 * eps)[:, None] + offset  # d1 = 2 (1 + e)
    far = basis[2::4][:n] * np.sqrt(7.0) + offset  # d2 = 8
    train = np.concatenate([near, far, 10.0 * _desc(rng, 40)]).astype(np.float32)
    query = query.astype(np.float32)
    qv, tv = np.ones(n, bool), np.ones(len(train), bool)
    good, idx = tmatch.match_descriptors(*(torch.from_numpy(a) for a in (train, query, tv, qv)))
    dist = ((query[:, None, :].astype(np.float64) - train[None].astype(np.float64)) ** 2).sum(-1)
    order = np.argsort(dist, axis=1)
    d1, d2 = np.take_along_axis(dist, order[:, :2], axis=1).T
    np.testing.assert_array_equal(good.numpy(), d1 < 0.25 * d2)
    assert 0 < good.numpy().sum() < n  # both sides of the threshold were planted
    np.testing.assert_array_equal(idx.numpy(), order[:, 0])


CORNERS = np.array([[0, 0, 1], [1000, 0, 1], [0, 1000, 1], [1000, 1000, 1]], float).T


def test_ransac_matches_jax_at_the_corners(rng):
    n = 400
    src = rng.uniform(0, 1000, (n, 2)).astype(np.float32)
    ang, s, tx, ty = 0.03, 1.01, 12.0, -7.0
    a, b = s * np.cos(ang), s * np.sin(ang)
    dst = np.stack([a * src[:, 0] - b * src[:, 1] + tx, b * src[:, 0] + a * src[:, 1] + ty], -1)
    dst += rng.normal(0, 0.3, dst.shape)
    out = rng.choice(n, int(0.3 * n), replace=False)  # 30% outliers
    dst[out] += rng.uniform(-300, 300, (len(out), 2))
    valid = np.ones(n, bool)
    valid[:15] = False
    got, count = transac.estimate_affine_partial_2d(src, dst.astype(np.float32), valid, seed=0)
    want, wcount = jransac.estimate_affine_partial_2d(src, dst.astype(np.float32), valid)
    assert np.abs(got @ CORNERS - want @ CORNERS).max() < 0.05
    assert np.abs(got @ CORNERS - np.array([[a, -b, tx], [b, a, ty]]) @ CORNERS).max() < 1.0
    assert abs(count - wcount) <= 2 and count > 0.6 * n


def test_ransac_degenerate_and_draws():
    tmat, count = transac.estimate_affine_partial_2d(np.zeros((5, 2)), np.zeros((5, 2)),
                                                     valid=np.zeros(5, bool))
    np.testing.assert_array_equal(tmat, np.eye(2, 3))
    assert count == 0
    # the hypotheses' draws come from a seeded CPU generator, the same each call
    assert torch.equal(transac._uniforms(0, 2048), transac._uniforms.__wrapped__(0, 2048))
    assert not torch.equal(transac._uniforms(0, 2048), transac._uniforms.__wrapped__(1, 2048))


@pytest.mark.parametrize("path", ["dense", "banded"])
def test_tiled_features_match_jax(path):
    img = _textured(np.random.default_rng(5), 150, 170, sigma=1.5)
    grid, jgrid = TileGrid.for_image(img.shape, 64, 51), JGrid.for_image(img.shape, 64, 51)
    k = 60
    fn = ttf._find_features_dense if path == "dense" else ttf._find_features_banded
    got = fn(torch.from_numpy(img), grid, k, True)
    if path == "dense":
        want = jax.jit(jtf._find_features_dense, static_argnums=(1, 2, 3))(jnp.asarray(img), jgrid, k, True)
    else:  # the JAX band map runs inside a trace, over no mesh
        want = jax.jit(jtf._find_features_banded, static_argnums=(1, 2, 3, 4))(
            jnp.asarray(img), jgrid, k, None, True)
    for i in (0, 2, 3):  # coords, valid, responses
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-4, atol=1e-5)


def test_find_features_blank_and_dispatch():
    assert not ttf.find_features(np.zeros((120, 120), np.uint8), 1000, device="cpu").is_valid()
    img = _textured(np.random.default_rng(2), 140, 150)
    f = ttf.find_features(img, 100, device="cpu")  # 4 tiles of 10^4 px, 5000 keypoints each
    grid = TileGrid.for_image(img.shape, 100, 51)
    assert f.coords.shape == (grid.num_tiles * ttf.features_per_tile(grid), 2)
    assert f.is_valid() and f.num_valid == int(f.valid.sum())


@pytest.fixture(scope="module")
def hard_pair():
    """tests/test_features.py's rotation + scale + noise + intensity case,
    with 500 px tiles (one tile, as there, on a smaller padded canvas)."""
    rng = np.random.default_rng(11)
    fine = cv.GaussianBlur(rng.random((460, 480), dtype=np.float32), (0, 0), 1.2)
    coarse = cv.GaussianBlur(rng.random((460, 480), dtype=np.float32), (0, 0), 6.0)
    ref = cv.normalize(fine + 2 * coarse, None, 0, 255, cv.NORM_MINMAX, cv.CV_8U)
    fwd = cv.getRotationMatrix2D((240.0, 230.0), 5.0, 1.05)
    fwd[0, 2] += 6.0
    fwd[1, 2] -= 4.0
    mov = cv.warpAffine(ref, fwd, (480, 460)).astype(np.float32)
    mov = np.clip(mov * 0.7 + 20 + rng.normal(0, 3.0, mov.shape), 0, 255).astype(np.uint8)
    want = jtf.match_features(jtf.find_features(ref, 500), jtf.find_features(mov, 500))
    return ref, mov, fwd, want


def test_match_features_hard_transform(hard_pair):
    ref, mov, fwd, want = hard_pair
    got = ttf.match_features(ttf.find_features(ref, 500, device="cpu"),
                             ttf.find_features(mov, 500, device="cpu"))
    gy, gx = np.mgrid[0:460:20, 0:480:20].astype(np.float64)
    pts = np.stack([gx.ravel(), gy.ravel(), np.ones(gx.size)])
    assert np.abs(got @ pts - want @ pts).max() < 0.1
    inv = cv.invertAffineTransform(fwd)
    expected = inv.copy()  # the reference's (-51, -51) DAISY sampling quirk
    expected[:, 2] += (inv[:2, :2] - np.eye(2)) @ np.array([-51.0, -51.0])
    np.testing.assert_allclose(got[:2, :2], inv[:2, :2], atol=0.02)
    assert np.abs(got @ pts - expected @ pts).mean() < 1.5
