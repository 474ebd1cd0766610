"""K1-K4 on the card against their plain PyTorch versions on the same card.

These tests need an NVIDIA GPU and nvcc: the kernels are CUDA C++ with no
CPU build, so without a card every test here skips.  The file imports only
torch and numpy, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

Each kernel rounds at the same places, in the same order, as its plain
version (no FMA contraction), so the bars below are upper bounds on what
is expected to be bitwise equal: K1 atol 1e-5 on unit-range data, K2/K4
1e-5 x max|plain| + 1e-6, K3 1e-4 px.
"""

import numpy as np
import pytest
import torch

from microaligner_tpu_torch.ops import kernel_agg, kernel_matrices, kernel_poly, kernel_sample
from microaligner_tpu_torch.ops.filters import gaussian_blur
from microaligner_tpu_torch.optflow import farneback as tfb

torch.set_num_threads(1)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K1-K4 are CUDA C++ and have no CPU build")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture
def gen(request):
    import zlib

    return np.random.default_rng(zlib.crc32(request.node.nodeid.encode()))


def _rel_err(got, want):
    return float((got - want).abs().max()), 1e-5 * float(want.abs().max()) + 1e-6


def _smooth_pair(gen, dev, n, h, w):
    """A smooth texture and a copy shifted by (1.5, -0.75) px, 0-255."""
    base = torch.from_numpy(gen.random((n, h + 8, w + 8), dtype=np.float32)).to(dev)
    base = gaussian_blur(base, 9, 2.0) * 255
    return base[:, 4 : 4 + h, 4 : 4 + w].contiguous(), base[:, 3 : 3 + h, 5 : 5 + w].contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("shape,spread", [((1, 512, 700), 4.0), ((2, 9, 45), 41.0), ((1, 300, 1001), 0.0)])
def test_k1(gen, dev, shape, spread):
    img = torch.from_numpy(gen.random(shape, dtype=np.float32)).to(dev)
    fx = torch.from_numpy(((gen.random(shape) - 0.5) * spread).astype(np.float32)).to(dev)
    fy = torch.from_numpy(((gen.random(shape) - 0.5) * spread).astype(np.float32)).to(dev)
    launches = kernel_sample.sample_displaced.launches
    got = kernel_sample.sample_displaced(img, fx, fy)
    torch.cuda.synchronize()
    assert kernel_sample.sample_displaced.launches == launches + 1
    torch.testing.assert_close(got, kernel_sample.sample_displaced_plain(img, fx, fy), atol=1e-5, rtol=0)


def _k2_inputs(gen, dev, n, h, w):
    mov, ref = _smooth_pair(gen, dev, n, h, w)
    return (tfb._pad_replicate1(tfb._pre_smooth(mov)), tfb._pad_replicate1(tfb._pre_smooth(ref)),
            tfb._poly_coeff_tuple(1, 1.7))


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w", [(1, 300, 1001), (2, 9, 45)])
def test_k2(gen, dev, n, h, w):
    a, b, coeffs = _k2_inputs(gen, dev, n, h, w)
    got = kernel_poly.poly_pair_m(a, b, coeffs)
    want = kernel_poly.poly_pair_m_plain(a, b, coeffs)
    for g, wv in zip(got, want):
        err, bound = _rel_err(g, wv)
        assert err <= bound


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,win", [(1, 300, 1001, 99), (2, 12, 45, 11), (1, 70, 300, 257)])
def test_k3(gen, dev, n, h, w, win):
    a, b, coeffs = _k2_inputs(gen, dev, n, h, w)
    M = kernel_poly.poly_pair_m_plain(a, b, coeffs)[2]
    fx, fy = kernel_agg.smooth5_solve(M, win)
    rx, ry = kernel_agg.smooth5_solve_plain(M, win)
    torch.testing.assert_close(fx, rx, atol=1e-4, rtol=0)
    torch.testing.assert_close(fy, ry, atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,win", [((1, 5, 300, 1001), 99), ((2, 3, 9, 45), 11)])
def test_k3_row_pass(gen, dev, shape, win):
    x = torch.from_numpy(gen.random(shape, dtype=np.float32)).to(dev)
    launches = kernel_agg.smooth_w.launches
    got = kernel_agg.smooth_w(x, win)
    assert kernel_agg.smooth_w.launches == launches + 1
    torch.testing.assert_close(got, kernel_agg.smooth_w_plain(x, win), atol=1e-5, rtol=0)


@pytest.mark.cuda
def test_k3_rejects_window_beyond_staging_limit(dev):
    M = torch.zeros((1, 5, 20, 20), device=dev)
    with pytest.raises(ValueError):
        kernel_agg.smooth5_solve(M, 2 * kernel_agg.MAX_HALF_WINDOW + 3)


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,spread", [(1, 300, 1001, 6.0), (1, 9, 45, 40.0)])
def test_k4(gen, dev, n, h, w, spread):
    a, b, coeffs = _k2_inputs(gen, dev, n, h, w)
    r0, r1, _ = kernel_poly.poly_pair_m_plain(a, b, coeffs)
    fx = torch.from_numpy(((gen.random((n, h, w)) - 0.5) * spread).astype(np.float32)).to(dev)
    fy = torch.from_numpy(((gen.random((n, h, w)) - 0.5) * spread).astype(np.float32)).to(dev)
    err, bound = _rel_err(kernel_matrices.update_matrices(r0, r1, fx, fy),
                          kernel_matrices.update_matrices_plain(r0, r1, fx, fy))
    assert err <= bound


@pytest.mark.cuda
def test_farneback_on_card_matches_cpu(gen, dev):
    """The whole Farneback call through K2-K4 on the card against the plain
    versions on the CPU."""
    mov, ref = _smooth_pair(gen, dev, 1, 200, 260)
    got = tfb.farneback(mov[0], ref[0], win_size=51, num_iter=3)
    want = tfb.farneback(mov[0].cpu(), ref[0].cpu(), win_size=51, num_iter=3)
    err = (got.cpu() - want).abs()
    assert float(err.mean()) < 1e-4 and float(err.max()) < 1e-2
