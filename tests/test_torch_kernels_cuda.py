"""K1-K5 on the card against their plain PyTorch versions on the same card,
and the pinned, streamed apply of the CLI on the card.

These tests need an NVIDIA GPU and nvcc: the kernels are CUDA C++ with no
CPU build, so without a card every test here skips.  The file imports only
torch and numpy, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

Each kernel rounds at the same places, in the same order, as its plain
version (no FMA contraction), so the bars below are upper bounds on what
is expected to be bitwise equal: K1 atol 1e-5 on unit-range data, K2/K4
1e-5 x max|plain| + 1e-6, K3 1e-4 px.  K5 is held to its plain version and
to one K1 launch per plane with no tolerance: it rounds as K1 does.
"""

import numpy as np
import pytest
import torch

from microaligner_tpu_torch.ops import kernel_agg, kernel_matrices, kernel_poly, kernel_sample
from microaligner_tpu_torch.ops.filters import gaussian_blur
from microaligner_tpu_torch.optflow import farneback as tfb
from microaligner_tpu_torch.pipeline.apply import stream_apply
from microaligner_tpu_torch.pipeline.runner import _apply_flow_plane, _apply_flow_planes
from microaligner_tpu_torch.tiles import TileGrid

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


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,spread", [(3, 300, 1001, 40.0), (2, 9, 45, 41.0), (1, 37, 70, 0.0)])
def test_k5(gen, dev, n, h, w, spread):
    imgs = torch.from_numpy(gen.random((n, h, w), dtype=np.float32)).to(dev)
    fx = torch.from_numpy(((gen.random((h, w)) - 0.5) * spread).astype(np.float32)).to(dev)
    fy = torch.from_numpy(((gen.random((h, w)) - 0.5) * spread).astype(np.float32)).to(dev)
    launches = kernel_sample.sample_displaced_multi.launches
    got = kernel_sample.sample_displaced_multi(imgs, fx, fy)
    torch.cuda.synchronize()
    assert kernel_sample.sample_displaced_multi.launches == launches + 1
    assert torch.equal(got, kernel_sample.sample_displaced_multi_plain(imgs, fx, fy))
    per_plane = kernel_sample.sample_displaced(imgs, fx.expand(n, h, w).contiguous(),
                                               fy.expand(n, h, w).contiguous())
    assert torch.equal(got, per_plane)


@pytest.mark.cuda
def test_apply_flow_planes_multi_equals_per_plane_on_card(gen, dev):
    planes = torch.from_numpy(gen.integers(0, 65535, (3, 260, 300)).astype(np.uint16)).to(dev)
    flow = torch.from_numpy(((gen.random((260, 300, 2)) - 0.5) * 8).astype(np.float32)).to(dev)
    grid = TileGrid.for_image((260, 300), 120, 20)
    launches = kernel_sample.sample_displaced_multi.launches
    multi = _apply_flow_planes(planes, flow, grid, torch.uint16, band_rows=64)
    assert kernel_sample.sample_displaced_multi.launches == launches + 5  # one a band
    single = torch.stack([_apply_flow_plane(p, flow, grid, torch.uint16, band_rows=64) for p in planes])
    assert multi.dtype == torch.uint16 and torch.equal(multi, single)


@pytest.mark.cuda
def test_stream_apply_pinned_on_card(gen, dev):
    """The reader's pinned ring and side stream, and the writer's pinned
    copy back, keep every plane and its order (more planes than buffers)."""
    import threading

    planes = [(i, gen.integers(0, 65535, (64 + i, 70)).astype(np.uint16)) for i in range(7)]
    got, errors = {}, []

    def run():
        try:
            stream_apply(iter(planes), lambda t: (t.to(torch.float32) * 0.5).round().to(torch.uint16),
                         lambda k, v: got.__setitem__(k, v.copy()), device=dev)
        except Exception as e:  # reported below
            errors.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive() and not errors, errors
    for k, p in planes:
        np.testing.assert_array_equal(got[k], np.round(p.astype(np.float32) * 0.5).astype(np.uint16))
