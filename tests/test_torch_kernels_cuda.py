"""K1-K6 on the card against their plain PyTorch versions on the same card,
the affine warp through K1's row window, the unpaired Farneback route
(K6), the matcher's near-ties, and the pinned, streamed apply of the CLI on
the card.

These tests need an NVIDIA GPU and nvcc: the kernels are CUDA C++ with no
CPU build, so without a card every test here skips.  The file imports only
torch and numpy, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

K1, K2 and K4-K6 round at the same places, in the same order, as their
plain versions (no FMA contraction).  K1 is held to its plain version bit
for bit; K2/K4 to 1e-5 x max|plain| + 1e-6, an upper bound on what is
expected to be bitwise equal.  K5 is held to its plain version and to one K1
launch per plane with no tolerance: it rounds as K1 does, in its staged
branch (the tile's taps in shared memory) and its direct one; its band
entry (the band warps of one plane and of the z-stack, stored dtypes in
and out, the flow as the whole field or a band's slab-coordinate pair) is
held bit for bit to its plain version, at one plane and at N.  K6 is held bit
for bit to its plain version and to K2's expansions (the same moments5
device function), and K1's row window bit for bit to the plain version's.

The per-tile route (``MICROALIGNER_TPU_FLOW_DENSE=0``) is held on the card
too: K2-K4 at its chunk of 8 halo windows of 1200^2, its warp bit for bit
and its fused flow and warp against the plain versions on the CPU, and a
register on it that launches K1-K4 and never K5.

K3 sums each tap with one fused multiply-add, which rounds once where the
plain version's multiply and add round twice, so it is not bit-equal to its
plain version: it is held to 1e-4 px of it, and against the plain version
run in float64 its max and mean error must be no larger than the float32
plain version's (plus 1e-6 px) and within the bars that
``tests/test_torch_kernel_agg.py`` holds the plain version to on the CPU.
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
        pytest.skip("needs an NVIDIA GPU: K1-K6 are CUDA C++ and have no CPU build")
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
    assert torch.equal(got, kernel_sample.sample_displaced_plain(img, fx, fy))


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


F64_MAX_PX, F64_MEAN_PX, F64_SLACK_PX = 2e-5, 1e-6, 1e-6  # K3 against float64, as on the CPU


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,win", [
    pytest.param(1, 300, 1001, 99, id="win99-ragged-width"),
    pytest.param(2, 12, 45, 11, id="win11-n2-h12"),
    pytest.param(1, 70, 300, 257, id="win257-h-below-r"),
    pytest.param(2, 40, 30, 99, id="win99-n2-h-and-w-below-r"),
    pytest.param(1, 515, 100, 257, id="win257-w-below-r-three-tiles"),
    pytest.param(2, 260, 520, 11, id="win11-n2-aligned-width"),
    pytest.param(1, 3, 2, 99, id="win99-h3-w2"),
])
def test_k3(gen, dev, n, h, w, win):
    a, b, coeffs = _k2_inputs(gen, dev, n, h, w)
    M = kernel_poly.poly_pair_m_plain(a, b, coeffs)[2]
    launches = kernel_agg.smooth5_solve.launches
    got = kernel_agg.smooth5_solve(M, win)
    torch.cuda.synchronize()
    assert kernel_agg.smooth5_solve.launches == launches + 1
    plain = kernel_agg.smooth5_solve_plain(M, win)
    exact = kernel_agg.smooth5_solve_plain(M.double(), win)
    for g, p, e in zip(got, plain, exact):
        torch.testing.assert_close(g, p, atol=1e-4, rtol=0)
        kern_err, plain_err = (g.double() - e).abs(), (p.double() - e).abs()
        assert float(kern_err.max()) <= min(float(plain_err.max()) + F64_SLACK_PX, F64_MAX_PX)
        assert float(kern_err.mean()) <= min(float(plain_err.mean()) + F64_SLACK_PX, F64_MEAN_PX)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,win", [((1, 5, 300, 1001), 99), ((2, 3, 9, 45), 11), ((1, 7, 40, 30), 257)])
def test_k3_row_pass(gen, dev, shape, win):
    x = torch.from_numpy(gen.random(shape, dtype=np.float32)).to(dev)
    launches = kernel_agg.smooth_w.launches
    got = kernel_agg.smooth_w(x, win)
    assert kernel_agg.smooth_w.launches == launches + 1
    torch.testing.assert_close(got, kernel_agg.smooth_w_plain(x, win), atol=1e-5, rtol=0)


@pytest.mark.cuda
def test_k3_rejects_window_beyond_staging_limit(dev):
    """r > 128 fits neither the tap table in the kernels' parameters (257
    taps) nor, much beyond it, two staged tiles in a block's shared memory."""
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
@pytest.mark.parametrize("n,h,w", [(2, 300, 1001), (1, 1, 45), (3, 2, 3), (1, 40, 1)])
def test_k6(gen, dev, n, h, w):
    a, b, coeffs = _k2_inputs(gen, dev, n, h, w)
    launches = kernel_poly.poly_exp5.launches
    got = kernel_poly.poly_exp5(a, coeffs)
    torch.cuda.synchronize()
    assert kernel_poly.poly_exp5.launches == launches + 1
    assert torch.equal(got, kernel_poly.poly_exp5_plain(a, coeffs))
    assert torch.equal(got, kernel_poly.poly_pair_m(a, b, coeffs)[0])


@pytest.mark.cuda
def test_unpaired_route_on_card_equals_default(gen, dev, monkeypatch):
    mov, ref = _smooth_pair(gen, dev, 2, 200, 260)
    monkeypatch.delenv("MICROALIGNER_TPU_PALLAS_POLY", raising=False)
    want = tfb._farneback_core_parts(mov, ref, 51, 3, 1, 1.7)
    monkeypatch.setenv("MICROALIGNER_TPU_PALLAS_POLY", "1")
    k2, k6 = kernel_poly.poly_pair_m.launches, kernel_poly.poly_exp5.launches
    got = tfb._farneback_core_parts(mov, ref, 51, 3, 1, 1.7)
    torch.cuda.synchronize()
    assert kernel_poly.poly_pair_m.launches == k2 and kernel_poly.poly_exp5.launches == k6 + 2
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("oh,ow,row0", [(37, 1001, 100), (300, 700, 0), (5, 9, 290)])
def test_k1_row_window(gen, dev, oh, ow, row0):
    img = torch.from_numpy(gen.random((2, 300, 1001), dtype=np.float32)).to(dev)
    fx = torch.from_numpy(((gen.random((2, oh, ow)) - 0.5) * 30).astype(np.float32)).to(dev)
    fy = torch.from_numpy(((gen.random((2, oh, ow)) - 0.5) * 30).astype(np.float32)).to(dev)
    got = kernel_sample.sample_displaced(img, fx, fy, row0=row0)
    assert torch.equal(got, kernel_sample.sample_displaced_plain(img, fx, fy, row0=row0))


@pytest.mark.cuda
def test_affine_warp_on_card_matches_cpu(gen, dev):
    from microaligner_tpu_torch.ops.affine_tiled import affine_warp_bands, affine_warp_traced
    from microaligner_tpu_torch.ops.warp import inverse_of

    img = torch.from_numpy(gen.random((700, 900), dtype=np.float32) * 255)
    t = np.array([[1.0004, 0.0003, 37.4], [-0.0003, 1.0004, -21.7]])
    launches = kernel_sample.sample_displaced.launches
    got = affine_warp_bands(img.to(dev), inverse_of(t), 700, 900, band_rows=128)
    assert kernel_sample.sample_displaced.launches == launches + 6
    assert torch.equal(got.cpu(), affine_warp_bands(img, inverse_of(t), 700, 900, band_rows=128))
    fwd = torch.from_numpy(t.astype(np.float32))
    got = affine_warp_traced(img.to(dev), fwd.to(dev))
    assert torch.equal(got.cpu(), affine_warp_traced(img, fwd))


@pytest.mark.cuda
def test_apply_flow_planes_multi_equals_per_plane_on_card(gen, dev):
    planes = torch.from_numpy(gen.integers(0, 65535, (3, 260, 300)).astype(np.uint16)).to(dev)
    flow = torch.from_numpy(((gen.random((260, 300, 2)) - 0.5) * 8).astype(np.float32)).to(dev)
    grid = TileGrid.for_image((260, 300), 120, 20)
    launches = kernel_sample.sample_band_multi.launches
    multi = _apply_flow_planes(planes, flow, grid, torch.uint16, band_rows=64)
    assert kernel_sample.sample_band_multi.launches == launches + 5  # one a band
    single = torch.stack([_apply_flow_plane(p, flow, grid, torch.uint16, band_rows=64) for p in planes])
    assert multi.dtype == torch.uint16 and torch.equal(multi, single)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["uint8", "int8", "uint16", "int16", "int32", "float32"])
@pytest.mark.parametrize("w", [4096, 4100])
def test_one_plane_band_warp_on_card(gen, dev, name, w):
    """The one-plane band warp (``_apply_flow_plane``), one launch of K5's
    band entry a band of 64 rows (the last band 2 rows) and no K1, against
    the band entry's plain version on the card, at an aligned width and at
    4100 (rows not on 16 bytes for 8- and 16-bit planes)."""
    h, dt = 130, getattr(torch, name)
    img = torch.from_numpy(_stack(gen, name, 1, h, w)).to(dev)
    flow = torch.from_numpy(((gen.random((h, w, 2)) - 0.5) * 12).astype(np.float32)).to(dev)
    grid = TileGrid.for_image((h, w), 120, 20)
    launches, k1 = kernel_sample.sample_band_multi.launches, kernel_sample.sample_displaced.launches
    got = _apply_flow_plane(img[0], flow, grid, dt, band_rows=64)
    torch.cuda.synchronize()
    assert kernel_sample.sample_band_multi.launches == launches + 3 and kernel_sample.sample_displaced.launches == k1
    want = torch.empty_like(img)
    for row0 in range(0, h, 64):
        kernel_sample.sample_band_multi_plain(img, flow, want, row0, 64, 20)
    assert got.dtype == dt and torch.equal(got, want[0])


@pytest.mark.cuda
def test_band_entry_slab_flow_on_card(gen, dev):
    """The banded Farneback's post-warp: the band's own flow in slab
    coordinates, its halo not read."""
    h, w, rows, o = 100, 336, 40, 12
    img = torch.from_numpy(_stack(gen, "uint16", 1, h, w)).to(dev)
    got, want = torch.zeros_like(img), torch.zeros_like(img)
    for row0 in range(0, h, rows):
        slab = torch.from_numpy(((gen.random((2, rows + 2 * o, w + 2 * o)) - 0.5) * 30).astype(np.float32)).to(dev)
        kernel_sample.sample_band_multi(img, (slab[0], slab[1]), got, row0, rows, o)
        kernel_sample.sample_band_multi_plain(img, (slab[0], slab[1]), want, row0, rows, o)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_band_entry_int32_max_equals_cpu(dev):
    """An int32 plane at its maximum: the kernel's store saturates as the
    CPU's rounding does."""
    img = torch.full((1, 40, 72), 2**31 - 1, dtype=torch.int32)
    img[..., ::2] = 2**31 - 100
    flow = torch.full((40, 72, 2), 0.5)
    want = kernel_sample.sample_band_multi_plain(img, flow, torch.empty_like(img), 0, 40, 5)
    got = kernel_sample.sample_band_multi(img.to(dev), flow.to(dev), torch.empty_like(img, device=dev), 0, 40, 5)
    assert int(want.max()) == 2**31 - 1 and torch.equal(got.cpu(), want)


def _smooth_flow(h, w, dev, amp=2.0):
    """The z-stack apply's kind of flow: (amp sin(y / 50), 0.75 amp cos(x / 45))."""
    ys = torch.arange(h, device=dev, dtype=torch.float32).view(h, 1).expand(h, w)
    xs = torch.arange(w, device=dev, dtype=torch.float32).view(1, w).expand(h, w)
    return (amp * torch.sin(ys / 50)).contiguous(), (0.75 * amp * torch.cos(xs / 45)).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,kind", [
    pytest.param(3, 300, 1001, "smooth", id="odd-width-direct"),
    pytest.param(2, 9, 45, "smooth", id="h9-w45"),
    pytest.param(2, 9, 48, "smooth", id="h9-w48"),
    pytest.param(5, 260, 520, "smooth", id="aligned-width-5-planes"),
    pytest.param(2, 300, 1000, "shift", id="constant-shift-beyond-the-tile"),
    pytest.param(2, 300, 1024, "mixed", id="half-staged-half-direct"),
])
def test_k5_staged_branch(gen, dev, n, h, w, kind):
    """Tiles whose taps fit the staged window sum from shared memory, the
    others gather from global memory, as do all tiles of planes whose rows
    are not on 16 bytes; both branches equal the plain version and K1."""
    imgs = torch.from_numpy(gen.random((n, h, w), dtype=np.float32)).to(dev)
    fx, fy = _smooth_flow(h, w, dev)
    if kind == "shift":
        fx, fy = fx + 30.25, fy - 17.5
    elif kind == "mixed":
        noise = torch.from_numpy(((gen.random((2, h, w // 2)) - 0.5) * 40).astype(np.float32)).to(dev)
        fx, fy = fx.clone(), fy.clone()
        fx[:, w // 2 :], fy[:, w // 2 :] = noise[0], noise[1]
    staged = torch.zeros(1, dtype=torch.int32, device=dev)
    got = kernel_sample.sample_displaced_multi(imgs, fx, fy, staged=staged)
    tiles = -(-h // kernel_sample.K5_TILE[0]) * -(-w // kernel_sample.K5_TILE[1])
    if (w * 4) % 16:
        assert int(staged.item()) == 0
    else:
        assert 0 < int(staged.item()) <= tiles
    if kind == "mixed":
        assert int(staged.item()) < tiles
    assert torch.equal(got, kernel_sample.sample_displaced_multi_plain(imgs, fx, fy))
    per_plane = kernel_sample.sample_displaced(imgs, fx.expand(n, h, w).contiguous(),
                                               fy.expand(n, h, w).contiguous())
    assert torch.equal(got, per_plane)


def _stack(gen, name, n, h, w):
    base = gen.integers(0, 65535, (n, h, w))
    return {"uint8": base % 256, "int8": base % 256 - 128, "uint16": base, "int16": base - 32768,
            "int32": (base - 32768) * 65535, "float32": base / 65535.0}[name].astype(name)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["uint8", "int8", "uint16", "int16", "int32", "float32"])
@pytest.mark.parametrize("w,amp", [(301, 2.0), (304, 2.0), (304, 30.0)])
def test_band_entry_on_card(gen, dev, name, w, amp):
    """The z-stack apply, one K5 launch a band of 64 rows (the last band 4
    rows), against the band entry's plain version and K1 a plane; widths
    whose rows are on 16 bytes (staged) or not (direct), and a flow beyond
    the overlap."""
    h, dt = 260, getattr(torch, name)
    imgs = torch.from_numpy(_stack(gen, name, 3, h, w)).to(dev)
    fx, fy = _smooth_flow(h, w, dev, amp)
    flow = torch.stack([fx, fy], dim=-1).contiguous()
    grid = TileGrid.for_image((h, w), 120, 20)
    launches = kernel_sample.sample_band_multi.launches
    got = _apply_flow_planes(imgs, flow, grid, dt, band_rows=64)
    torch.cuda.synchronize()
    assert kernel_sample.sample_band_multi.launches == launches + 5 and got.dtype == dt
    want = torch.empty_like(got)
    for row0 in range(0, h, 64):
        kernel_sample.sample_band_multi_plain(imgs, flow, want, row0, 64, 20)
    assert torch.equal(got, want)
    assert torch.equal(got, torch.stack([_apply_flow_plane(p, flow, grid, dt, band_rows=64) for p in imgs]))


@pytest.mark.cuda
def test_apply_mixed_dtypes_on_card(gen, dev):
    """u16 planes into float32 and float32 planes into u16: warped as
    float32 through the band entry, then rounded; equal to K1 a plane."""
    h, w = 70, 300
    flow = torch.stack(_smooth_flow(h, w, dev), dim=-1).contiguous()
    grid = TileGrid.for_image((h, w), 120, 20)
    for src, dst in ((torch.uint16, torch.float32), (torch.float32, torch.uint16)):
        imgs = torch.from_numpy(_stack(gen, "uint16", 2, h, w).astype(np.float32)).to(dev).to(src)
        got = _apply_flow_planes(imgs, flow, grid, dst, band_rows=64)
        want = torch.stack([_apply_flow_plane(p, flow, grid, dst, band_rows=64) for p in imgs])
        assert got.dtype == dst and torch.equal(got, want)


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


@pytest.mark.cuda
def test_match_near_ties_on_card_equal_cpu(gen, dev):
    """Ratio tests within float32 rounding of their threshold are decided in
    float64, so cuBLAS and the CPU's BLAS give the same matches."""
    from microaligner_tpu_torch.features.match import match_descriptors

    n, d = 48, 200
    basis = np.linalg.qr(gen.standard_normal((d, d)))[0]
    eps = gen.uniform(-3e-7, 3e-7, n)
    offset = 4.0 * basis[3::4][:n]
    query = (basis[0::4][:n] + offset).astype(np.float32)
    near = basis[1::4][:n] * np.sqrt(1.0 + 2.0 * eps)[:, None] + offset
    far = basis[2::4][:n] * np.sqrt(7.0) + offset
    noise = gen.random((3000, d))
    train = np.concatenate([near, far, 10.0 * noise / np.linalg.norm(noise, axis=1, keepdims=True)])
    args = [torch.from_numpy(train.astype(np.float32)), torch.from_numpy(query),
            torch.ones(len(train), dtype=torch.bool), torch.ones(n, dtype=torch.bool)]
    good, idx = match_descriptors(*(a.to(dev) for a in args))
    want_good, want_idx = match_descriptors(*args)
    assert torch.equal(good.cpu(), want_good) and torch.equal(idx.cpu(), want_idx)
    assert 0 < int(want_good.sum()) < n


# -- the per-tile route (MICROALIGNER_TPU_FLOW_DENSE=0) ------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["K2", "K3", "K4"])
def test_k234_at_the_per_tile_shape(gen, dev, kernel):
    """K2-K4 where the per-tile route launches them: a chunk of 8 halo
    windows of 1200^2 (tile 1000, overlap 100), each against its plain
    version with its bar; K3 at window 99 also against float64."""
    a, b, coeffs = _k2_inputs(gen, dev, 8, 1200, 1200)
    want = kernel_poly.poly_pair_m_plain(a, b, coeffs)
    if kernel == "K2":
        for g, wv in zip(kernel_poly.poly_pair_m(a, b, coeffs), want):
            err, bound = _rel_err(g, wv)
            assert err <= bound
        return
    r0, r1, m0 = want
    del a, b
    fx, fy = kernel_agg.smooth5_solve_plain(m0, 99)
    if kernel == "K3":
        got = kernel_agg.smooth5_solve(m0, 99)
        exact = kernel_agg.smooth5_solve_plain(m0.double(), 99)
        for g, p, e in zip(got, (fx, fy), exact):
            torch.testing.assert_close(g, p, atol=1e-4, rtol=0)
            kern_err, plain_err = (g.double() - e).abs(), (p.double() - e).abs()
            assert float(kern_err.max()) <= min(float(plain_err.max()) + F64_SLACK_PX, F64_MAX_PX)
            assert float(kern_err.mean()) <= min(float(plain_err.mean()) + F64_SLACK_PX, F64_MEAN_PX)
        return
    err, bound = _rel_err(kernel_matrices.update_matrices(r0, r1, fx, fy),
                          kernel_matrices.update_matrices_plain(r0, r1, fx, fy))
    assert err <= bound


def _per_tile_counts():
    return {"K1": kernel_sample.sample_displaced.launches, "K2": kernel_poly.poly_pair_m.launches,
            "K3": kernel_agg.smooth5_solve.launches, "K4": kernel_matrices.update_matrices.launches,
            "K5": kernel_sample.sample_displaced_multi.launches + kernel_sample.sample_band_multi.launches}


@pytest.mark.cuda
def test_per_tile_warp_on_card(gen, dev, monkeypatch):
    """The per-tile warp (``_apply_flow_plane`` under ``FLOW_DENSE=0``): one
    K1 launch a chunk of windows and no K5, bit for bit against the same
    warp through the plain versions on the CPU."""
    from microaligner_tpu_torch.optflow import warper

    monkeypatch.setenv("MICROALIGNER_TPU_FLOW_DENSE", "0")
    monkeypatch.setattr(warper, "_TILE_BATCH", 4)  # 9 windows: chunks of 4, 4, 1
    img = torch.from_numpy(gen.integers(0, 65535, (260, 300)).astype(np.uint16))
    flow = torch.from_numpy(((gen.random((260, 300, 2)) - 0.5) * 12).astype(np.float32))
    grid = TileGrid.for_image((260, 300), 120, 20)
    before = _per_tile_counts()
    got = _apply_flow_plane(img.to(dev), flow.to(dev), grid, torch.uint16)
    torch.cuda.synchronize()
    after = _per_tile_counts()
    assert after["K1"] - before["K1"] == 3 and after["K5"] == before["K5"]
    assert got.dtype == torch.uint16 and torch.equal(got.cpu(), _apply_flow_plane(img, flow, grid, torch.uint16))


@pytest.mark.cuda
def test_per_tile_register_on_card(gen, dev, monkeypatch):
    """The fused per-tile flow and warp on the card against the plain
    versions on the CPU (the flow within phase 3's bars, the warp within
    1 LSB where the flow moved), and a register under ``FLOW_DENSE=0``
    launches K1-K4 and never K5."""
    from microaligner_tpu_torch.optflow.flow_calc import calc_flow_and_warp_tiled
    from microaligner_tpu_torch.optflow.registrator import OptFlowRegistrator

    monkeypatch.setenv("MICROALIGNER_TPU_FLOW_DENSE", "0")
    mov, ref = (x[0].round().to(torch.uint8) for x in _smooth_pair(gen, dev, 1, 420, 460))
    grid = TileGrid.for_image((420, 460), 150, 50)
    flow, warped = calc_flow_and_warp_tiled(ref, mov, mov, grid, 49, 2, torch.uint8)
    cflow, cwarped = calc_flow_and_warp_tiled(ref.cpu(), mov.cpu(), mov.cpu(), grid, 49, 2, torch.uint8)
    err = (flow.cpu() - cflow).abs()
    assert float(err.mean()) < 1e-4 and float(err.max()) < 1e-2
    diff = (warped.cpu().to(torch.int32) - cwarped.to(torch.int32)).abs()
    assert int(diff.max()) <= 1 and float((diff > 0).float().mean()) < 1e-3
    reg = OptFlowRegistrator(device=dev)
    reg.num_pyr_lvl, reg.num_iterations, reg.tile_size, reg.overlap, reg.use_full_res_img = 1, 2, 150, 50, True
    reg.ref_img, reg.mov_img = ref, mov
    before = _per_tile_counts()
    out = reg.register_device()
    torch.cuda.synchronize()
    after = _per_tile_counts()
    assert out.device.type == "cuda" and out.shape == (420, 460, 2)
    assert all(after[k] > before[k] for k in ("K1", "K2", "K3", "K4")) and after["K5"] == before["K5"]
