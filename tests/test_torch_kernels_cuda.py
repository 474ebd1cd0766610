"""K1-K6 on the card against their plain PyTorch versions on the same card,
the affine warp through K1's row window, the unpaired Farneback route
(K6), the matcher's near-ties, FeatureReg's bf16 operand route (the knn
cross term and DAISY's blur products), and the pinned, streamed apply of
the CLI on the card.

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

The typed entries of Farneback's reduced-precision route
(``MICROALIGNER_TPU_AGG_PRECISION=default``): K2 and K4 are held bit for bit
over every pair of stored types of R and M (K2 also at widths that are odd
or not a multiple of its 4 pixels a thread, and at H = 1).  K3's bfloat16
entry sums on the tensor cores, in their order, so it is held to bars: its
row pass within one bf16 unit (2^-7 of the value) of the plain version (a
float32 sum can round to the neighbouring bf16 value) plus 2 (2r+1) 2^-24
sum_k |c_k x_k|, the most two float32 sums of the same products taken in
different orders can differ (it is the larger term only where a sum cancels
to a small fraction of its terms, as in the signed G12 plane), its flow within
1e-4 px in mean and 1e-2 px at most of the plain version (the bar of the
card against the CPU on this route), and against a float64 run of the same
bf16 operator no further than the plain version is, within 10% in mean and
5e-3 px in max; at aligned and ragged widths, with H or W below the
half-window, and on one-pixel axes.

FeatureReg's bf16 operand route (``MICROALIGNER_TPU_MATCH_F32``,
``MICROALIGNER_TPU_DAISY_EXACT`` unset on the card): the knn cross term and
the blur products take bf16 operands and come back as float32, within the
float32 summation bound of the CPU's plain version (the rounded operands
multiplied in float32: the same exact products, summed in another order),
2 (n + 2) 2^-24 sum |a| |b| for n terms, the knn distances through the
mixed formula's bound of features/match.py; cuBLAS's
``allow_bf16_reduced_precision_reduction`` is as it was after each call;
the matches on the card equal the CPU's on that route.

K7, the DoG of the NMI gate, rounds every product and sum where its plain
version does: it is held bit for bit to ``dog_plain``, on its own and inside
one ``_fused_level`` (the flow and both gate scores).

K8, FeatureReg's knn top-2 on the bf16 route, sums the cross term on the
tensor cores in its own order: it is held, with the plain version on the
card, to the float64 truth of the route's formula by features/match.py's
bound (2 x 605 u E), to the nearest index wherever that is clear, to exact
ties between duplicate train rows, and ``match_descriptors`` on the card to
the CPU's matches.
"""


import numpy as np
import pytest
import torch
from _bounds import bounded_call

from microaligner_tpu_torch.ops import kernel_agg, kernel_dog, kernel_matrices, kernel_poly, kernel_sample
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


# -- the typed entries of the reduced-precision route ---------------------------

BF16, F32 = torch.bfloat16, torch.float32
TYPE_PAIRS = [pytest.param(BF16, BF16, id="r-bf16-m-bf16"), pytest.param(F32, BF16, id="r-f32-m-bf16"),
              pytest.param(BF16, F32, id="r-bf16-m-f32"), pytest.param(F32, F32, id="r-f32-m-f32")]


@pytest.mark.cuda
@pytest.mark.parametrize("rdt,mdt", TYPE_PAIRS)
@pytest.mark.parametrize("n,h,w", [(1, 300, 1001), (2, 9, 45), (1, 64, 1000), (1, 7, 1), (2, 5, 3), (1, 33, 5),
                                   (1, 40, 4095), (2, 1, 1000), (1, 1, 4095)])
def test_k2_typed(gen, dev, n, h, w, rdt, mdt):
    a, b, coeffs = _k2_inputs(gen, dev, n, h, w)
    launches = kernel_poly.poly_pair_m.launches
    got = kernel_poly.poly_pair_m(a, b, coeffs, r_dtype=rdt, m_dtype=mdt)
    torch.cuda.synchronize()
    assert kernel_poly.poly_pair_m.launches == launches + 1
    want = kernel_poly.poly_pair_m_plain(a, b, coeffs, rdt, mdt)
    assert [g.dtype for g in got] == [rdt, rdt, mdt]
    for g, wv in zip(got, want):
        assert torch.equal(g, wv)


@pytest.mark.cuda
@pytest.mark.parametrize("rdt,mdt", TYPE_PAIRS)
@pytest.mark.parametrize("n,h,w,spread", [(1, 300, 1001, 6.0), (1, 9, 45, 40.0), (2, 40, 1000, 3.0)])
def test_k4_typed(gen, dev, n, h, w, spread, rdt, mdt):
    a, b, coeffs = _k2_inputs(gen, dev, n, h, w)
    r0, r1, _ = kernel_poly.poly_pair_m_plain(a, b, coeffs, rdt)
    fx = torch.from_numpy(((gen.random((n, h, w)) - 0.5) * spread).astype(np.float32)).to(dev)
    fy = torch.from_numpy(((gen.random((n, h, w)) - 0.5) * spread).astype(np.float32)).to(dev)
    launches = kernel_matrices.update_matrices.launches
    got = kernel_matrices.update_matrices(r0, r1, fx, fy, out_dtype=mdt)
    torch.cuda.synchronize()
    assert kernel_matrices.update_matrices.launches == launches + 1 and got.dtype == mdt
    assert torch.equal(got, kernel_matrices.update_matrices_plain(r0, r1, fx, fy, mdt))


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,win", [
    pytest.param(1, 300, 1001, 99, id="win99-ragged-width"),
    pytest.param(1, 300, 1000, 99, id="win99-aligned-width"),
    pytest.param(2, 260, 520, 49, id="win49-n2-aligned-width"),
    pytest.param(1, 130, 150, 49, id="win49-w-not-on-4"),
    pytest.param(2, 12, 45, 11, id="win11-n2-h12"),
    pytest.param(2, 40, 30, 99, id="win99-n2-h-and-w-below-r"),
    pytest.param(1, 515, 100, 257, id="win257-w-below-r-three-tiles"),
    pytest.param(1, 3, 2, 99, id="win99-h3-w2"),
    pytest.param(1, 1, 8, 11, id="win11-h1"),
    pytest.param(3, 5, 1, 11, id="win11-w1"),
])
def test_k3_bf16(gen, dev, n, h, w, win):
    a, b, coeffs = _k2_inputs(gen, dev, n, h, w)
    M = kernel_poly.poly_pair_m_plain(a, b, coeffs, BF16, BF16)[2]
    launches = kernel_agg.smooth5_solve.launches, kernel_agg.smooth_w.launches
    got = kernel_agg.smooth5_solve(M, win)
    row = kernel_agg.smooth_w(M, win)
    torch.cuda.synchronize()
    assert (kernel_agg.smooth5_solve.launches, kernel_agg.smooth_w.launches) == (launches[0] + 1, launches[1] + 1)
    assert row.dtype == BF16
    _row_pass_within_bar(M, win, row, kernel_agg.smooth_w_plain(M, win))
    plain = kernel_agg.smooth5_solve_plain(M, win)
    for g, p in zip(got, plain):
        err = (g - p).abs()
        assert g.dtype == F32 and float(err.mean()) <= 1e-4 and float(err.max()) <= 1e-2
    exact = _k3_bf16_float64(M, win)
    dist = {name: [(v.double() - e).abs() for v, e in zip(pair, exact)] for name, pair in (("got", got), ("plain", plain))}
    for d_got, d_plain in zip(dist["got"], dist["plain"]):
        assert float(d_got.mean()) <= 1.1 * float(d_plain.mean()) and float(d_got.max()) <= float(d_plain.max()) + 5e-3


def _row_pass_within_bar(x, win, got, want):
    """One bf16 unit of ``want`` plus 2 (2r+1) 2^-24 sum_k |c_k x_k|."""
    err = (got.float() - want.float()).abs()
    sums = kernel_agg.smooth_axis_plain(x.abs(), kernel_agg.agg_kernel(win), -1)
    bound = 2.0**-7 * want.float().abs() + 2 * (2 * (win // 2) + 1) * 2.0**-24 * sums
    assert bool((err <= bound).all()), float((err - bound).max())


def _k3_bf16_float64(m, win):
    """fx, fy of K3's bf16 operator on bf16 ``m``, run in float64 with nothing
    rounded between the passes (``chip_smoke.py::k3_bf16_float64``)."""
    taps = kernel_agg.agg_kernel(win)
    r = win // 2

    def smooth(x, axis):
        n = x.shape[axis]
        table = kernel_agg._bf16_table(taps.tobytes(), n).to(x.device, torch.float64)
        if axis == -2:
            table = table.unsqueeze(-1)
        xp = x.index_select(axis, torch.arange(-r, n + r, device=x.device).clamp(0, n - 1))
        acc = torch.zeros_like(x)
        for k in range(2 * r + 1):
            acc += xp.narrow(axis, k, n) * table[k]
        return acc

    g11, g12, g22, h1, h2 = smooth(smooth(m.double(), -1), -2).unbind(1)
    idet = 1.0 / (g11 * g22 - g12 * g12 + 1e-3)
    return (g11 * h2 - g12 * h1) * idet, (g22 * h1 - g12 * h2) * idet


@pytest.mark.cuda
def test_k3_bf16_row_pass_on_an_unaligned_view(gen, dev):
    """The row pass's 16-byte copies need rows on 16 bytes: a bf16 tensor
    whose data starts 2 bytes in takes the element copies and stores."""
    base = torch.from_numpy(gen.random((1 * 3 * 40 * 64 + 1), dtype=np.float32)).to(dev, BF16)
    x = base[1:].view(1, 3, 40, 64)
    assert x.data_ptr() % 8 != 0
    _row_pass_within_bar(x, 49, kernel_agg.smooth_w(x, 49), kernel_agg.smooth_w_plain(x, 49))


@pytest.mark.cuda
@pytest.mark.parametrize("r_bf16", ["1", "0"])
def test_bf16_route_on_card(gen, dev, monkeypatch, r_bf16):
    """``_farneback_core_parts`` under ``default`` on the card: K2, K3 and
    K4 launched with the route's stored types, no plain version; the flow
    against the same route through the plain versions on the CPU (phase 3's
    bars) and within the JAX package's hardware bars of the float32 route."""
    monkeypatch.setenv("MICROALIGNER_TPU_AGG_PRECISION", "default")
    monkeypatch.setenv("MICROALIGNER_TPU_R_BF16", r_bf16)
    mov, ref = _smooth_pair(gen, dev, 2, 300, 420)
    calls = [kernel_poly.poly_pair_m_plain.calls, kernel_agg.smooth5_solve_plain.calls,
             kernel_matrices.update_matrices_plain.calls]
    before = [kernel_poly.poly_pair_m.launches, kernel_agg.smooth5_solve.launches,
              kernel_matrices.update_matrices.launches]
    got = tfb._farneback_core_parts(mov, ref, 99, 3, 1, 1.7)
    torch.cuda.synchronize()
    after = [kernel_poly.poly_pair_m.launches, kernel_agg.smooth5_solve.launches,
             kernel_matrices.update_matrices.launches]
    assert [a - b for a, b in zip(after, before)] == [1, 3, 2]
    assert calls == [kernel_poly.poly_pair_m_plain.calls, kernel_agg.smooth5_solve_plain.calls,
                     kernel_matrices.update_matrices_plain.calls]
    cpu = tfb._farneback_core_parts(mov.cpu(), ref.cpu(), 99, 3, 1, 1.7)
    monkeypatch.delenv("MICROALIGNER_TPU_AGG_PRECISION")
    f32 = tfb._farneback_core_parts(mov, ref, 99, 3, 1, 1.7)
    for g, c, f in zip(got, cpu, f32):
        err = (g.cpu() - c).abs()
        assert float(err.mean()) < 1e-4 and float(err.max()) < 1e-2
        err = (g - f).abs()
        assert float(err.mean()) < 1e-3 and float(err.max()) < 0.05


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
    planes = [(i, gen.integers(0, 65535, (64 + i, 70)).astype(np.uint16)) for i in range(7)]
    got = {}
    err, _ = bounded_call(stream_apply, bound_s=120)(
        iter(planes), lambda t: (t.to(torch.float32) * 0.5).round().to(torch.uint16),
        lambda k, v: got.__setitem__(k, v.copy()), device=dev)
    assert err is None, err
    for k, p in planes:
        np.testing.assert_array_equal(got[k], np.round(p.astype(np.float32) * 0.5).astype(np.uint16))


@pytest.mark.cuda
def test_spans_on_card(gen, dev, monkeypatch):
    """Under MICROALIGNER_TPU_PROFILE a span on the card takes timing events
    that read the device's time without a synchronise inside the span, and
    the pinned apply's spans keep every plane: its host threads' spans take
    no events, its warps do, and each plane's ``apply.fetch`` lies under its
    ``apply.write``."""
    from microaligner_tpu_torch.utils import logging as plog

    monkeypatch.setenv("MICROALIGNER_TPU_PROFILE", "1")
    x = torch.randn(4096, 4096, device=dev)
    torch.cuda.synchronize(dev)
    with plog.span("test.matmul", dev) as s:
        for _ in range(8):
            x = x @ x.T / 4096.0
    assert s.events is not None and plog.device_s(s) > 0
    planes = [(i, gen.integers(0, 65535, (512, 520)).astype(np.uint16)) for i in range(5)]
    got = {}
    first = max((e.id for e in plog.spans()), default=0)
    stream_apply(iter(planes), lambda t: t.flip(0), lambda k, v: got.__setitem__(k, v.copy()), device=dev)
    mine = [e for e in plog.spans() if e.id > first]
    for k, p in planes:
        np.testing.assert_array_equal(got[k], p[::-1])
    assert [e.attrs["key"] for e in mine if e.name == "apply.warp"] == list(range(5))
    assert all(e.events is not None and plog.device_s(e) >= 0 for e in mine if e.name == "apply.warp")
    host = [e for e in mine if e.name in ("apply.read", "apply.stage", "apply.wait_plane", "apply.write")]
    assert len(host) == 6 + 5 + 6 + 5 and all(e.events is None for e in host)
    writes = {e.id: e for e in mine if e.name == "apply.write"}
    fetches = [e for e in mine if e.name == "apply.fetch"]
    assert sorted(e.attrs["key"] for e in fetches) == list(range(5)) and all(e.events is None for e in fetches)
    assert all(writes[e.parent].attrs["key"] == e.attrs["key"] for e in fetches)


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
    for route in (torch.float32, torch.bfloat16):  # MATCH_F32=1 and the card's default
        good, idx = match_descriptors(*(a.to(dev) for a in args), operand_dtype=route)
        want_good, want_idx = match_descriptors(*args, operand_dtype=route)
        assert torch.equal(good.cpu(), want_good) and torch.equal(idx.cpu(), want_idx)
        assert 0 < int(want_good.sum()) < n


@pytest.mark.cuda
def test_knn_cross_term_bf16_on_card(gen, dev):
    """The bf16 cross term is one cuBLAS product with a float32 result,
    within the float32 summation bound of the CPU's plain version, and
    leaves cuBLAS's bf16 reduction setting as it was; the knn on the route
    within the mixed formula's bound of the CPU's."""
    from microaligner_tpu_torch.features.match import knn_top2
    from microaligner_tpu_torch.features.routes import match_operand_dtype
    from microaligner_tpu_torch.ops.filters import product_f32

    q = torch.from_numpy(gen.random((700, 200), dtype=np.float32)).to(torch.bfloat16)
    t = torch.from_numpy(gen.random((900, 200), dtype=np.float32)).to(torch.bfloat16)
    matmul = torch.backends.cuda.matmul
    for setting in (True, False):
        matmul.allow_bf16_reduced_precision_reduction = setting
        got = product_f32(q.to(dev), t.to(dev).T)
        assert matmul.allow_bf16_reduced_precision_reduction == setting
    matmul.allow_bf16_reduced_precision_reduction = True
    assert got.dtype == torch.float32
    want = product_f32(q, t.T)
    bound = 2 * 202 * 2.0**-24 * (q.double().abs() @ t.double().abs().T)
    assert bool(((got.cpu().double() - want.double()).abs() <= bound).all())
    assert bool((got.cpu() != got.cpu().to(torch.bfloat16).float()).any())  # float32 sums, not a bf16 product
    assert match_operand_dtype(dev) == torch.bfloat16  # the card's default
    query, train = q.float() / 15.0, t.float() / 15.0
    valid_q, valid_t = torch.ones(700, dtype=torch.bool), torch.ones(900, dtype=torch.bool)
    d1, d2, _ = knn_top2(query.to(dev), train.to(dev), valid_q.to(dev), valid_t.to(dev))
    w1, w2, _ = knn_top2(query, train, valid_q, valid_t, operand_dtype=torch.bfloat16)
    qn = (query.double() ** 2).sum(1)
    tol = 2 * 605 * 2.0**-24 * (qn + float((train.double() ** 2).sum(1).max()))
    assert bool(((d1.cpu().double() - w1.double()).abs() <= tol).all())
    assert bool(((d2.cpu().double() - w2.double()).abs() <= tol).all())


@pytest.mark.cuda
@pytest.mark.parametrize("shape,sigma", [((8, 300, 340), 3.5), ((8, 700, 640), 7.826238), ((2, 48, 1300), 6.0621778)],
                         ids=["dense", "banded", "banded-cols"])
def test_blur_bf16_on_card(gen, dev, shape, sigma):
    """DAISY's blur products on the bf16 route: float32 out, within the
    float32 summation bound of the CPU's plain version on both axes (the
    first axis's output can round to neighbouring bf16 values on the two
    devices: one bf16 unit of it times its operator weight more, on at most
    1% of the values), and cuBLAS's setting restored."""
    from microaligner_tpu_torch.ops import filters

    ksize = int(round(sigma * 4)) * 2 + 1
    x = torch.from_numpy(gen.random(shape, dtype=np.float32))
    matmul = torch.backends.cuda.matmul
    matmul.allow_bf16_reduced_precision_reduction = True
    got = filters.gaussian_blur_mxu(x.to(dev), ksize, sigma, torch.bfloat16)
    assert matmul.allow_bf16_reduced_precision_reduction
    assert got.dtype == torch.float32
    want = filters.gaussian_blur_mxu(x, ksize, sigma, torch.bfloat16).double()
    h, w = shape[1:]
    bh, bw = (torch.from_numpy(filters._blur_operator(n, ksize, sigma)).double() for n in (h, w))
    nw = w if w <= filters.BANDED_BLOCK + ksize - 1 else filters.BANDED_BLOCK + ksize - 1
    y1 = bh @ x.to(torch.bfloat16).double()  # the Gaussian's taps are positive
    tight = 2 * (nw + 2) * 2.0**-24 * (y1 @ bw.T) * 1.01
    unit = torch.ldexp(torch.ones_like(y1), torch.frexp(y1).exponent - 8)
    diff = (got.cpu().double() - want).abs()
    assert bool((diff <= tight + unit @ bw.T).all())
    assert float((diff > tight).double().mean()) <= 0.01
    f32 = filters.gaussian_blur_mxu(x.to(dev), ksize, sigma)
    assert float((got - f32).abs().max()) > 10 * float(tight.max())  # the bf16 route, not the float32 one


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


def _dog_image(gen, dev, kind, h, w):
    """An (h, w) input of K7: ``texture`` (u8 blurred noise), ``warp`` (such a
    texture under a seeded smooth warp), ``constant``, ``zeros``,
    ``two_value`` (u8), ``u16`` and ``f32`` (a texture in [-1, 2])."""
    from microaligner_tpu_torch.ops.warp import bilinear_remap

    if kind == "constant":
        return torch.full((h, w), 7, dtype=torch.uint8, device=dev)
    if kind == "zeros":
        return torch.zeros((h, w), dtype=torch.uint8, device=dev)
    if kind == "two_value":
        return torch.from_numpy((gen.integers(0, 2, (h, w)) * 200 + 17).astype(np.uint8)).to(dev)
    tex = gaussian_blur(torch.from_numpy(gen.random((h, w), dtype=np.float32)).to(dev), 13, 2.0)
    tex = (tex - tex.min()) / (tex.max() - tex.min())
    if kind == "warp":
        amp, phase = gen.uniform(1.0, 4.0), gen.uniform(0.0, 6.28)
        ys = torch.arange(h, device=dev, dtype=torch.float32).view(h, 1)
        xs = torch.arange(w, device=dev, dtype=torch.float32).view(1, w)
        tex = bilinear_remap(tex, xs + amp * torch.sin(ys / 50 + phase), ys + amp * torch.cos(xs / 70 - phase))
    if kind == "f32":
        return (tex * 3 - 1).contiguous()
    if kind == "u16":
        return (tex * 65535).round().to(torch.int32).to(torch.uint16)
    return (tex * 255).round().to(torch.uint8)


def _k7_equal(img, ksize=41, low=5, high=9):
    launches = kernel_dog.dog_u8.launches
    got = kernel_dog.dog_u8(img, ksize, low, high)
    torch.cuda.synchronize()
    assert kernel_dog.dog_u8.launches == launches + 1
    assert got.dtype == torch.uint8 and got.shape == img.shape
    assert torch.equal(got, kernel_dog.dog_plain(img, ksize, low, high))


@pytest.mark.cuda
@pytest.mark.parametrize("h,w", [(1024, 1024), (8192, 8192), (1000, 1000), (101, 357), (357, 101), (7, 300),
                                 (1256, 20480)])
def test_k7(gen, dev, h, w):
    _k7_equal(_dog_image(gen, dev, "texture", h, w))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["warp", "constant", "zeros", "two_value", "u16", "f32"])
@pytest.mark.parametrize("h,w", [(1000, 1000), (101, 357), (7, 300)])
def test_k7_inputs(gen, dev, kind, h, w):
    _k7_equal(_dog_image(gen, dev, kind, h, w))


@pytest.mark.cuda
@pytest.mark.parametrize("ksize,low,high", [(1, 5, 9), (9, 1, 2), (17, 2, 0), (41, 3, 7), (81, 10, 18)])
@pytest.mark.parametrize("h,w", [(101, 357), (7, 300)])
def test_k7_kernel_sizes(gen, dev, ksize, low, high, h, w):
    """41 taps take the unrolled instantiation; every other odd size up to
    81 the looped one."""
    _k7_equal(_dog_image(gen, dev, "texture", h, w), ksize, low, high)


@pytest.mark.cuda
def test_k7_fused_level_equals_plain(gen, dev, monkeypatch):
    """One OptFlowReg level at 1024^2 with K7 in its three gate DoGs gives
    the flow and both gate scores of the same call with the plain DoG."""
    from microaligner_tpu_torch.optflow.registrator import _fused_level

    mov, ref = (x[0].round().to(torch.uint8) for x in _smooth_pair(gen, dev, 1, 1024, 1024))
    args = (ref, mov, None, TileGrid.for_image((1024, 1024), 500, 100), 99, 3, False, 500, False, False,
            torch.uint8, 256)
    launches = kernel_dog.dog_u8.launches
    flow, after, before = _fused_level(*args)
    torch.cuda.synchronize()
    assert kernel_dog.dog_u8.launches == launches + 3
    monkeypatch.setattr(kernel_dog, "dog_u8", lambda img, k, lo, hi: kernel_dog.dog_plain(img, k, lo, hi))
    calls = kernel_dog.dog_plain.calls
    pflow, pafter, pbefore = _fused_level(*args)
    assert kernel_dog.dog_plain.calls == calls + 3
    assert torch.equal(flow, pflow) and torch.equal(after, pafter) and torch.equal(before, pbefore)


@pytest.mark.cuda
def test_k7_refuses(dev):
    img = torch.zeros((3, 40, 50), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError, match="2-D"):
        kernel_dog.dog_u8(img, 41, 5, 9)
    with pytest.raises(ValueError, match="dtype"):
        kernel_dog.dog_u8(img[0].to(torch.int32), 41, 5, 9)
    with pytest.raises(ValueError, match="kernel size"):
        kernel_dog.dog_u8(img[0], kernel_dog.MAX_KSIZE + 2, 11, 19)


# -- K8: FeatureReg's knn top-2 on the bf16 route ---------------------------------------------------------------

def _k8_inputs(gen, nq, nt, w, mask, dup):
    """Unit-norm non-negative descriptors (as DAISY's), queries near train
    rows; ``mask``: ``all`` valid, ``interleaved`` (a third invalid at
    random), ``tiles`` (whole 128-row tiles invalid), ``one`` or ``none``
    valid; ``dup``: every other train row of the first half repeated
    exactly in the second half, queries near the repeated rows."""
    train = gen.random((nt, w)) ** 3
    if dup:
        half = nt // 2
        train[half : 2 * half] = train[:half]
    train /= np.linalg.norm(train, axis=1, keepdims=True)
    src = gen.integers(0, max(1, nt // 2) if dup else nt, nq)
    query = train[src] + gen.normal(0.0, gen.uniform(0.005, 0.2, (nq, 1)), (nq, w))
    query = np.abs(query) / np.linalg.norm(query, axis=1, keepdims=True)
    valid = np.ones(nt, bool)
    if mask == "interleaved":
        valid = gen.random(nt) > 0.33
    elif mask == "tiles":
        valid[128:384] = False
        valid[-(nt % 128 or 128):] = False
    elif mask == "one":
        valid[:] = False
        valid[gen.integers(0, nt)] = True
    elif mask == "none":
        valid[:] = False
    return (torch.from_numpy(query.astype(np.float32)), torch.from_numpy(train.astype(np.float32)),
            torch.from_numpy(valid))


def _k8_truth(query, train, valid):
    """The bf16 route's formula in float64: float64 norms of the unrounded
    rows, the float64 product of the bf16-rounded ones, _BIG where masked;
    the whole distance matrix, then d1, d2 as ``top2_plain`` takes them."""
    from microaligner_tpu_torch.ops.kernel_knn import BIG

    q, t = query.double(), train.double()
    cross = query.to(torch.bfloat16).double() @ train.to(torch.bfloat16).double().T
    d = ((q * q).sum(1)[:, None] + (t * t).sum(1)[None, :] - 2 * cross).clamp_min(0.0)
    d = torch.where(valid[None, :], d, BIG)
    top = torch.topk(d, min(2, d.shape[1]), dim=1, largest=False)
    d2 = top.values[:, 1] if d.shape[1] > 1 else torch.full((d.shape[0],), BIG, dtype=torch.float64)
    return d, top.values[:, 0], d2


@pytest.mark.cuda
@pytest.mark.parametrize("nq,nt,w,mask,dup", [
    (1, 1, 200, "all", False), (1000, 2999, 200, "interleaved", False), (3000, 130, 8, "interleaved", False),
    (129, 3000, 200, "tiles", False), (777, 2001, 200, "tiles", False), (50, 5, 200, "one", False),
    (40, 300, 200, "none", False), (300, 1201, 200, "all", True), (257, 640, 8, "all", True),
    (600, 1, 200, "one", False), (2, 2, 8, "all", False)],
    ids=["1x1", "ragged", "w8", "tiles", "tiles-ragged", "one-valid", "none-valid", "dup", "dup-w8", "t1", "2x2"])
def test_k8(gen, dev, nq, nt, w, mask, dup):
    """K8 against the float64 truth of the bf16 route's formula (d1 and d2
    within 2 x 605 u E, E = |q|^2 + max |t|^2, features/match.py's bound;
    exactly _BIG where fewer than two train rows are valid; the nearest
    index wherever d1 beats the runner-up by more than that bar), against
    the plain version on the card by the same bars, exact duplicates as
    one exact tie (d2 == d1, the smaller index), one launch that allocates
    nothing but its outputs, and ``match_descriptors`` on the card's route
    equal to the CPU's."""
    from microaligner_tpu_torch.features.match import match_descriptors
    from microaligner_tpu_torch.ops import kernel_knn

    query, train, valid = _k8_inputs(gen, nq, nt, w, mask, dup)
    q, t, v = query.to(dev), train.to(dev), valid.to(dev)
    q_op, t_op = q.to(torch.bfloat16), t.to(torch.bfloat16)
    qn, tn = torch.sum(q * q, dim=1), torch.sum(t * t, dim=1)
    torch.cuda.synchronize()
    launches, before = kernel_knn.top2_bf16.launches, torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    d1, d2, i1 = kernel_knn.top2_bf16(q_op, t_op, qn, tn, v)
    torch.cuda.synchronize()
    assert kernel_knn.top2_bf16.launches == launches + 1
    outputs = sum(-(-x.numel() * x.element_size() // 512) * 512 for x in (d1, d2, i1))
    assert torch.cuda.max_memory_allocated(dev) - before <= outputs
    assert (d1.dtype, d2.dtype, i1.dtype) == (torch.float32, torch.float32, torch.int64)
    p1, p2, pi = kernel_knn.top2_plain(q_op, t_op, qn, tn, v)

    d, w1, w2 = _k8_truth(query, train, valid)
    n_valid = int(valid.sum())
    bar = 2 * 605 * 2.0**-24 * ((query.double() ** 2).sum(1) + float((train.double() ** 2).sum(1).max()))
    big = torch.tensor(kernel_knn.BIG, dtype=torch.float32)
    for got in ((d1, d2, i1), (p1, p2, pi)):
        g1, g2, gi = (x.cpu() for x in got)
        if n_valid == 0:
            assert bool((g1 == big).all()) and bool((gi == 0).all())
        else:
            assert bool(((g1.double() - w1).abs() <= bar).all())
        if n_valid < 2:
            assert bool((g2 == big).all())
        else:
            assert bool(((g2.double() - w2).abs() <= bar).all())
        clear = (w2 - w1 > bar) & (w1 < kernel_knn.BIG)
        assert torch.equal(gi[clear], d.argmin(dim=1)[clear])
        assert bool(valid[gi[w1 < kernel_knn.BIG]].all())
    if dup:  # a query whose nearest is a repeated row: its two copies tie exactly, the first wins
        half = nt // 2
        first = torch.arange(nt)
        first[half : 2 * half] -= half
        third = torch.topk(d, 3, dim=1, largest=False).values[:, 2]
        pair = (first[d.argmin(dim=1)] < half) & (third - w1 > bar)
        g1, g2, gi = (x.cpu() for x in (d1, d2, i1))
        assert int(pair.sum()) > nq // 2
        assert torch.equal(g1[pair], g2[pair]) and torch.equal(gi[pair], first[d.argmin(dim=1)][pair])

    q_valid = torch.ones(nq, dtype=torch.bool)
    launches, plain = kernel_knn.top2_bf16.launches, kernel_knn.top2_plain.calls
    good, idx = match_descriptors(t, q, v, q_valid.to(dev), operand_dtype=torch.bfloat16)
    assert kernel_knn.top2_bf16.launches == launches + 1
    assert kernel_knn.top2_plain.calls - plain <= 1  # the float64 re-decision of near-ties, if any
    want_good, want_idx = match_descriptors(train, query, valid, q_valid, operand_dtype=torch.bfloat16)
    assert torch.equal(good.cpu(), want_good)
    assert torch.equal(idx.cpu()[want_good], want_idx[want_good])


@pytest.mark.cuda
def test_k8_refuses(dev):
    from microaligner_tpu_torch.ops import kernel_knn

    q, t = torch.zeros((5, 200), device=dev, dtype=torch.bfloat16), torch.zeros((7, 200), device=dev,
                                                                               dtype=torch.bfloat16)
    qn, tn, v = (torch.zeros(5, device=dev), torch.zeros(7, device=dev), torch.ones(7, dtype=torch.bool, device=dev))
    with pytest.raises(ValueError, match="start on 16 bytes"):
        kernel_knn.top2_bf16(torch.zeros(5 * 200 + 1, device=dev, dtype=torch.bfloat16)[1:].view(5, 200), t, qn, tn, v)
    with pytest.raises(ValueError, match="contiguous"):
        kernel_knn.top2_bf16(q, torch.zeros((200, 7), device=dev, dtype=torch.bfloat16).T, qn, tn, v)
