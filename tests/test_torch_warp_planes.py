"""K5 and the port's z-stack apply against the JAX package.

``warp_planes_tiled`` and ``_apply_flow_planes`` (one K5 launch a band for
every plane) are held against the JAX package's ``warp_planes_tiled`` and
``_apply_flow_planes`` on the same numpy planes, with the bars of
``tests/test_warp_planes.py``:

* f32: atol 1e-4 for displacements inside the JAX package's band and 1e-3
  beyond it (its exact-gather branch).  The f32 cases take unit-range planes:
  the JAX exact gather adds the flow to absolute f32 pixel coordinates
  (~3e-5 px off, ROADMAP queue 3), which on u16-range white noise alone is a
  difference of about one level;
* u16: within 1 level (rounding half to even can cross a .5 tie when the
  two sides' weights differ in the last bit), at < 0.5% of pixels.

Within the port, K5's plain version equals the per-plane K1 plain version
bit for bit, and ``_apply_flow_planes`` gives the same planes as
``_apply_flow_plane`` on each plane (one launch of the band entry a band
and plane) bit for bit.  K5's band entry (``sample_band_multi``: stored planes in, rounded
band rows out, one launch a band) equals, through its plain version, the
composition the apply used before it (an f32 slab of the zero canvas,
zero-padded flow slabs, K5 on the negated flow, crop, ``round_to_dtype``)
bit for bit, and refuses what its kernel does not take.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from microaligner_tpu.optflow.warper import warp_planes_tiled as j_warp_planes
from microaligner_tpu.pipeline.runner import _apply_flow_planes as j_apply_planes
from microaligner_tpu.tiles import TileGrid as JGrid
from microaligner_tpu_torch.ops import kernel_sample, warp as tw
from microaligner_tpu_torch.ops.filters import round_to_dtype
from microaligner_tpu_torch.ops.pad import zero_pad
from microaligner_tpu_torch.optflow.flow_calc import band_rows_for, band_slab
from microaligner_tpu_torch.optflow.warper import warp_planes_tiled, warp_tiled_dtype
from microaligner_tpu_torch.pipeline.runner import _apply_flow_plane, _apply_flow_planes
from microaligner_tpu_torch.tiles import TileGrid

torch.set_num_threads(1)

H, W, TILE, OVERLAP = 260, 300, 120, 20


@pytest.fixture(scope="module")
def stack_and_flows():
    rng = np.random.default_rng(11)
    planes = rng.integers(0, 65535, (3, H, W)).astype(np.uint16)
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    small = np.stack([2.0 * np.sin(ys / 17), 1.5 * np.cos(xs / 23)], axis=-1).astype(np.float32)
    # displacements beyond the JAX package's static band (its exact branch)
    large = np.random.default_rng(5).uniform(-11, 11, (H, W, 2)).astype(np.float32)
    return planes, {"small": small, "large": large}


def _grids():
    return JGrid.for_image((H, W), TILE, OVERLAP), TileGrid.for_image((H, W), TILE, OVERLAP)


@pytest.mark.parametrize("which,atol", [("small", 1e-4), ("large", 1e-3)])
def test_warp_planes_tiled_f32_matches_jax(stack_and_flows, which, atol):
    planes, flows = stack_and_flows
    unit = (planes / 65535.0).astype(np.float32)
    jg, g = _grids()
    want = np.asarray(j_warp_planes(jnp.asarray(unit), jnp.asarray(flows[which]), jg, "float32"))
    got = warp_planes_tiled(torch.from_numpy(unit), torch.from_numpy(flows[which]), g, torch.float32)
    np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=0)


@pytest.mark.parametrize("band_rows", [None, 64])
def test_apply_flow_planes_u16_matches_jax(stack_and_flows, band_rows):
    planes, flows = stack_and_flows
    jg, g = _grids()
    want = np.asarray(j_apply_planes(jnp.asarray(planes), jnp.asarray(flows["small"]), jg, "uint16"))
    got = _apply_flow_planes(torch.from_numpy(planes), torch.from_numpy(flows["small"]), g,
                             torch.uint16, band_rows=band_rows).numpy()
    assert got.dtype == np.uint16
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() < 5e-3


@pytest.mark.parametrize("which", ["small", "large"])
@pytest.mark.parametrize("dtype", [torch.uint16, torch.float32])
def test_multi_equals_per_plane_bitwise(stack_and_flows, which, dtype):
    planes, flows = stack_and_flows
    _, g = _grids()
    imgs, flow = torch.from_numpy(planes), torch.from_numpy(flows[which])
    multi = _apply_flow_planes(imgs, flow, g, dtype, band_rows=64)
    for i in range(imgs.shape[0]):
        assert torch.equal(multi[i], warp_tiled_dtype(imgs[i], flow, g, dtype, band_rows=64))
        assert torch.equal(multi[i], _apply_flow_plane(imgs[i], flow, g, dtype, band_rows=64))


def test_apply_flow_planes_takes_k5(stack_and_flows):
    """One K5 call a band (its band entry) for the whole stack, and no K1
    call."""
    planes, flows = stack_and_flows
    _, g = _grids()
    imgs, flow = torch.from_numpy(planes[:2]), torch.from_numpy(flows["small"])
    before = (kernel_sample.sample_band_multi_plain.calls,
              kernel_sample.sample_displaced_plain.calls,
              kernel_sample.sample_band_multi.launches)
    _apply_flow_planes(imgs, flow, g, torch.uint16, band_rows=64)
    assert kernel_sample.sample_band_multi_plain.calls - before[0] == -(-H // 64)
    assert kernel_sample.sample_displaced_plain.calls == before[1]
    assert kernel_sample.sample_band_multi.launches == before[2]  # CPU: never the kernel


@pytest.mark.parametrize("spread", [4.0, 41.0])
def test_k5_plain_equals_k1_plain_bitwise(spread):
    rng = np.random.default_rng(int(spread))
    n, h, w = 3, 37, 51
    imgs = torch.from_numpy(rng.random((n, h, w), dtype=np.float32))
    fx = torch.from_numpy(((rng.random((h, w)) - 0.5) * spread).astype(np.float32))
    fy = torch.from_numpy(((rng.random((h, w)) - 0.5) * spread).astype(np.float32))
    got = kernel_sample.sample_displaced_multi(imgs, fx, fy)
    want = kernel_sample.sample_displaced_plain(imgs, fx.expand(n, h, w).contiguous(),
                                                fy.expand(n, h, w).contiguous())
    assert torch.equal(got, want)
    flow = torch.stack([fx, fy], dim=-1)
    assert torch.equal(tw.warp_planes_with_flow(imgs, flow),
                       tw.warp_with_flow_batched(imgs, flow.expand(n, h, w, 2)))


def test_k5_dispatch_counts_and_checks():
    imgs = torch.zeros((2, 12, 14))
    f = torch.zeros((12, 14))
    before = (kernel_sample.sample_displaced_multi_plain.calls,
              kernel_sample.sample_displaced_multi.launches)
    kernel_sample.sample_displaced_multi(imgs, f, f)
    assert kernel_sample.sample_displaced_multi_plain.calls == before[0] + 1
    assert kernel_sample.sample_displaced_multi.launches == before[1]  # CPU: never the kernel
    with pytest.raises(TypeError):
        kernel_sample.sample_displaced_multi(imgs.double(), f, f)
    with pytest.raises(ValueError):
        kernel_sample.sample_displaced_multi(imgs, f[:, :5].contiguous(), f)
    with pytest.raises(ValueError):  # one flow for all planes, not one a plane
        kernel_sample.sample_displaced_multi(imgs, imgs, imgs)
    with pytest.raises(ValueError):
        kernel_sample.sample_displaced_multi(imgs[0], f, f)
    with pytest.raises(ValueError):
        kernel_sample.sample_displaced_multi(imgs, f.t(), f)


def _composition_before_band_entry(imgs, flow, grid, dtype, band_rows):
    """The z-stack apply as the port computed it before K5's band entry:
    per band an f32 slab of the zero canvas, zero-padded flow slabs, K5 on
    the negated flow, the interior cropped and rounded."""
    o = grid.overlap
    h, w = grid.height, grid.width
    rows = band_rows_for(grid, band_rows)
    out = torch.empty((imgs.shape[0], h, w), dtype=dtype)
    for row0 in range(0, h, rows):
        n_in = min(rows, h - row0)
        src = band_slab(imgs, row0, rows, o)
        fx = zero_pad(flow[row0 : row0 + n_in, :, 0], o, rows - n_in + o, o, o)
        fy = zero_pad(flow[row0 : row0 + n_in, :, 1], o, rows - n_in + o, o, o)
        warped = tw.warp_planes_with_flow_parts(src, fx, fy)
        out[:, row0 : row0 + n_in] = round_to_dtype(warped[:, o : o + n_in, o : o + w], dtype)
    return out


def _beyond_overlap_flow():
    """A smooth flow of up to 30 px, beyond the grid's overlap of 20: taps
    outside the band's halo read zero."""
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    return np.stack([30.0 * np.sin(ys / 40), 25.0 * np.cos(xs / 35)], axis=-1).astype(np.float32)


@pytest.mark.parametrize("band_rows", [None, 64])  # None: one band of 512 rows over 260; 64: last band 4 rows
@pytest.mark.parametrize("which", ["small", "large", "beyond"])
@pytest.mark.parametrize("dtype", [torch.uint16, torch.float32])
def test_band_entry_plain_equals_previous_composition(stack_and_flows, band_rows, which, dtype):
    planes, flows = stack_and_flows
    _, g = _grids()
    flow = torch.from_numpy(_beyond_overlap_flow() if which == "beyond" else flows[which])
    imgs = torch.from_numpy(planes if dtype == torch.uint16 else (planes / 65535.0).astype(np.float32))
    got = warp_planes_tiled(imgs, flow, g, dtype, band_rows=band_rows)
    assert got.dtype == dtype
    assert torch.equal(got, _composition_before_band_entry(imgs, flow, g, dtype, band_rows))


@pytest.mark.parametrize("src,dst", [(torch.uint16, torch.uint8), (torch.float64, torch.float64),
                                     (torch.int16, torch.int64), (torch.int8, torch.int16),
                                     (torch.uint16, torch.float32)])
def test_apply_dtype_pairs_outside_the_kernels_set(stack_and_flows, src, dst):
    """Pairs of stored and output dtype other than one of the kernel's six
    in and out are warped as float32 planes and rounded afterwards, and
    still equal the previous composition."""
    planes, flows = stack_and_flows
    _, g = _grids()
    imgs = torch.from_numpy(planes[:2].astype(np.int64) - (32768 if src == torch.int16 else 0)).to(src)
    flow = torch.from_numpy(flows["small"])
    got = _apply_flow_planes(imgs, flow, g, dst, band_rows=64)
    assert got.dtype == dst
    assert torch.equal(got, _composition_before_band_entry(imgs, flow, g, dst, 64))


@pytest.mark.parametrize("name,scale", [("uint8", 255), ("int16", 32767), ("float32", None)])
def test_apply_flow_planes_matches_jax_dtypes(stack_and_flows, name, scale):
    """u8 and i16 stacks within 1 level at < 0.5% of pixels, f32 (unit-range
    planes) within 1e-4 of the JAX package's ``_apply_flow_planes``."""
    planes, flows = stack_and_flows
    jg, g = _grids()
    if scale is None:
        stack = (planes / 65535.0).astype(np.float32)
    else:
        lo = -scale - 1 if name == "int16" else 0
        stack = (lo + planes.astype(np.int64) * (scale - lo) // 65535).astype(name)
    want = np.asarray(j_apply_planes(jnp.asarray(stack), jnp.asarray(flows["small"]), jg, name))
    got = _apply_flow_planes(torch.from_numpy(stack), torch.from_numpy(flows["small"]), g,
                             getattr(torch, name), band_rows=64).numpy()
    assert got.dtype == np.dtype(name)
    if scale is None:
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    else:
        diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
        assert diff.max() <= 1 and (diff > 0).mean() < 5e-3


def test_band_entry_checks():
    imgs = torch.zeros((2, 12, 14), dtype=torch.uint16)
    flow = torch.zeros((12, 14, 2))
    out = torch.empty_like(imgs)
    before = (kernel_sample.sample_band_multi_plain.calls, kernel_sample.sample_band_multi.launches)
    assert kernel_sample.sample_band_multi(imgs, flow, out, 8, 8, 3) is out  # last band: 4 rows
    assert kernel_sample.sample_band_multi_plain.calls == before[0] + 1
    assert kernel_sample.sample_band_multi.launches == before[1]  # CPU: never the kernel
    with pytest.raises(TypeError):  # a dtype the kernel does not read
        kernel_sample.sample_band_multi(imgs.double(), flow, out.double(), 0, 8, 3)
    with pytest.raises(TypeError):  # u16 planes into u8: not a pair the kernel takes
        kernel_sample.sample_band_multi(imgs, flow, out.to(torch.uint8), 0, 8, 3)
    with pytest.raises(TypeError):
        kernel_sample.sample_band_multi(imgs, flow.double(), out, 0, 8, 3)
    with pytest.raises(ValueError):  # the flow is (H, W, 2), not (2, H, W)
        kernel_sample.sample_band_multi(imgs, flow.permute(2, 0, 1).contiguous(), out, 0, 8, 3)
    with pytest.raises(ValueError):
        kernel_sample.sample_band_multi(imgs, flow[:, :13].contiguous(), out, 0, 8, 3)
    with pytest.raises(ValueError):  # non-contiguous planes, flow, output
        kernel_sample.sample_band_multi(imgs.transpose(1, 2), flow, out.transpose(1, 2), 0, 8, 3)
    with pytest.raises(ValueError):
        kernel_sample.sample_band_multi(imgs, flow.transpose(0, 1).contiguous().transpose(0, 1), out, 0, 8, 3)
    with pytest.raises(ValueError):
        kernel_sample.sample_band_multi(imgs, flow, torch.empty((2, 14, 12), dtype=torch.uint16).transpose(1, 2),
                                        0, 8, 3)
    with pytest.raises(ValueError):  # output of another shape
        kernel_sample.sample_band_multi(imgs, flow, out[:1], 0, 8, 3)
    for row0, rows, overlap in ((12, 8, 3), (-1, 8, 3), (0, 0, 3), (0, 8, -1)):  # row window out of range
        with pytest.raises(ValueError):
            kernel_sample.sample_band_multi(imgs, flow, out, row0, rows, overlap)
    assert kernel_sample.sample_band_multi_plain.calls == before[0] + 1


@pytest.mark.parametrize("src,dst,ok", [(torch.uint16, torch.uint16, True), (torch.int8, torch.int8, True),
                                        (torch.int32, torch.int32, True), (torch.uint16, torch.float32, False),
                                        (torch.float64, torch.float64, False), (torch.float32, torch.uint8, False)])
def test_band_entry_dtype_pairs(src, dst, ok):
    """The kernel reads and writes one of its six dtypes."""
    imgs, out = torch.zeros((1, 10, 12), dtype=src), torch.zeros((1, 10, 12), dtype=dst)
    if ok:
        kernel_sample.sample_band_multi(imgs, torch.zeros((10, 12, 2)), out, 0, 8, 2)
    else:
        with pytest.raises(TypeError):
            kernel_sample.sample_band_multi(imgs, torch.zeros((10, 12, 2)), out, 0, 8, 2)


def test_band_bounds():
    # interior rows and the source rows a band's halo spans, clipped to the image
    assert kernel_sample.band_bounds(260, 0, 64, 20) == (64, 0, 84)
    assert kernel_sample.band_bounds(260, 256, 64, 20) == (4, 236, 260)
    assert kernel_sample.band_bounds(260, 0, 512, 20) == (260, 0, 260)
