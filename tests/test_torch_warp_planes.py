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
``_apply_flow_plane`` on each plane (one K1 launch a band and plane) bit for
bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from microaligner_tpu.optflow.warper import warp_planes_tiled as j_warp_planes
from microaligner_tpu.pipeline.runner import _apply_flow_planes as j_apply_planes
from microaligner_tpu.tiles import TileGrid as JGrid
from microaligner_tpu_torch.ops import kernel_sample, warp as tw
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
    """One K5 call a band for the whole stack, and no K1 call."""
    planes, flows = stack_and_flows
    _, g = _grids()
    imgs, flow = torch.from_numpy(planes[:2]), torch.from_numpy(flows["small"])
    before = (kernel_sample.sample_displaced_multi_plain.calls,
              kernel_sample.sample_displaced_plain.calls)
    _apply_flow_planes(imgs, flow, g, torch.uint16, band_rows=64)
    assert kernel_sample.sample_displaced_multi_plain.calls - before[0] == -(-H // 64)
    assert kernel_sample.sample_displaced_plain.calls == before[1]


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
