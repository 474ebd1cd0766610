"""The port's integer rounding saturates at every integer type's range.

``round_to_dtype`` (tensors) and ``round_to_numpy_dtype`` (the CLI's host
rounding of planes the port warps in float32, such as uint32) round half to
even and saturate: a value at or above the type's maximum gives the
maximum, one at or below its minimum the minimum.  For the 32-bit types the
float32 bound of the maximum, 2**31 or 2**32, is out of range, so they
round and clamp in float64; the 8- and 16-bit types keep their float32
passes and give the same bits as before.

Held against:
* the JAX package's ``_apply_flow_plane`` (its XLA clip and cast saturate)
  for int32 planes at and above the int32 maximum;
* for uint32, ``cv.remap``'s ``saturate_cast``: OpenCV 5's ``cv.remap``
  does not take uint32 planes (asserted below), so the bar is the plane
  remapped in float64 by ``cv.remap`` and then saturated, the conversion
  ``cv.remap`` applies to the types it takes (shown for uint16 at its
  maximum).
"""

import cv2 as cv
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from microaligner_tpu.pipeline.runner import _apply_flow_plane as j_apply
from microaligner_tpu.tiles import TileGrid as JGrid
from microaligner_tpu_torch.ops.filters import round_to_dtype
from microaligner_tpu_torch.optflow.warper import Warper, round_to_numpy_dtype
from microaligner_tpu_torch.pipeline.runner import _apply_flow_plane
from microaligner_tpu_torch.tiles import TileGrid

torch.set_num_threads(1)

I32_MAX, U32_MAX = 2**31 - 1, 2**32 - 1
# float32 values at and around the 32-bit bounds: 2**31 and 2**32 are the float32 images of the maxima
EDGES_F32 = np.array([2147483647.0, 2147483520.0, 3e9, 4294967295.0, 4294967040.0, 5e9, -2147483648.0, -3e9,
                      -0.5, 0.5, 1.5, 2.5, -2.5, np.inf, -np.inf], dtype=np.float32)


def _saturated(values, lo, hi):
    """Round half to even and saturate, in Python integers."""
    out = []
    for v in values.astype(np.float64):
        out.append(lo if v <= lo else hi if v >= hi else min(max(round(v), lo), hi))
    return out


def test_round_to_dtype_int32_matches_jax_clip_and_cast():
    info = jnp.iinfo(jnp.int32)
    want = np.asarray(jnp.clip(jnp.round(jnp.asarray(EDGES_F32)), info.min, info.max).astype(jnp.int32))
    got = round_to_dtype(torch.from_numpy(EDGES_F32), torch.int32).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.tolist() == _saturated(EDGES_F32, -(2**31), I32_MAX)


@pytest.mark.parametrize("shift", [0.0, 0.5])
def test_apply_flow_plane_int32_at_its_maximum_matches_jax(shift):
    """An int32 plane at and near its maximum, warped by a zero flow (with
    its minimum too) and by a half-pixel flow (values whose float32 image is
    2**31, so that every blend is exact on both sides, which contract their
    multiply-adds differently): the port's apply saturates where the JAX
    function's clip and cast do."""
    h, w = 40, 52
    rng = np.random.default_rng(3)
    values = [I32_MAX, I32_MAX - 1, I32_MAX - 60] + ([2**31 - 200, -(2**31), -(2**31) + 3] if shift == 0 else [])
    plane = rng.choice(np.array(values, np.int32), (h, w))
    flow = np.full((h, w, 2), shift, np.float32)
    want = np.asarray(j_apply(jnp.asarray(plane), jnp.asarray(flow), JGrid.for_image((h, w), 30, 8), "int32"))
    got = _apply_flow_plane(torch.from_numpy(plane), torch.from_numpy(flow), TileGrid.for_image((h, w), 30, 8),
                            torch.int32, band_rows=16).numpy()
    np.testing.assert_array_equal(got, want)
    assert int(got.max()) == I32_MAX


def test_round_to_numpy_dtype_uint32_saturates():
    got = round_to_numpy_dtype(EDGES_F32, np.uint32)
    assert got.tolist() == _saturated(EDGES_F32, 0, U32_MAX)
    assert round_to_numpy_dtype(EDGES_F32, np.int32).tolist() == _saturated(EDGES_F32, -(2**31), I32_MAX)


def test_uint32_plane_at_its_maximum_against_cv_remap():
    """``Warper.warp`` on a uint32 plane (float32 warp, host rounding)
    against ``cv.remap`` in float64 followed by the saturating conversion."""
    h, w = 36, 40
    rng = np.random.default_rng(4)
    plane = rng.choice(np.array([U32_MAX, 2**32 - 256, 123456, 0], np.uint32), (h, w))
    with pytest.raises(cv.error):  # cv.remap does not take uint32 planes
        cv.remap(plane, np.zeros((h, w), np.float32), np.zeros((h, w), np.float32), cv.INTER_LINEAR)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    remapped = cv.remap(plane.astype(np.float64), xs, ys, cv.INTER_LINEAR, borderMode=cv.BORDER_CONSTANT)
    want = np.clip(np.round(remapped), 0, U32_MAX).astype(np.uint32)
    warper = Warper(device="cpu")
    warper.tile_size, warper.overlap = 20, 6
    warper.image, warper.flow = plane, np.zeros((h, w, 2), np.float32)
    got = warper.warp()
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, want)
    assert int(got.max()) == U32_MAX


def test_uint16_at_its_maximum_as_cv_remap_saturates():
    """The conversion the uint32 bar takes from ``cv.remap``: on a uint16
    plane at its maximum, cv.remap's own output equals the float64 remap
    saturated, and the port's host rounding gives the same."""
    h, w = 20, 24
    plane = np.full((h, w), 65535, np.uint16)
    plane[::3] = 65534
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    xs += 0.5
    direct = cv.remap(plane, xs, ys, cv.INTER_LINEAR, borderMode=cv.BORDER_CONSTANT)
    wide = cv.remap(plane.astype(np.float64), xs, ys, cv.INTER_LINEAR, borderMode=cv.BORDER_CONSTANT)
    np.testing.assert_array_equal(direct[:, :-1], np.clip(np.round(wide), 0, 65535).astype(np.uint16)[:, :-1])
    np.testing.assert_array_equal(round_to_numpy_dtype(wide.astype(np.float32), np.uint16)[:, :-1], direct[:, :-1])


@pytest.mark.parametrize("dtype", ["int32", "uint32"])
def test_infinities_saturate_on_32_bit_types(dtype):
    x = np.array([np.inf, -np.inf, 1e30, -1e30], np.float32)
    info = np.iinfo(dtype)
    want = [info.max, info.min, info.max, info.min]
    assert round_to_numpy_dtype(x, dtype).tolist() == want
    if dtype == "int32":
        assert round_to_dtype(torch.from_numpy(x), torch.int32).tolist() == want


@pytest.mark.parametrize("name", ["uint8", "int8", "uint16", "int16"])
def test_narrow_types_keep_their_bits(name):
    """The 8- and 16-bit types round and clamp in float32 as before."""
    info = np.iinfo(name)
    x = np.array([info.min - 1e9, info.min - 1.0, info.min - 0.5, info.min + 0.5, -0.5, 0.5, 1.5, 2.5,
                  info.max - 0.5, info.max - 0.4, info.max + 0.5, info.max + 1e9, np.inf, -np.inf], np.float32)
    dt = getattr(torch, name)
    before = torch.clamp(torch.round(torch.from_numpy(x)), int(info.min), int(info.max)).to(dt)
    assert torch.equal(round_to_dtype(torch.from_numpy(x), dt), before)
    assert round_to_numpy_dtype(x, name).tolist() == np.clip(np.round(x), info.min, info.max).astype(name).tolist()
    assert round_to_dtype(torch.from_numpy(x), dt).tolist() == _saturated(x, int(info.min), int(info.max))
