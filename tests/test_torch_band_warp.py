"""The one-plane band warps, one launch of K5's band entry a band.

``sample_band_multi`` reads (N, H, W) planes in their stored dtype, pulls
them by the (H, W, 2) flow (or a band's own flow in slab coordinates) and
rounds into the output's band rows.  With N = 1 it is the band entry of
``warp_tiled_dtype`` (``Warper.warp_device``, the registrator's pre- and
post-warps), ``_apply_flow_plane`` and the banded Farneback's post-warp,
which call it once a band: on the H100, K5 at one plane was faster than a
typed band entry of K1's own (``PERF.md``).  On the CPU it takes its
plain version, which is the composition these warps used before (an f32
slab of the zero canvas, zero-padded flow slabs, K1 on the negated flow,
crop, ``round_to_dtype``), so:

* the band warps equal that composition bit for bit, for all six dtypes,
  several band heights and a last band shorter than the rest, and the
  banded Farneback's post-warp equals its previous composition (whose halo
  flow it zeroed);
* against the JAX package: ``warp_tiled_dtype``, ``Warper.warp_device``
  and ``_apply_flow_plane`` with the bars of ``tests/test_warp_planes.py``
  and ``tests/test_torch_optflow_engine.py`` (u16 within 1 level at < 1%
  of pixels on the same flow: rounding half to even crosses a .5 tie where
  the two sides' weights differ in the last bit; f32 unit-range planes
  within 1e-4), and the banded Farneback with its post-warp (flow mean <
  1e-4 and max < 1e-2 px, the warped plane within 2 levels on >= 99.9% of
  pixels, as the existing tests hold them);
* one call a band and nothing else that samples, and the slab flow's
  checks.
"""

import contextlib
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from microaligner_tpu.optflow.flow_calc import calc_flow_and_warp_dense_banded as j_dense_warp
from microaligner_tpu.optflow.warper import warp_tiled_dtype as j_warp_dtype
from microaligner_tpu.pipeline.runner import _apply_flow_plane as j_apply
from microaligner_tpu.tiles import TileGrid as JGrid
from microaligner_tpu_torch.ops import kernel_sample as ks
from microaligner_tpu_torch.ops.filters import round_to_dtype
from microaligner_tpu_torch.ops.pad import zero_pad
from microaligner_tpu_torch.ops.warp import warp_with_flow_parts_batched
from microaligner_tpu_torch.optflow.farneback import _farneback_core_parts
from microaligner_tpu_torch.optflow.flow_calc import band_rows_for, band_slab, calc_flow_and_warp_dense_banded
from microaligner_tpu_torch.optflow.warper import Warper, warp_tiled_dtype
from microaligner_tpu_torch.pipeline.runner import _apply_flow_plane
from microaligner_tpu_torch.tiles import TileGrid

torch.set_num_threads(1)

H, W, TILE, OVERLAP = 150, 170, 70, 12
NAMES = ["uint8", "int8", "uint16", "int16", "int32", "float32"]


def _plane(rng, name, h=H, w=W):
    base = rng.integers(0, 65535, (h, w))
    return {"uint8": base % 256, "int8": base % 256 - 128, "uint16": base, "int16": base - 32768,
            "int32": (base - 32768) * 65537, "float32": base / 65535.0}[name].astype(name)


def _flow(kind, h=H, w=W):
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    if kind == "smooth":
        return np.stack([2.0 * np.sin(ys / 17), 1.5 * np.cos(xs / 23)], -1).astype(np.float32)
    if kind == "beyond":  # beyond the overlap: taps outside the band's halo read zero
        return np.stack([20.0 * np.sin(ys / 30), 16.0 * np.cos(xs / 25)], -1).astype(np.float32)
    return np.random.default_rng(5).uniform(-9, 9, (h, w, 2)).astype(np.float32)


def _previous_warp_banded(image, flow, grid, out_dtype, band_rows):
    """``_warp_banded`` as the port computed it before the band entry."""
    o, h, w = grid.overlap, grid.height, grid.width
    nb = -(-h // band_rows)
    bands = []
    for i in range(nb):
        row0 = i * band_rows
        n_in = min(band_rows, h - row0)
        src = band_slab(image, row0, band_rows, o)
        fx = zero_pad(flow[row0 : row0 + n_in, :, 0], o, band_rows - n_in + o, o, o)
        fy = zero_pad(flow[row0 : row0 + n_in, :, 1], o, band_rows - n_in + o, o, o)
        warped = warp_with_flow_parts_batched(src[None], fx[None], fy[None])
        bands.append(round_to_dtype(warped[:, o : o + band_rows, o : o + w], out_dtype))
    return torch.cat(bands).reshape(nb * band_rows, w)[:h]


@contextlib.contextmanager
def _jax_band_rows(band_rows):
    """The JAX package reads its band height from the environment."""
    saved = os.environ.pop("MICROALIGNER_TPU_FLOW_BAND_ROWS", None)
    if band_rows is not None:
        os.environ["MICROALIGNER_TPU_FLOW_BAND_ROWS"] = str(band_rows)
    try:
        yield
    finally:
        os.environ.pop("MICROALIGNER_TPU_FLOW_BAND_ROWS", None)
        if saved is not None:
            os.environ["MICROALIGNER_TPU_FLOW_BAND_ROWS"] = saved


@pytest.mark.parametrize("band_rows", [None, 64, 50, 8])  # one band; last band 22, 50 and 6 rows
@pytest.mark.parametrize("name", NAMES)
def test_band_entry_plain_equals_previous_composition(name, band_rows):
    rng = np.random.default_rng(NAMES.index(name))
    img = torch.from_numpy(_plane(rng, name))
    grid = TileGrid.for_image((H, W), TILE, OVERLAP)
    rows = band_rows_for(grid, band_rows)
    for kind in ("smooth", "random", "beyond"):
        flow = torch.from_numpy(_flow(kind))
        got = warp_tiled_dtype(img, flow, grid, img.dtype, band_rows)
        assert got.dtype == img.dtype
        assert torch.equal(got, _previous_warp_banded(img, flow, grid, img.dtype, rows)), kind


@pytest.mark.parametrize("src,dst", [("uint16", "float32"), ("uint8", "uint16"), ("float32", "int16"),
                                     ("float64", "uint16"), ("int16", "int64")])
def test_other_dtype_pairs_equal_previous_composition(src, dst):
    """Pairs of stored and output dtype other than one of the kernel's six
    in and out go through its float32 instantiation on the band's source
    rows, then are rounded."""
    rng = np.random.default_rng(8)
    img = torch.from_numpy(_plane(rng, "uint16").astype(src))
    grid = TileGrid.for_image((H, W), TILE, OVERLAP)
    flow = torch.from_numpy(_flow("smooth"))
    dt = getattr(torch, dst)
    got = warp_tiled_dtype(img, flow, grid, dt, 64)
    assert got.dtype == dt and torch.equal(got, _previous_warp_banded(img, flow, grid, dt, 64))


def test_post_warp_plain_equals_previous_composition():
    """The band's own flow in slab coordinates, its halo not read, equals
    the warp by the flow with its halo zeroed (the previous post-warp)."""
    rng = np.random.default_rng(9)
    img = torch.from_numpy(_plane(rng, "uint16"))
    ref = torch.from_numpy(_plane(rng, "float32")) * 255
    rows, o = 64, OVERLAP
    interior = torch.zeros((rows + 2 * o, W + 2 * o))
    interior[o : o + rows, o : o + W] = 1.0
    got, want = torch.empty_like(img), torch.empty_like(img)
    for row0 in range(0, H, rows):
        n_in = min(rows, H - row0)
        fx, fy = _farneback_core_parts(band_slab(img, row0, rows, o)[None], band_slab(ref, row0, rows, o)[None],
                                       15, 2, 1, 1.7)
        fx, fy = fx * 6, fy * 6  # displacements of several pixels
        ks.sample_band_multi(img[None], (fx[0], fy[0]), got[None], row0, rows, o)
        warped = warp_with_flow_parts_batched(band_slab(img, row0, rows, o)[None], fx * interior, fy * interior)
        want[row0 : row0 + n_in] = round_to_dtype(warped[0, o : o + n_in, o : o + W], torch.uint16)
    assert torch.equal(got, want)


@pytest.mark.parametrize("band_rows", [None, 40])
@pytest.mark.parametrize("name", ["uint16", "uint8", "float32"])
def test_warp_tiled_dtype_and_apply_match_jax(name, band_rows):
    rng = np.random.default_rng(12)
    plane = _plane(rng, name)
    flow = _flow("smooth")
    jg, tg = JGrid.for_image((H, W), TILE, OVERLAP), TileGrid.for_image((H, W), TILE, OVERLAP)
    with _jax_band_rows(band_rows):
        want = np.asarray(j_warp_dtype(jnp.asarray(plane), jnp.asarray(flow), jg, name))
        want_apply = np.asarray(j_apply(jnp.asarray(plane), jnp.asarray(flow), jg, name))
    np.testing.assert_array_equal(want, want_apply)
    warper = Warper(device="cpu")
    warper.tile_size, warper.overlap, warper.band_rows = TILE, OVERLAP, band_rows
    warper.image, warper.flow = plane, flow
    gots = {"warp_tiled_dtype": warp_tiled_dtype(torch.from_numpy(plane), torch.from_numpy(flow), tg,
                                                 getattr(torch, name), band_rows).numpy(),
            "_apply_flow_plane": _apply_flow_plane(torch.from_numpy(plane), torch.from_numpy(flow), tg,
                                                   getattr(torch, name), band_rows).numpy(),
            "Warper.warp_device": warper.warp_device().numpy()}
    for label, got in gots.items():
        assert got.dtype == np.dtype(name), label
        if name == "float32":
            np.testing.assert_allclose(got, want, atol=1e-4, rtol=0, err_msg=label)
        else:
            diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
            assert diff.max() <= 1 and (diff > 0).mean() < 1e-2, label


@pytest.mark.parametrize("band_rows", [None, 40])
def test_dense_banded_post_warp_matches_jax(band_rows):
    rng = np.random.default_rng(13)
    import cv2 as cv

    ref = cv.normalize(cv.GaussianBlur(rng.random((H, W), dtype=np.float32), (0, 0), 3.0), None, 0, 255,
                       cv.NORM_MINMAX, cv.CV_8U)
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    mov = cv.remap(ref, xs + 2.0 * np.sin(ys / 40), ys + 1.5 * np.cos(xs / 35), cv.INTER_LINEAR)
    src = (mov.astype(np.uint16) * 200 + 300).astype(np.uint16)
    jg, tg = JGrid.for_image((H, W), TILE, OVERLAP), TileGrid.for_image((H, W), TILE, OVERLAP)
    with _jax_band_rows(band_rows):
        jflow, jwarped = j_dense_warp(jnp.asarray(ref), jnp.asarray(mov), jnp.asarray(src), jg, 29, 2, "uint16")
    flow, warped = calc_flow_and_warp_dense_banded(torch.from_numpy(ref), torch.from_numpy(mov),
                                                   torch.from_numpy(src), tg, 29, 2, torch.uint16, band_rows)
    err = np.abs(flow.numpy() - np.asarray(jflow))
    assert err.mean() < 1e-4 and err.max() < 1e-2, (err.mean(), err.max())
    diff = np.abs(warped.numpy().astype(np.int64) - np.asarray(jwarped).astype(np.int64))
    assert warped.dtype == torch.uint16 and (diff <= 2).mean() >= 0.999


def _counts():
    return (ks.sample_band_multi_plain.calls, ks.sample_band_multi.launches, ks.sample_displaced.launches,
            ks.sample_displaced_plain.calls, ks.sample_displaced_multi.launches)


@pytest.mark.parametrize("band_rows", [None, 64, 50])
def test_one_band_entry_call_a_band(band_rows):
    """``_warp_banded``, ``_apply_flow_plane`` and the banded Farneback's
    post-warp call the band entry once a band and nothing else that samples;
    on the CPU it takes its plain version and launches nothing."""
    rng = np.random.default_rng(14)
    img = torch.from_numpy(_plane(rng, "uint16"))
    flow = torch.from_numpy(_flow("smooth"))
    grid = TileGrid.for_image((H, W), TILE, OVERLAP)
    bands = -(-H // band_rows_for(grid, band_rows))
    warper = Warper(device="cpu")
    warper.tile_size, warper.overlap, warper.band_rows = TILE, OVERLAP, band_rows
    ref = torch.from_numpy(_plane(rng, "uint8"))
    calls = {"warp_tiled_dtype": lambda: warp_tiled_dtype(img, flow, grid, torch.uint16, band_rows),
             "_apply_flow_plane": lambda: _apply_flow_plane(img, flow, grid, torch.uint16, band_rows),
             "Warper.warp_device": lambda: (setattr(warper, "image", img), setattr(warper, "flow", flow),
                                            warper.warp_device()),
             "post-warp": lambda: calc_flow_and_warp_dense_banded(ref, ref, img, grid, 15, 1, torch.uint16,
                                                                  band_rows)}
    for label, fn in calls.items():
        before = _counts()
        fn()
        after = _counts()
        assert after[0] - before[0] == bands, label
        assert after[1:] == before[1:], label  # no launch on the CPU, no K5


def test_band_entry_slab_flow_checks():
    """A band's own flow in slab coordinates: a pair of (rows + 2 overlap,
    W + 2 overlap) float32 planes; on the CPU the plain version runs and
    nothing launches."""
    img = torch.zeros((1, 12, 14), dtype=torch.uint16)
    out = torch.empty_like(img)
    slab = torch.zeros((14, 20))
    before = (ks.sample_band_multi_plain.calls, ks.sample_band_multi.launches)
    assert ks.sample_band_multi(img, (slab, slab), out, 8, 8, 3) is out  # last band: 4 rows
    assert (ks.sample_band_multi_plain.calls, ks.sample_band_multi.launches) == (before[0] + 1, before[1])
    bad_calls = [
        (TypeError, lambda: ks.sample_band_multi(img, (slab.double(), slab), out, 0, 8, 3)),
        (ValueError, lambda: ks.sample_band_multi(img, (slab[:, :19].contiguous(), slab), out, 0, 8, 3)),
        (ValueError, lambda: ks.sample_band_multi(img, (slab, slab), out, 0, 9, 3)),  # the slab of 9 rows
        (ValueError, lambda: ks.sample_band_multi(img, (slab,), out, 0, 8, 3)),
        (ValueError, lambda: ks.sample_band_multi(img, (slab, slab.t().contiguous().t()), out, 0, 8, 3)),
    ]
    for exc, fn in bad_calls:
        with pytest.raises(exc):
            fn()
    assert ks.sample_band_multi_plain.calls == before[0] + 1


def test_float32_entry_dispatch_and_checks():
    """K1's float32 entry on the CPU takes its plain version; it refuses
    what its kernel does not take."""
    img = torch.zeros((2, 9, 11))
    f = torch.zeros((2, 9, 11))
    before = (ks.sample_displaced_plain.calls, ks.sample_displaced.launches)
    ks.sample_displaced(img, f, f)
    assert (ks.sample_displaced_plain.calls, ks.sample_displaced.launches) == (before[0] + 1, before[1])
    for exc, fn in ((TypeError, lambda: ks.sample_displaced(img.double(), f, f)),
                    (ValueError, lambda: ks.sample_displaced(img, f[:1], f[:1])),
                    (ValueError, lambda: ks.sample_displaced(img, f, f[:, :5].contiguous())),
                    (ValueError, lambda: ks.sample_displaced(img, f.transpose(1, 2), f)),
                    (ValueError, lambda: ks.sample_displaced(img[0], f[0], f[0]))):
        with pytest.raises(exc):
            fn()
