"""The slice as a whole: the port's OptFlowRegistrator, Warper, banded flow,
tiled composition and per-plane apply against the JAX package, on the same
numpy images.

At 420 x 440 with pyramid 2, tile 220 and overlap 50, the two coarse levels
take the whole-image path and the full-resolution level the banded path; the
``band_rows=64`` case cuts that level into seven bands on both sides.

Bars and their reasons:
* accept/reject identical at every level;
* NMI gate scores within 5e-5: the gate scores DoG images, whose Gaussian
  sums XLA contracts into FMAs under ``jit``, so a few u8 gate pixels (about
  0.01%) land one level apart, and the JAX package sums its entropies in
  float32 (5e-6, see test_torch_mutual_info.py);
* flow mean < 1e-3 px and max < 0.05 px (the cv2 bars of the JAX package's
  own tests): the last-bit differences of every stage compound over three
  levels of three iterations;
* a warped u16 plane of a smooth image within 2 LSB on >= 99.9% of pixels.

With ``use_dog`` the Farneback inputs are themselves DoG images, so the
gate's one-level differences reach the flow: there the bars are MI within
5e-4 and flow mean < 2e-3 px, max < 0.05 px (measured 2.4e-4, 1.0e-3 and
0.033).
"""

import contextlib
import io
import os

import cv2 as cv
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import microaligner_tpu_torch as port
from microaligner_tpu.optflow.flow_calc import calc_flow_dense_banded as j_dense
from microaligner_tpu.optflow.registrator import OptFlowRegistrator as JReg
from microaligner_tpu.optflow.warper import Warper as JWarper
from microaligner_tpu.optflow.warper import compose_flows_tiled as j_compose_tiled
from microaligner_tpu.pipeline.runner import _apply_flow_plane as j_apply
from microaligner_tpu.tiles import TileGrid as JGrid
from microaligner_tpu_torch.optflow.flow_calc import (
    calc_flow_and_warp_dense_banded,
    calc_flow_dense_banded,
)
from microaligner_tpu_torch.optflow.registrator import merge_two_flows
from microaligner_tpu_torch.optflow.warper import compose_flows_tiled
from microaligner_tpu_torch.pipeline.runner import _apply_flow_plane
from microaligner_tpu_torch.tiles import TileGrid

torch.set_num_threads(1)

H, W, TILE, OVERLAP = 420, 440, 220, 50
MI_ATOL = 5e-5


def _textured(rng, h, w, sigma=3.0):
    img = cv.GaussianBlur(rng.random((h, w), dtype=np.float32), (0, 0), sigma)
    return cv.normalize(img, None, 0, 255, cv.NORM_MINMAX, cv.CV_8U)


def _warped_pair(seed=11):
    rng = np.random.default_rng(seed)
    ref = _textured(rng, H, W)
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    mov = cv.remap(ref, xs + 3.0 * np.sin(ys / 60), ys + 2.0 * np.cos(xs / 55), cv.INTER_LINEAR)
    return ref, mov


def _configure(reg, ref, mov, use_dog):
    reg.num_pyr_lvl = 2
    reg.num_iterations = 3
    reg.tile_size = TILE
    reg.overlap = OVERLAP
    reg.use_full_res_img = True
    reg.use_dog = use_dog
    reg.ref_img = ref
    reg.mov_img = mov
    return reg


@contextlib.contextmanager
def _jax_band_rows(band_rows):
    """The JAX package reads its band height from the environment."""
    saved = os.environ.get("MICROALIGNER_TPU_FLOW_BAND_ROWS")
    if band_rows is not None:
        os.environ["MICROALIGNER_TPU_FLOW_BAND_ROWS"] = str(band_rows)
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("MICROALIGNER_TPU_FLOW_BAND_ROWS", None)
        else:
            os.environ["MICROALIGNER_TPU_FLOW_BAND_ROWS"] = saved


def _register_both(band_rows, use_dog):
    ref, mov = _warped_pair()
    jreg = _configure(JReg(), ref, mov, use_dog)
    buf = io.StringIO()  # the JAX package reports its gate scores only in its log
    with _jax_band_rows(band_rows), contextlib.redirect_stdout(buf):
        jflow = jreg.register()
    jscores = [
        (float(line.split("after:")[1].split("|")[0]), float(line.split("before:")[1]))
        for line in buf.getvalue().splitlines() if "MI score after" in line
    ]
    treg = _configure(port.OptFlowRegistrator(), ref, mov, use_dog)
    treg.band_rows = band_rows
    tflow = treg.register()
    return dict(ref=ref, mov=mov, jflow=jflow, jscores=jscores, tflow=tflow,
                tscores=[(a, b) for _, a, b in treg.last_scores], band_rows=band_rows)


@pytest.fixture(scope="module", params=[None, 64], ids=["one-band", "band_rows-64"])
def registered(request):
    return _register_both(request.param, use_dog=False)


def _check_registration(reg, mi_atol, mean_px, max_px):
    js, ts = reg["jscores"], reg["tscores"]
    assert len(js) == len(ts) == 3
    for (ja, jb), (ta, tb) in zip(js, ts):
        assert (ja > jb) == (ta > tb)
        assert abs(ja - ta) <= mi_atol and abs(jb - tb) <= mi_atol
    err = np.abs(reg["tflow"] - reg["jflow"])
    assert reg["tflow"].shape == (H, W, 2)
    assert err.mean() < mean_px and err.max() < max_px, (err.mean(), err.max())


def test_register_gate_and_flow(registered):
    _check_registration(registered, MI_ATOL, 1e-3, 0.05)


def test_register_with_dog():
    _check_registration(_register_both(None, use_dog=True), 5e-4, 2e-3, 0.05)


def test_warped_u16_plane(registered):
    """Both packages warp the same smooth u16 plane by their own flow."""
    rng = np.random.default_rng(5)
    plane = cv.GaussianBlur(rng.random((H, W), dtype=np.float32), (0, 0), 6.0)
    plane = cv.normalize(plane, None, 0, 60000, cv.NORM_MINMAX).astype(np.uint16)
    outs = []
    for warper, flow in ((JWarper(), registered["jflow"]), (port.Warper(), registered["tflow"])):
        warper.tile_size, warper.overlap = TILE, OVERLAP
        warper.image, warper.flow = plane, flow
        outs.append(warper.warp())
    assert outs[1].dtype == np.uint16
    diff = np.abs(outs[0].astype(np.int64) - outs[1].astype(np.int64))
    assert (diff <= 2).mean() >= 0.999


def test_apply_flow_plane(registered):
    """The per-plane apply of the CLI loop, on the JAX flow for both."""
    rng = np.random.default_rng(6)
    plane = cv.GaussianBlur(rng.random((H, W), dtype=np.float32), (0, 0), 6.0)
    plane = cv.normalize(plane, None, 0, 60000, cv.NORM_MINMAX).astype(np.uint16)
    flow = registered["jflow"]
    band_rows = registered["band_rows"]
    with _jax_band_rows(band_rows):
        want = np.asarray(j_apply(jnp.asarray(plane), jnp.asarray(flow),
                                  JGrid.for_image((H, W), TILE, OVERLAP), "uint16"))
    got = _apply_flow_plane(torch.from_numpy(plane), torch.from_numpy(flow),
                            TileGrid.for_image((H, W), TILE, OVERLAP), torch.uint16, band_rows).numpy()
    diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
    # the same flow on both sides: only values within last bits of a .5 tie
    # round apart (0.11% measured)
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-2


@pytest.mark.parametrize("band_rows", [None, 40])
def test_dense_banded_flow_and_fused_warp(band_rows, monkeypatch):
    ref, mov = _warped_pair(seed=3)
    ref, mov = ref[:180, :230], mov[:180, :230]
    if band_rows is not None:
        monkeypatch.setenv("MICROALIGNER_TPU_FLOW_BAND_ROWS", str(band_rows))
    jg = JGrid.for_image(ref.shape, 100, 30)
    tg = TileGrid.for_image(ref.shape, 100, 30)
    want = np.asarray(j_dense(jnp.asarray(ref), jnp.asarray(mov), jg, 29, 2))
    got = calc_flow_dense_banded(torch.from_numpy(ref), torch.from_numpy(mov), tg, 29, 2, band_rows).numpy()
    err = np.abs(got - want)
    assert err.mean() < 1e-4 and err.max() < 1e-2, (err.mean(), err.max())
    flow, warped = calc_flow_and_warp_dense_banded(
        torch.from_numpy(ref), torch.from_numpy(mov), torch.from_numpy(mov), tg, 29, 2,
        torch.uint8, band_rows,
    )
    np.testing.assert_array_equal(flow.numpy(), got)
    # the fused warp zeroes the band halo's flow: it equals the band warp
    sep = port.Warper()
    sep.tile_size, sep.overlap, sep.band_rows = 100, 30, band_rows
    sep.image, sep.flow = mov, got
    np.testing.assert_array_equal(warped.numpy(), sep.warp())


@pytest.mark.parametrize("mag", [1.5, 30.0])
def test_compose_flows_tiled(mag, monkeypatch):
    from microaligner_tpu_torch.optflow import warper

    monkeypatch.setattr(warper, "_COMPOSE_BATCH", 4)  # several chunks of windows
    h, w = 260, 300
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    f1 = np.stack([mag * np.sin(ys / 60 + 0.4), mag * np.cos(xs / 60 + 1.3)], -1).astype(np.float32)
    f2 = np.stack([mag / 3 * np.sin(ys / 50 + 2.0), mag / 3 * np.cos(xs / 45)], -1).astype(np.float32)
    f2[:120, :120] = 0.0  # a tile whose f2 is all zero takes the short-circuit
    want = np.asarray(j_compose_tiled(jnp.asarray(f1), jnp.asarray(f2), JGrid.for_image((h, w), 120, 40)))
    got = compose_flows_tiled(torch.from_numpy(f1), torch.from_numpy(f2),
                              TileGrid.for_image((h, w), 120, 40)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4 * mag)


def test_merge_two_flows():
    from microaligner_tpu.optflow.registrator import merge_two_flows as j_merge

    ys, xs = np.mgrid[0:50, 0:60].astype(np.float32)
    f1 = np.stack([np.sin(ys / 9), np.cos(xs / 7)], -1).astype(np.float32)
    f2 = np.stack([np.cos(ys / 5), np.sin(xs / 11)], -1).astype(np.float32)
    np.testing.assert_allclose(merge_two_flows(f1, f2), j_merge(f1, f2), atol=1e-5)


def test_register_device_and_checks():
    ref, mov = _warped_pair(seed=4)
    ref, mov = ref[:200, :210], mov[:200, :210]
    reg = port.OptFlowRegistrator()
    reg.num_pyr_lvl, reg.tile_size, reg.overlap, reg.num_iterations = 1, 1000, 50, 2
    reg.ref_img, reg.mov_img = torch.from_numpy(ref), mov
    dev_flow = reg.register_device()
    assert isinstance(dev_flow, torch.Tensor) and dev_flow.shape == (200, 210, 2)
    reg2 = port.OptFlowRegistrator()
    reg2.num_pyr_lvl, reg2.tile_size, reg2.overlap, reg2.num_iterations = 1, 1000, 50, 2
    reg2.ref_img, reg2.mov_img = ref, mov
    np.testing.assert_array_equal(reg2.register(), dev_flow.numpy())
    with pytest.raises(ValueError):
        reg2.ref_img = np.zeros((4, 5, 6), np.uint8)
    small = port.OptFlowRegistrator()
    small.ref_img, small.mov_img = ref[:150, :150], mov[:150, :150]
    with pytest.raises(ValueError):
        small.register()
    zero = port.OptFlowRegistrator()
    zero.num_pyr_lvl = 0
    zero.ref_img, zero.mov_img = ref, mov
    with pytest.raises(ValueError):
        zero.register()


@pytest.mark.parametrize("tile", [1000, 100])
def test_tile_flow_calc(tile):
    """The property-style TileFlowCalc on its whole-image and banded paths."""
    from microaligner_tpu.optflow.flow_calc import TileFlowCalc as JCalc
    from microaligner_tpu_torch.optflow.flow_calc import TileFlowCalc as TCalc

    ref, mov = _warped_pair(seed=8)
    ref, mov = ref[:200, :230], mov[:200, :230]
    flows = []
    for calc in (JCalc(), TCalc()):
        calc.tile_size, calc.overlap, calc.win_size, calc.num_iter = tile, 30, 29, 2
        calc.ref_img, calc.mov_img = ref, mov
        flows.append(calc.calc_flow())
    err = np.abs(flows[0] - flows[1])
    assert flows[1].shape == (200, 230, 2)
    assert err.mean() < 1e-4 and err.max() < 1e-2, (err.mean(), err.max())
