"""The optflow engine's alternate routes in the port against the JAX
package's same routes, on the same numpy inputs:

* the strict-parity per-tile route (``MICROALIGNER_TPU_FLOW_DENSE=0``): the
  per-tile flow, its fused post-warp, the per-tile warp, the per-plane and
  z-stack applies, and the chunk size ``MICROALIGNER_TPU_FLOW_TILE_BATCH``;
* the port's one driver, the carry loop, against the JAX package's
  per-level carry driver (``MICROALIGNER_TPU_WHOLE_REGISTER=0``) and its
  stepwise host driver (``MICROALIGNER_TPU_CARRY_LEVEL=0``), with a
  rejected middle level, a single-level pyramid, and on the per-tile route;
  the port ignores both variables;
* the port's registrator against ``scripts/reference_recon.py`` (cv2 and
  sklearn), on both ``FLOW_DENSE`` routes.

Every route variable is set with ``monkeypatch.setenv`` for both
packages, the driver variables for the JAX package's run only, and
``jax.clear_caches()`` follows each change: the JAX package reads
``FLOW_DENSE`` while it traces, so a cached trace would keep the old route.

Bars and their reasons:
* per-tile flow: mean < 1e-4 px and max < 1e-2 px against JAX, the bars of
  the port's banded flow (tests/test_torch_optflow_engine.py): XLA
  contracts multiply-adds into FMAs, the port rounds each;
* the fused flow + warp against the flow followed by the per-tile warp, in
  the port: JAX's ``TestFusedFlowWarp`` bars (flow 1e-5, f32 warp 1e-4,
  integer warps within 1 LSB on < 0.1% of pixels); measured bit-equal;
* the per-tile warp and the applies against JAX's, the same flow on both
  sides: integer planes within 1 LSB on < 1% of pixels (``_lsb_apart``:
  the JAX gather's absolute float32 coordinates and XLA's FMAs move a last
  bit, which can cross a .5 tie; measured 0.1% on a u16 plane), float32
  within 1e-4; the port's Warper, per-plane and z-stack applies equal its
  per-tile warp bit for bit;
* the drivers: the same accept/reject at every level, gate scores within
  5e-5 and flow mean < 1e-3 px, max < 0.05 px against JAX (the bars of
  tests/test_torch_optflow_engine.py); the port's flow equal to its run
  computed once a case, bit for bit;
* the carry loop's ``pyr_up`` and ``compose_flows_tiled`` against the JAX
  package's ``_upscale_flow_to_full_res`` and ``_merge_list_of_flows``:
  within 1e-5 and 1e-4 px (the same formulas; XLA contracts multiply-adds
  into FMAs, the port rounds each);
* the reference reconstruction: tests/test_e2e_reference_recon.py's bars,
  warped MSE < 1e-3 in unit range and interior flow mean < 0.05 px.
"""

import contextlib
import io
import os
import sys
import zlib

import cv2 as cv
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import microaligner_tpu_torch as port
from microaligner_tpu.optflow import flow_calc as jfc
from microaligner_tpu.optflow import warper as jwarper
from microaligner_tpu.optflow.registrator import OptFlowRegistrator as JReg
from microaligner_tpu.pipeline.runner import _apply_flow_plane as j_apply
from microaligner_tpu.tiles import TileGrid as JGrid
from microaligner_tpu_torch.ops import mutual_info as tmi
from microaligner_tpu_torch.ops.filters import pyr_up
from microaligner_tpu_torch.optflow import flow_calc as tfc
from microaligner_tpu_torch.optflow import warper as twarper
from microaligner_tpu_torch.pipeline.runner import _apply_flow_plane, _apply_flow_planes
from microaligner_tpu_torch.tiles import TileGrid

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))

import reference_recon as recon  # noqa: E402

torch.set_num_threads(1)

H, W, TILE, OVERLAP, WIN, ITERS = 260, 300, 120, 40, 39, 2


def _seeded(nodeid: str):
    """The rng that tests/conftest.py's ``rng`` fixture gives ``nodeid``:
    a mirrored JAX test's own inputs."""
    return np.random.default_rng(zlib.crc32(nodeid.encode()))


def _textured(rng, h, w, sigma=2.5):
    img = cv.GaussianBlur(rng.random((h, w), dtype=np.float32), (0, 0), sigma)
    return cv.normalize(img, None, 0, 255, cv.NORM_MINMAX, cv.CV_8U)


def _route(monkeypatch, dense: str, **env):
    """Set ``MICROALIGNER_TPU_FLOW_DENSE`` (and any other variables) for
    both packages and drop the JAX package's traces."""
    monkeypatch.setenv("MICROALIGNER_TPU_FLOW_DENSE", dense)
    for name, value in env.items():
        monkeypatch.setenv(f"MICROALIGNER_TPU_{name}", value)
    jax.clear_caches()


@pytest.fixture(autouse=True)
def _fresh_traces():
    yield
    jax.clear_caches()  # no later test may reuse a trace made under this test's variables


@pytest.fixture(scope="module")
def pair():
    """tests/test_optflow_engine.py::TestFusedFlowWarp's pair: mov is ref
    shifted by (1.2, 0.8) px."""
    rng = _seeded("tests/test_optflow_engine.py::TestFusedFlowWarp::test_matches_two_pass[uint8]")
    ref = _textured(rng, H, W)
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    return ref, cv.remap(ref, xs + 1.2, ys + 0.8, cv.INTER_LINEAR)


def _grids(h=H, w=W, tile=TILE, overlap=OVERLAP):
    return JGrid.for_image((h, w), tile, overlap), TileGrid.for_image((h, w), tile, overlap)


def test_per_tile_flow_matches_jax(pair, monkeypatch):
    ref, mov = pair
    jg, tg = _grids()
    want = np.asarray(jfc._calc_flow_tiled(jnp.asarray(ref), jnp.asarray(mov), jg, WIN, ITERS, None, 8, False))
    got = tfc._calc_flow_tiled(torch.from_numpy(ref), torch.from_numpy(mov), tg, WIN, ITERS, 8).numpy()
    err = np.abs(got - want)
    assert got.shape == (H, W, 2)
    assert err.mean() < 1e-4 and err.max() < 1e-2, (err.mean(), err.max())
    # the public entry takes the per-tile route under FLOW_DENSE=0, and the banded one otherwise
    _route(monkeypatch, "0")
    np.testing.assert_array_equal(tfc.calc_flow_tiled(torch.from_numpy(ref), torch.from_numpy(mov), tg, WIN,
                                                      ITERS).numpy(), got)
    _route(monkeypatch, "1")
    banded = tfc.calc_flow_tiled(torch.from_numpy(ref), torch.from_numpy(mov), tg, WIN, ITERS).numpy()
    assert not np.array_equal(banded, got)
    np.testing.assert_array_equal(
        banded, tfc.calc_flow_dense_banded(torch.from_numpy(ref), torch.from_numpy(mov), tg, WIN, ITERS).numpy())


@pytest.mark.parametrize("dtype", ["uint8", "uint16", "float32"])
def test_fused_flow_and_warp_equals_two_passes(pair, dtype, monkeypatch):
    """JAX's TestFusedFlowWarp in the port, on the per-tile route: the fused
    flow + warp against the flow and then the per-tile warp."""
    _route(monkeypatch, "0")
    ref, mov = pair
    src = (mov.astype(np.float32) * 0.7 + 10.0).astype(dtype)
    tg = _grids()[1]
    r, m, s = (torch.from_numpy(a) for a in (ref, mov, src))
    flow2, warped2 = tfc.calc_flow_and_warp_tiled(r, m, s, tg, WIN, ITERS, s.dtype)
    flow1 = tfc.calc_flow_tiled(r, m, tg, WIN, ITERS)
    warped1 = twarper.warp_tiled_dtype(s, flow1, tg, s.dtype)
    np.testing.assert_allclose(flow2.numpy(), flow1.numpy(), atol=1e-5)
    assert warped2.dtype == s.dtype
    if dtype == "float32":
        np.testing.assert_allclose(warped2.numpy(), warped1.numpy(), atol=1e-4)
    else:
        diff = np.abs(warped2.numpy().astype(np.int32) - warped1.numpy().astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
    # and the warp against JAX's per-tile warp of the same flow
    want = np.asarray(jwarper._warp_tiled_jit(jnp.asarray(src), jnp.asarray(flow1.numpy()), _grids()[0], dtype, None))
    if dtype == "float32":
        np.testing.assert_allclose(warped1.numpy(), want, atol=1e-4)
    else:
        _lsb_apart(warped1.numpy(), want)


def test_tile_batch_variable(pair, monkeypatch):
    """``MICROALIGNER_TPU_FLOW_TILE_BATCH=3`` chunks the 9 windows in 3s and
    gives the default batch's flow (JAX's ``test_batch_knob_equality``)."""
    _route(monkeypatch, "0")
    ref, mov = (torch.from_numpy(a) for a in pair)
    tg = _grids()[1]
    calls = []
    core = tfc._farneback_core_parts

    def counted(movs, refs, *args):
        calls.append(movs.shape[0])
        return core(movs, refs, *args)

    monkeypatch.setattr(tfc, "_farneback_core_parts", counted)
    f_def = tfc.calc_flow_tiled(ref, mov, tg, WIN, ITERS).numpy()
    monkeypatch.setenv("MICROALIGNER_TPU_FLOW_TILE_BATCH", "3")
    f_b3 = tfc.calc_flow_tiled(ref, mov, tg, WIN, ITERS).numpy()
    assert calls == [8, 1, 3, 3, 3]
    np.testing.assert_allclose(f_b3, f_def, atol=1e-5)


def _u16_plane(seed, h=H, w=W):
    rng = np.random.default_rng(seed)
    plane = cv.GaussianBlur(rng.random((h, w), dtype=np.float32), (0, 0), 4.0)
    return cv.normalize(plane, None, 0, 60000, cv.NORM_MINMAX).astype(np.uint16)


def _smooth_flow(h=H, w=W, amp=3.0):
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    return np.stack([amp * np.sin(ys / 30), 0.7 * amp * np.cos(xs / 25)], axis=-1).astype(np.float32)


def _lsb_apart(got, want, share=1e-2):
    """At most 1 LSB apart on under ``share`` of the pixels: the JAX gather
    adds the flow to absolute float32 coordinates (about 3e-5 px off at
    these widths) and XLA contracts the blend into FMAs, so an output a last
    bit from a .5 tie may round the other way (the bar of
    tests/test_torch_optflow_engine.py::test_apply_flow_plane)."""
    diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert diff.max() <= 1 and (diff > 0).mean() < share, (diff.max(), (diff > 0).mean())


def test_per_tile_warp_matches_jax(monkeypatch):
    """The per-tile warp, the Warper and the per-plane apply under
    ``FLOW_DENSE=0`` against JAX's ``_warp_tiled_jit`` on a u16 plane; the
    three port calls give the same plane bit for bit."""
    plane, flow = _u16_plane(1), _smooth_flow()
    jg, tg = _grids()
    want = np.asarray(jwarper._warp_tiled_jit(jnp.asarray(plane), jnp.asarray(flow), jg, "uint16", None))
    got = twarper._warp_tiled(torch.from_numpy(plane), torch.from_numpy(flow), tg, torch.uint16)
    assert got.dtype == torch.uint16
    _lsb_apart(got.numpy(), want)
    _route(monkeypatch, "0")
    w = port.Warper(device="cpu")
    w.tile_size, w.overlap = TILE, OVERLAP
    w.image, w.flow = plane, flow
    np.testing.assert_array_equal(w.warp(), got.numpy())
    np.testing.assert_array_equal(
        _apply_flow_plane(torch.from_numpy(plane), torch.from_numpy(flow), tg, torch.uint16).numpy(), got.numpy())
    np.testing.assert_array_equal(np.asarray(j_apply(jnp.asarray(plane), jnp.asarray(flow), jg, "uint16")), want)


def test_seam_flow_beyond_overlap_takes_each_route(monkeypatch):
    """A displacement of 30 px across a tile seam with a 20 px overlap: the
    per-tile warp reads zeros where it leaves the tile's halo, the band warp
    reads the real pixels.  The two routes differ in both packages, and the
    port matches the JAX package on each (``_lsb_apart``), through the same
    public calls."""
    h, w, tile, overlap = 200, 240, 120, 20
    plane = _u16_plane(2, h, w)
    flow = np.zeros((h, w, 2), np.float32)
    flow[..., 0] = -30.0  # out(p) = img(p + 30 px in x): crosses the seam at x = 120
    flow[..., 1] = 1.5
    jg, tg = _grids(h, w, tile, overlap)
    outs = {}
    for dense in ("1", "0"):
        _route(monkeypatch, dense)
        want = np.asarray(jwarper.warp_tiled_dtype(jnp.asarray(plane), jnp.asarray(flow), jg, "uint16"))
        got = twarper.warp_tiled_dtype(torch.from_numpy(plane), torch.from_numpy(flow), tg, torch.uint16).numpy()
        _lsb_apart(got, want)
        outs[dense] = got
    differ = outs["0"] != outs["1"]
    # tile 0's interior columns 90..119 pull from 120..149, beyond its window's 140;
    # rows 0 and 1 pull from above the image on both routes
    assert differ[2:, 110:120].all() and not differ[:, :80].any()
    assert (outs["0"][2:, 115:120] == 0).all() and (outs["1"][2:, 115:120] > 0).all()


def test_apply_flow_planes_per_tile_equals_per_plane(monkeypatch):
    """``_apply_flow_planes`` under ``FLOW_DENSE=0`` warps each plane with
    ``_apply_flow_plane``, as the JAX package's default maps it over the
    planes: bit for bit, and to the JAX package's within ``_lsb_apart``."""
    _route(monkeypatch, "0")
    planes = np.stack([_u16_plane(s) for s in (3, 4, 5)])
    flow = _smooth_flow(amp=6.0)
    jg, tg = _grids()
    got = _apply_flow_planes(torch.from_numpy(planes), torch.from_numpy(flow), tg, torch.uint16).numpy()
    for i, plane in enumerate(planes):
        np.testing.assert_array_equal(
            got[i], _apply_flow_plane(torch.from_numpy(plane), torch.from_numpy(flow), tg, torch.uint16).numpy())
    from microaligner_tpu.pipeline.runner import _apply_flow_planes as j_apply_planes

    _lsb_apart(got, np.asarray(j_apply_planes(jnp.asarray(planes), jnp.asarray(flow), jg, "uint16")))


# -- the drivers --------------------------------------------------------------

# the JAX package's variable that picks each of its drivers; the port has one
DRIVERS = {"per-level": "WHOLE_REGISTER", "stepwise": "CARRY_LEVEL"}


def _reg_pair(h=420, w=460):
    rng = _seeded("tests/test_e2e_reference_recon.py::TestE2EVsReferenceRecon::test_full_pyramid_chain")
    base = cv.GaussianBlur(rng.random((h, w), dtype=np.float32), (0, 0), 3.0)
    base = cv.normalize(base, None, 0, 255, cv.NORM_MINMAX, cv.CV_8U)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    mov = cv.remap(base, xs + 1.5 * np.sin(ys / 40), ys + 1.2 * np.cos(xs / 35), cv.INTER_LINEAR)
    return base, mov


def _configure(reg, ref, mov, levels, full_res, bug):
    reg.num_pyr_lvl, reg.num_iterations = levels, 2
    reg.tile_size, reg.overlap = 150, 50
    reg.use_full_res_img, reg.replicate_reject_upscale_bug = full_res, bug
    reg.ref_img, reg.mov_img = ref, mov
    return reg


def _reject_middle(monkeypatch, middle_shape):
    """Make the gate reject the level of ``middle_shape`` in both packages:
    its first score of a level (``mi_after``, the JAX package's and the
    port's order) drops by 10.  The JAX package imports ``mi_tiled_traced``
    while it traces ``_fused_level``; the port's ``gate_scores`` looks it up
    in ``ops/mutual_info.py`` on each call."""
    from microaligner_tpu.ops import mutual_info as jmi

    def rejecting(orig):
        calls = {}

        def gate(a, b, tile_size):
            score = orig(a, b, tile_size)
            key = tuple(a.shape)
            calls[key] = calls.get(key, 0) + 1
            return score - 10.0 if key == middle_shape and calls[key] % 2 == 1 else score

        return gate

    monkeypatch.setattr(jmi, "mi_tiled_traced", rejecting(jmi.mi_tiled_traced))
    monkeypatch.setattr(tmi, "mi_tiled_traced", rejecting(tmi.mi_tiled_traced))
    jax.clear_caches()


CASES = {
    # 3 levels (factors 4, 2, 1), the middle one rejected, its flow upscaled x4
    "rejected-middle-x4": dict(levels=2, full_res=True, bug=True, reject=(210, 230), dense="1"),
    # one level at half size: accept upscales with one pyrUp from the flow, not doubled
    "single-level": dict(levels=1, full_res=False, bug=False, reject=None, dense="1"),
    # 3 levels on the per-tile route: its flow, pre-warp and post-warp against each JAX driver
    "per-tile": dict(levels=2, full_res=True, bug=False, reject=None, dense="0"),
}


@pytest.fixture(scope="module")
def whole_runs():
    """The port's driver on each case, computed once."""
    return {}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("driver", list(DRIVERS))
def test_driver_matches_jax_and_whole(driver, case, monkeypatch, whole_runs):
    """The port's driver against the JAX package's driver ``driver``,
    whose variable is set for the JAX package's run only."""
    params = CASES[case]
    ref, mov = _reg_pair()
    _route(monkeypatch, params["dense"])
    if params["reject"] is not None:
        _reject_middle(monkeypatch, params["reject"])
    args = (ref, mov, params["levels"], params["full_res"], params["bug"])
    if case not in whole_runs:
        whole = _configure(port.OptFlowRegistrator(device="cpu"), *args)
        whole_runs[case] = (whole.register(), whole.last_scores)
    treg_ = _configure(port.OptFlowRegistrator(device="cpu"), *args)
    dev_flow = treg_.register_device()
    assert isinstance(dev_flow, torch.Tensor) and dev_flow.device.type == "cpu"
    tflow = dev_flow.numpy()
    tscores = [(a, b) for _, a, b in treg_.last_scores]
    with monkeypatch.context() as mp:
        mp.setenv(f"MICROALIGNER_TPU_{DRIVERS[driver]}", "0")
        jax.clear_caches()
        buf = io.StringIO()  # the JAX package reports its gate scores only in its log
        with contextlib.redirect_stdout(buf):
            jflow = _configure(JReg(), *args).register()
    jax.clear_caches()
    jscores = [(float(line.split("after:")[1].split("|")[0]), float(line.split("before:")[1]))
               for line in buf.getvalue().splitlines() if "MI score after" in line]
    assert tflow.shape == jflow.shape == (420, 460, 2)
    assert len(tscores) == len(jscores) == params["levels"] + params["full_res"]
    for (ja, jb), (ta, tb) in zip(jscores, tscores):
        assert (ja > jb) == (ta > tb)
        assert abs(ja - ta) <= 5e-5 and abs(jb - tb) <= 5e-5
    if params["reject"] is not None:
        assert [a > b for a, b in tscores] == [True, False, True]
    err = np.abs(tflow - jflow)
    assert err.mean() < 1e-3 and err.max() < 0.05, (err.mean(), err.max())
    wflow, wscores = whole_runs[case]
    assert [a > b for _, a, b in wscores] == [a > b for a, b in tscores]
    np.testing.assert_array_equal(tflow, wflow)


def test_driver_helpers_match_jax():
    """The carry loop's ``pyr_up`` and ``compose_flows_tiled`` against the
    JAX package's ``_upscale_flow_to_full_res`` (a pyrUp of the flow,
    values kept) and ``_merge_list_of_flows`` on the same inputs.  At
    factor 4 the reference's quirk pyrUps the original flow straight to the
    full size, which ``cv.pyrUp`` refuses: the port's ``pyr_up`` raises,
    where the JAX package returns a flow of another shape (212 rows for
    420)."""
    ref, mov = _reg_pair()
    jr = JReg()
    jr.tile_size, jr.overlap, jr.num_iterations = 150, 50, 2
    jr.ref_img, jr.mov_img = ref, mov
    # the JAX drivers call it on their last level, whose factor is 2 (or 1, a no-op)
    small = _smooth_flow(210, 230)
    want = np.asarray(jr._upscale_flow_to_full_res(jnp.asarray(small), 2))
    got = pyr_up(torch.from_numpy(small), (420, 460)).numpy()
    assert got.shape == (420, 460, 2)
    np.testing.assert_allclose(got, want, atol=1e-5)
    with pytest.raises(ValueError, match="dstsize"):
        pyr_up(torch.from_numpy(_smooth_flow(105, 115)), (420, 460))
    f1, f2 = _smooth_flow(420, 460), _smooth_flow(420, 460, amp=1.0)[::-1].copy()
    grid = TileGrid.for_image((420, 460), 150, 50)
    np.testing.assert_allclose(
        twarper.compose_flows_tiled(torch.from_numpy(f1), torch.from_numpy(f2), grid).numpy(),
        np.asarray(jr._merge_list_of_flows([jnp.asarray(f1), jnp.asarray(f2)])), atol=1e-4)


@pytest.mark.parametrize("dense", ["1", "0"])
def test_matches_reference_recon(dense, monkeypatch):
    """tests/test_e2e_reference_recon.py::test_full_pyramid_chain with the
    port's registrator on the CPU, on both ``FLOW_DENSE`` routes."""
    _route(monkeypatch, dense)
    ref, mov = _reg_pair()
    kw = dict(num_pyr_lvl=2, num_iterations=2, tile_size=150, overlap=50)
    r = recon.OptFlowRegistratorRecon()
    ours = port.OptFlowRegistrator(device="cpu")
    for reg in (r, ours):
        for k, v in kw.items():
            setattr(reg, k, v)
        reg.use_full_res_img = True
        reg.ref_img, reg.mov_img = ref, mov
    flow_ref, flow_ours = r.register(), ours.register()
    assert flow_ours.shape == flow_ref.shape
    warp_ref = recon.warp_tiled(mov.astype(np.float32), flow_ref, 150, 50)
    warp_ours = recon.warp_tiled(mov.astype(np.float32), flow_ours, 150, 50)
    mse = float(np.mean(((warp_ref - warp_ours) / 255.0) ** 2))
    assert mse < 1e-3, mse
    d = np.abs(flow_ours - flow_ref)[30:-30, 30:-30]
    assert d.mean() < 0.05, d.mean()
