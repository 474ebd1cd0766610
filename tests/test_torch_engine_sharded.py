"""The port's engines over a tile mesh: CPU meshes of 1, 2 and 8 entries
against each other, and against the JAX package's engines on its 8 virtual
CPU devices (mirror of tests/test_engine_sharded.py), on the same numpy
inputs.

Every banded case cuts the image into several bands (``band_rows`` 64 on
260 rows: 5 bands, padded to 6 on 2 shards and 8 on 8), so the shards'
padding, gather and in-place-write paths all run.

Bars and their reasons:
* the port's meshes against each other: the JAX test's own bars (flows
  1e-5, warped 1e-5 and integer warps 1 LSB, feature coords 1e-5 and
  descriptors 1e-4, matrices 1e-3); measured bit for bit, since a shard runs
  the same batched functions on the same rows;
* the port against JAX: the bars of the port's unsharded parity tests,
  because XLA contracts multiply-adds into FMAs where the port rounds each
  (tests/test_torch_optflow_engine.py, test_torch_routes_optflow.py,
  test_torch_features.py, test_torch_affine_warp.py): flow mean < 1e-4 px
  and max < 1e-2 px; registrator flow mean < 1e-3 px and max < 0.05 px;
  integer warps within 1 LSB on < 1% of pixels and float32 warps within
  1e-4 of a 0-255 image; the composition within 1e-4 x its magnitude;
  feature coords, validity and responses exact and descriptors rtol 1e-4,
  atol 1e-5; affine warps within 0.05.
"""

import contextlib
import os

import cv2 as cv
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microaligner_tpu.utils.workers import set_number_of_workers as j_set_workers
from microaligner_tpu_torch.parallel import tile_runner, use_tile_mesh
from microaligner_tpu_torch.parallel.mesh import override_mesh
from microaligner_tpu_torch.tiles import TileGrid
from microaligner_tpu_torch.utils.workers import set_number_of_workers

torch.set_num_threads(1)

CPU = torch.device("cpu")
MESHES = (1, 2, 8)
BAND_ROWS = 64


def _textured(rng, h, w, sigma=2.5):
    img = cv.GaussianBlur(rng.random((h, w), dtype=np.float32), (0, 0), sigma)
    return cv.normalize(img, None, 0, 255, cv.NORM_MINMAX, cv.CV_8U)


def _flow_pair(rng, h=260, w=300):
    ref = _textured(rng, h, w)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    mov = cv.remap(ref, xs + 1.2, ys + 0.8, cv.INTER_LINEAR)
    return ref, mov


def _smooth_flow(h, w):
    ys, xs = np.mgrid[0:h, 0:w]
    return np.stack([2.0 * np.sin(ys / 40.0), 1.5 * np.cos(xs / 35.0)], axis=-1).astype(np.float32)


@contextlib.contextmanager
def _env(**variables):
    """Set the JAX package's route variables for both packages; JAX reads
    some while it traces, so its caches are cleared on both sides."""
    saved = {k: os.environ.get(k) for k in variables}
    os.environ.update({k: str(v) for k, v in variables.items()})
    jax.clear_caches()
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        jax.clear_caches()


def _on_meshes(fn):
    """``fn()`` with the port's tile mesh set to 1, 2 and 8 CPU entries;
    every mesh is checked to have been used."""
    outs = {}
    for n in MESHES:
        with use_tile_mesh([CPU] * n) as mesh:
            assert tile_runner.current_tile_mesh(CPU) is mesh
            outs[n] = fn()
    return outs


def _jax8(fn):
    """``fn()`` with the JAX package's worker mesh at its 8 devices (the
    conftest's default of 1 comes back after the test)."""
    j_set_workers(8)
    try:
        return fn()
    finally:
        j_set_workers(1)


def _flat(x) -> list:
    if isinstance(x, (tuple, list)):
        return [a for t in x for a in _flat(t)]
    return [x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)]


def _same_on_every_mesh(outs, atol=0.0, lsb=False):
    for n in MESHES[1:]:
        for a, b in zip(_flat(outs[1]), _flat(outs[n])):
            assert a.shape == b.shape and a.dtype == b.dtype, n
            if lsb:
                assert np.abs(a.astype(np.int64) - b.astype(np.int64)).max() <= 1, n
            else:
                np.testing.assert_allclose(b, a, atol=atol, rtol=0, err_msg=f"mesh {n}")


def _flow_bar(got, want):
    err = np.abs(got - want)
    assert err.mean() < 1e-4 and err.max() < 1e-2, (err.mean(), err.max())


def _lsb_bar(got, want):
    diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-2, (diff.max(), (diff > 0).mean())


@pytest.fixture(autouse=True)
def _port_workers():
    """The port's worker cap and mesh override are its own: restore both."""
    yield
    set_number_of_workers(0)
    assert override_mesh() is None


@pytest.mark.parametrize("route", ["banded", "per_tile"])
def test_calc_flow_tiled(rng, route):
    from microaligner_tpu.optflow.flow_calc import calc_flow_tiled as j_calc
    from microaligner_tpu.tiles import TileGrid as JGrid
    from microaligner_tpu_torch.optflow.flow_calc import calc_flow_tiled

    ref, mov = _flow_pair(rng)
    grid = TileGrid.for_image(ref.shape, 120, 40)
    variables = ({"MICROALIGNER_TPU_FLOW_BAND_ROWS": BAND_ROWS} if route == "banded"
                 else {"MICROALIGNER_TPU_FLOW_DENSE": 0})
    with _env(**variables):
        outs = _on_meshes(lambda: calc_flow_tiled(torch.from_numpy(ref), torch.from_numpy(mov), grid,
                                                  39, 2, BAND_ROWS))
        want = _jax8(lambda: np.asarray(j_calc(jnp.asarray(ref), jnp.asarray(mov),
                                               JGrid.for_image(ref.shape, 120, 40), 39, 2)))
    _same_on_every_mesh(outs, atol=1e-5)
    _flow_bar(outs[8].numpy(), want)


@pytest.mark.parametrize("route", ["banded", "per_tile"])
def test_warp_and_compose_tiled(rng, route):
    from microaligner_tpu.optflow.warper import compose_flows_tiled as j_compose
    from microaligner_tpu.optflow.warper import warp_tiled as j_warp
    from microaligner_tpu.tiles import TileGrid as JGrid
    from microaligner_tpu_torch.optflow.warper import compose_flows_tiled, warp_tiled

    h, w = 260, 300
    img, flow = _textured(rng, h, w), _smooth_flow(h, w)
    grid = TileGrid.for_image((h, w), 120, 40)
    variables = ({"MICROALIGNER_TPU_FLOW_BAND_ROWS": BAND_ROWS} if route == "banded"
                 else {"MICROALIGNER_TPU_FLOW_DENSE": 0})
    ti, tf = torch.from_numpy(img), torch.from_numpy(flow)
    with _env(**variables):
        outs = _on_meshes(lambda: (warp_tiled(ti, tf, grid, BAND_ROWS), compose_flows_tiled(tf, tf * 0.5, grid)))
        jg = JGrid.for_image((h, w), 120, 40)
        want = _jax8(lambda: (np.asarray(j_warp(jnp.asarray(img), jnp.asarray(flow), jg)),
                              np.asarray(j_compose(jnp.asarray(flow), jnp.asarray(flow) * 0.5, jg))))
    _same_on_every_mesh(outs, atol=1e-5)
    np.testing.assert_allclose(outs[8][0].numpy(), want[0], atol=1e-4)
    np.testing.assert_allclose(outs[8][1].numpy(), want[1], atol=1e-4 * 2.0)


def test_warp_planes_tiled(rng):
    from microaligner_tpu.optflow.warper import warp_planes_tiled as j_planes
    from microaligner_tpu.tiles import TileGrid as JGrid
    from microaligner_tpu_torch.optflow.warper import warp_planes_tiled

    h, w = 260, 300
    planes = np.stack([_textured(rng, h, w).astype(np.uint16) * 200 for _ in range(3)])
    flow = _smooth_flow(h, w)
    grid = TileGrid.for_image((h, w), 120, 40)
    outs = _on_meshes(lambda: warp_planes_tiled(torch.from_numpy(planes), torch.from_numpy(flow), grid,
                                                torch.uint16, BAND_ROWS))
    with _env(MICROALIGNER_TPU_FLOW_BAND_ROWS=BAND_ROWS):
        want = _jax8(lambda: np.asarray(j_planes(jnp.asarray(planes), jnp.asarray(flow),
                                                 JGrid.for_image((h, w), 120, 40), "uint16")))
    _same_on_every_mesh(outs, lsb=True)
    assert outs[8].dtype == torch.uint16 and outs[8].is_contiguous()
    _lsb_bar(outs[8].numpy(), want)


@pytest.mark.parametrize("route", ["banded", "per_tile"])
def test_find_features(rng, route):
    from microaligner_tpu.features.tile_features import find_features as j_find
    from microaligner_tpu_torch.features.tile_features import find_features

    img = _textured(rng, 300, 320, sigma=1.5)
    variables = ({"MICROALIGNER_TPU_FEATURE_DENSE_MAX_MPIX": 0} if route == "banded"
                 else {"MICROALIGNER_TPU_FEATURE_DENSE": 0})
    with _env(**variables):
        outs = _on_meshes(lambda: find_features(torch.from_numpy(img), 128))
        want = _jax8(lambda: j_find(img, 128))
    for n in MESHES:
        np.testing.assert_array_equal(outs[n].valid.numpy(), outs[1].valid.numpy())
        np.testing.assert_allclose(outs[n].coords.numpy(), outs[1].coords.numpy(), atol=1e-5, rtol=0)
        np.testing.assert_allclose(outs[n].descriptors.numpy(), outs[1].descriptors.numpy(), atol=1e-4, rtol=0)
    got = outs[8]
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.coords.numpy(), np.asarray(want.coords))
    np.testing.assert_allclose(got.descriptors.numpy(), np.asarray(want.descriptors), rtol=1e-4, atol=1e-5)


def test_affine_warp_bands(rng):
    from microaligner_tpu.ops.affine_tiled import affine_warp_tiled as j_affine
    from microaligner_tpu_torch.ops.affine_tiled import affine_warp_bands, affine_warp_traced

    img = _textured(rng, 260, 300).astype(np.float32)
    inv = np.array([[1.001, 0.0006, 8.25], [-0.0006, 1.001, -15.75]])
    fwd = torch.tensor([[0.999, -0.0006, -8.3], [0.0006, 0.999, 15.7]])
    src = torch.from_numpy(img)
    outs = _on_meshes(lambda: (affine_warp_bands(src, inv, 270, 310, band_rows=48),
                               affine_warp_traced(src, fwd)))
    want = _jax8(lambda: np.asarray(j_affine(jnp.asarray(img), inv, 270, 310)))
    _same_on_every_mesh(outs)
    assert np.abs(outs[8][0].numpy() - want).max() < 0.05


def _registrator(ref, mov):
    from microaligner_tpu_torch.optflow.registrator import OptFlowRegistrator

    reg = OptFlowRegistrator(device="cpu")
    reg.num_pyr_lvl, reg.num_iterations = 1, 2
    reg.tile_size, reg.overlap, reg.band_rows = 120, 40, BAND_ROWS
    reg.use_full_res_img = True
    reg.ref_img, reg.mov_img = ref, mov
    return reg.register()


def test_optflow_registrator(rng):
    from microaligner_tpu.optflow import OptFlowRegistrator as JReg

    ref, mov = _flow_pair(rng)
    outs = _on_meshes(lambda: _registrator(ref, mov))

    def jax_run():
        reg = JReg()
        reg.num_pyr_lvl, reg.num_iterations = 1, 2
        reg.tile_size, reg.overlap = 120, 40
        reg.use_full_res_img = True
        reg.ref_img, reg.mov_img = ref, mov
        return reg.register()

    with _env(MICROALIGNER_TPU_FLOW_BAND_ROWS=BAND_ROWS):
        want = _jax8(jax_run)
    _same_on_every_mesh(outs, atol=1e-4)
    err = np.abs(outs[8] - want)
    assert err.mean() < 1e-3 and err.max() < 0.05, (err.mean(), err.max())


def test_workers_cap_the_registrators_mesh(rng):
    """``set_number_of_workers`` (a config's NumberOfWorkers) sizes the mesh
    the engines shard over."""
    ref, mov = _flow_pair(rng, 200, 230)
    sizes = []
    real = tile_runner.tile_map

    def spy(fn, inputs, batch, mesh=None, **kw):
        sizes.append(tile_runner.mesh_num_devices(mesh))
        return real(fn, inputs, batch, mesh=mesh, **kw)

    flows = {}
    for n in (1, 3):
        set_number_of_workers(n)
        sizes.clear()
        with pytest.MonkeyPatch.context() as mp:
            from microaligner_tpu_torch.optflow import flow_calc, warper

            mp.setattr(flow_calc, "tile_map", spy)
            mp.setattr(warper, "tile_map", spy)
            flows[n] = _registrator(ref, mov)
        assert sizes and set(sizes) == {n}, sizes
    np.testing.assert_array_equal(flows[3], flows[1])


def test_feature_registrator(rng):
    # one tile that covers the image, as the JAX test (a multi-tile knn is
    # slow on one CPU thread; multi-tile sharded detection is
    # test_find_features), on the banded path, so that its one grid row is
    # sharded (and padded) over the mesh
    from microaligner_tpu_torch.features import FeatureRegistrator

    ref = _textured(rng, 300, 320, sigma=1.5)
    t = np.float32([[1, 0, 4.0], [0, 1, -3.0]])
    mov = cv.warpAffine(ref, t, (320, 300))

    def run():
        reg = FeatureRegistrator(device="cpu")
        reg.num_pyr_lvl, reg.num_iterations, reg.tile_size = 1, 1, 320
        reg.use_full_res_img = True
        reg.ref_img, reg.mov_img = ref, mov
        return reg.register()

    outs = {}
    with _env(MICROALIGNER_TPU_FEATURE_DENSE_MAX_MPIX=0):
        for n in (1, 2):
            with use_tile_mesh([CPU] * n):
                outs[n] = run()
    np.testing.assert_allclose(outs[2], outs[1], atol=1e-3)
    # the recovered translation is the ground truth (mov -> ref: -t)
    assert abs(outs[2][0, 2] - (-4.0)) < 0.5
    assert abs(outs[2][1, 2] - 3.0) < 0.5


def test_calc_flow_and_warp_tiled(rng):
    from microaligner_tpu.optflow.flow_calc import calc_flow_and_warp_tiled as j_fused
    from microaligner_tpu.tiles import TileGrid as JGrid
    from microaligner_tpu_torch.optflow.flow_calc import calc_flow_and_warp_tiled

    ref, mov = _flow_pair(rng)
    grid = TileGrid.for_image(ref.shape, 120, 40)
    tr, tm = torch.from_numpy(ref), torch.from_numpy(mov)
    for variables in ({"MICROALIGNER_TPU_FLOW_BAND_ROWS": BAND_ROWS}, {"MICROALIGNER_TPU_FLOW_DENSE": 0}):
        with _env(**variables):
            outs = _on_meshes(lambda: calc_flow_and_warp_tiled(tr, tm, tm, grid, 39, 2, torch.uint8, BAND_ROWS))
            jg = JGrid.for_image(ref.shape, 120, 40)
            want = _jax8(lambda: [np.asarray(x) for x in j_fused(jnp.asarray(ref), jnp.asarray(mov),
                                                                 jnp.asarray(mov), jg, 39, 2, "uint8")])
        _same_on_every_mesh({n: outs[n][0] for n in MESHES}, atol=1e-5)
        _same_on_every_mesh({n: outs[n][1] for n in MESHES}, lsb=True)
        _flow_bar(outs[8][0].numpy(), want[0])
        _lsb_bar(outs[8][1].numpy(), want[1])
