"""The port's tile mesh, sharded tile map and sharded register step against
the JAX package's on its 8 virtual CPU devices (mirror of
tests/test_parallel.py), the port on CPU meshes of 1, 2 and 8 entries.

Bars and their reasons:
* ``sharded_tile_map`` / ``tile_map``: exact (elementwise functions);
* the step, port against JAX: flow atol 1e-4 and warped atol 1e-2, the JAX
  test's own bars between its 8- and 1-device steps (XLA contracts
  multiply-adds into FMAs where the port rounds each, about 1e-5 px here);
  the port's meshes against each other: bit for bit;
* the histogram: the port's sums to exactly H * W on every mesh, and is
  within 8 boundary-crossing counts of the JAX one-device histogram (a
  1e-5 px flow difference can move a warped pixel across a bin edge).
  The JAX step counts the zero tiles that pad its tile axis: 25 tiles on 8
  devices sum to H * W + 7 * 32^2, which the port must not copy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microaligner_tpu.parallel.mesh import get_tile_mesh as j_get_tile_mesh
from microaligner_tpu.parallel.mesh import shard_tiles_round_up as j_round_up
from microaligner_tpu.parallel.mesh import sharded_tile_map as j_sharded_tile_map
from microaligner_tpu.parallel.step import make_sharded_register_step as j_make_step
from microaligner_tpu.tiles import TileGrid as JGrid
from microaligner_tpu_torch.ops.mutual_info import _hists
from microaligner_tpu_torch.parallel import (
    current_tile_mesh,
    get_tile_mesh,
    mesh_num_devices,
    shard_tiles_round_up,
    sharded_tile_map,
    tile_map,
    use_tile_mesh,
)
from microaligner_tpu_torch.parallel.step import make_sharded_register_step
from microaligner_tpu_torch.tiles import TileGrid
from microaligner_tpu_torch.utils.workers import get_worker_devices, set_number_of_workers

torch.set_num_threads(1)

CPU = torch.device("cpu")
MESHES = [1, 2, 8]


@pytest.fixture
def workers():
    """Set the port's worker cap for a test; restore the default after."""
    yield set_number_of_workers
    set_number_of_workers(0)


@pytest.fixture(scope="module")
def jmesh8():
    assert jax.device_count() >= 8, "conftest should provide 8 CPU devices"
    return j_get_tile_mesh(jax.devices()[:8])


def _mesh(n):
    return get_tile_mesh([CPU] * n)


class TestShardedTileMap:
    @pytest.mark.parametrize("n", MESHES)
    def test_matches_jax(self, jmesh8, rng, n):
        tiles = rng.random((11, 32, 32)).astype(np.float32)  # 11 % 8 != 0
        want = np.asarray(j_sharded_tile_map(lambda t: t * 2.0 + 1.0, jmesh8)(jnp.asarray(tiles)))
        got = sharded_tile_map(lambda t: t * 2.0 + 1.0, _mesh(n))(torch.from_numpy(tiles))
        np.testing.assert_array_equal(got.numpy(), want)

    def test_single_device_degenerates(self, rng):
        tiles = torch.from_numpy(rng.random((3, 16, 16)).astype(np.float32))
        seen = []
        out = sharded_tile_map(lambda t: seen.append(t) or t + 1.0, _mesh(1))(tiles)
        assert len(seen) == 1 and seen[0] is tiles  # one plain call, nothing copied
        torch.testing.assert_close(out, tiles + 1.0)

    @pytest.mark.parametrize("n", [3, 8])
    def test_round_up_matches_jax(self, rng, n):
        tiles = rng.random((11, 4, 5)).astype(np.float32)
        got = shard_tiles_round_up(torch.from_numpy(tiles), n)
        np.testing.assert_array_equal(got.numpy(), np.asarray(j_round_up(jnp.asarray(tiles), n)))

    @pytest.mark.parametrize("n", MESHES)
    @pytest.mark.parametrize("batch", [1, 3, 50])
    def test_tile_map_shards_and_chunks(self, rng, n, batch):
        x = torch.from_numpy(rng.random((17, 4, 5)).astype(np.float32))
        bias = torch.tensor(0.5)
        calls = []

        def fn(t, i, b):
            calls.append(len(t))
            return t * 3.0 + b, i * 2

        a, b = tile_map(fn, (x, torch.arange(17)), batch=batch, mesh=_mesh(n), broadcast=(bias,))
        torch.testing.assert_close(a, x * 3.0 + 0.5, rtol=0, atol=0)
        torch.testing.assert_close(b, torch.arange(17) * 2)
        per = -(-17 // n)  # each shard runs its own bounded loop over per rows
        assert max(calls) == min(batch, per) and sum(calls) == per * n

    @pytest.mark.parametrize("n", MESHES)
    def test_tile_map_unbatched(self, rng, n):
        x = torch.from_numpy(rng.random((5, 6, 7)).astype(np.float32))
        shapes = []

        def per_item(t):
            shapes.append(tuple(t.shape))
            return t.sum(), t.to(torch.uint16)

        s, u = tile_map(per_item, (x,), batch=1, mesh=_mesh(n), unbatched=True)
        assert set(shapes) == {(6, 7)}
        torch.testing.assert_close(s, x.sum((1, 2)))
        assert u.dtype == torch.uint16 and torch.equal(u, x.to(torch.uint16))

    def test_one_device_mesh_is_the_plain_loop(self, rng):
        x = torch.from_numpy(rng.random((6, 4, 4)).astype(np.float32))
        canvas = torch.zeros(3)
        seen = []

        def fn(t, c):
            seen.append((t.data_ptr(), c))
            return t * 2.0

        tile_map(fn, (x,), batch=4, mesh=_mesh(1), broadcast=(canvas,))
        # the chunks are views of the input and the broadcast tensor is the caller's
        assert [p for p, _ in seen] == [x.data_ptr(), x[4:].data_ptr()]
        assert all(c is canvas for _, c in seen)

    def test_mesh_of_another_device_type_raises(self):
        # no fallback: a CUDA mesh never runs CPU inputs (nor forms without a card)
        with pytest.raises(RuntimeError):
            with use_tile_mesh([torch.device("cuda", 0)] * 2):
                tile_map(lambda t: t, (torch.zeros(4, 2),), batch=1, mesh=current_tile_mesh(CPU))


class TestWorkerMesh:
    def test_cap_sizes_the_cpu_mesh(self, workers):
        assert get_worker_devices(CPU) == [CPU]
        workers(3)
        assert get_worker_devices(CPU) == [CPU] * 3
        assert mesh_num_devices(current_tile_mesh(CPU)) == 3
        with pytest.raises(ValueError):
            workers(-1)

    def test_override_wins_and_is_restored(self, workers):
        workers(2)
        with use_tile_mesh([CPU] * 5) as mesh:
            assert current_tile_mesh(CPU) is mesh and mesh.size == 5
            with use_tile_mesh([CPU]):
                assert current_tile_mesh(CPU).size == 1
            assert current_tile_mesh(CPU) is mesh
        assert current_tile_mesh(CPU).size == 2

    def test_cuda_worker_devices_need_a_card(self):
        if torch.cuda.is_available():
            assert get_worker_devices("cuda") == [torch.device("cuda", i)
                                                  for i in range(torch.cuda.device_count())]
        else:
            with pytest.raises(RuntimeError):
                get_worker_devices("cuda")


def _pair(rng, h, w):
    ref = (rng.random((h, w)) * 255).astype(np.float32)
    mov = (rng.random((h, w)) * 255).astype(np.float32)
    return ref, mov


def _port_step(n, grid, ref, mov, **kw):
    out = make_sharded_register_step(_mesh(n), grid, 9, 1, **kw)(torch.from_numpy(ref), torch.from_numpy(mov))
    return [t.numpy() for t in out]


class TestShardedRegisterStep:
    def test_step_matches_jax(self, jmesh8, rng):
        tile = 32
        h, w = tile * 4, tile * 2  # 8 tiles on 8 devices: the JAX histogram is right here
        ref, mov = _pair(rng, h, w)
        wj, fj, hj = (np.asarray(x) for x in j_make_step(jmesh8, JGrid.for_image((h, w), tile, 8), 9, 1)(
            jnp.asarray(ref), jnp.asarray(mov)))
        grid = TileGrid.for_image((h, w), tile, 8)
        outs = {n: _port_step(n, grid, ref, mov) for n in MESHES}
        for n, (wp, fp, hp) in outs.items():
            assert wp.shape == (h, w) and fp.shape == (h, w, 2) and hp.shape == (256, 256)
            np.testing.assert_allclose(fp, fj, atol=1e-4)
            np.testing.assert_allclose(wp, wj, atol=1e-2)
            assert hp.sum() == h * w and np.abs(hp - hj).sum() <= 8
            for a, b in zip(outs[1], outs[n]):
                np.testing.assert_array_equal(b, a)

    def test_histogram_counts_each_pixel_once(self, rng):
        """25 tiles on 8 shards: the JAX step's histogram counts its 7
        padding tiles (bin (0, 0)); the port's counts each pixel once."""
        tile, h, w = 32, 160, 160
        ref, mov = _pair(rng, h, w)
        jgrid = JGrid.for_image((h, w), tile, 8)
        hj8 = np.asarray(j_make_step(j_get_tile_mesh(jax.devices()[:8]), jgrid, 9, 1)(
            jnp.asarray(ref), jnp.asarray(mov))[2])
        hj1 = np.asarray(j_make_step(j_get_tile_mesh(jax.devices()[:1]), jgrid, 9, 1)(
            jnp.asarray(ref), jnp.asarray(mov))[2])
        assert hj1.sum() == h * w
        assert hj8.sum() == h * w + 7 * tile * tile and hj8[0, 0] - hj1[0, 0] == 7 * tile * tile
        grid = TileGrid.for_image((h, w), tile, 8)
        hists = {n: _port_step(n, grid, ref, mov)[2] for n in MESHES}
        for n, hp in hists.items():
            assert hp.sum() == h * w, n
            assert np.abs(hp - hj1).sum() <= 8, n
            np.testing.assert_array_equal(hp, hists[1])

    @pytest.mark.parametrize("n", [1, 3])
    def test_histogram_of_partial_tiles(self, rng, n):
        """Tiles cut by the image's edge: the histogram is exactly the joint
        histogram of the reference and the stitched warp over the image."""
        h, w = 150, 170
        ref, mov = _pair(rng, h, w)
        warped, flow, hist = _port_step(n, TileGrid.for_image((h, w), 32, 8), ref, mov)
        a = torch.from_numpy(ref).clamp(0, 255).to(torch.uint8).view(1, -1)
        b = torch.from_numpy(warped).clamp(0, 255).to(torch.uint8).view(1, -1)
        np.testing.assert_array_equal(hist, _hists(a, b)[0].numpy())
        assert hist.sum() == h * w

    def test_without_histogram(self, rng):
        ref, mov = _pair(rng, 64, 96)
        grid = TileGrid.for_image((64, 96), 32, 8)
        warped, flow = _port_step(2, grid, ref, mov, with_hist=False)
        full = _port_step(2, grid, ref, mov)
        np.testing.assert_array_equal(warped, full[0])
        np.testing.assert_array_equal(flow, full[1])
