"""The port's tile grid, halo windows, stitching and bounded map against the
JAX package.  Pure data movement: results are exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from microaligner_tpu import tiles as jt
from microaligner_tpu_torch import tiles as tt
from microaligner_tpu_torch.parallel import tile_map

torch.set_num_threads(1)

CASES = [((100, 130), 40, 10), ((64, 64), 32, 8), ((57, 91), 25, 7), ((30, 30), 50, 5)]


@pytest.mark.parametrize("shape,tile,overlap", CASES)
def test_grid_and_origins(shape, tile, overlap):
    jg = jt.TileGrid.for_image(shape, tile, overlap)
    tg = tt.TileGrid.for_image(shape, tile, overlap)
    for attr in ("ny", "nx", "num_tiles", "padded_h", "padded_w", "tile_shape"):
        assert getattr(tg, attr) == getattr(jg, attr)
    np.testing.assert_array_equal(tt.tile_origins(tg), jt.tile_origins(jg))


@pytest.mark.parametrize("shape,tile,overlap", CASES)
@pytest.mark.parametrize("channels", [None, 2])
def test_split_pad_stitch(rng, shape, tile, overlap, channels):
    full = shape if channels is None else shape + (channels,)
    img = rng.random(full).astype(np.float32)
    jg = jt.TileGrid.for_image(shape, tile, overlap)
    tg = tt.TileGrid.for_image(shape, tile, overlap)
    x = torch.from_numpy(img)
    for jfn, tfn in (
        (jt.split_into_tiles, tt.split_into_tiles),
        (jt.pad_canvas, tt.pad_canvas),
        (jt.split_interiors, tt.split_interiors),
    ):
        np.testing.assert_array_equal(tfn(x, tg).numpy(), np.asarray(jfn(jnp.asarray(img), jg)))
    tiles = tt.split_into_tiles(x, tg)
    np.testing.assert_array_equal(tt.stitch_tiles(tiles, tg).numpy(), img)
    np.testing.assert_array_equal(
        tt.stitch_tiles(tiles, tg).numpy(), np.asarray(jt.stitch_tiles(jnp.asarray(tiles.numpy()), jg))
    )
    interiors = tt.split_interiors(x, tg)
    np.testing.assert_array_equal(tt.stitch_interiors(interiors, tg).numpy(), img)


def test_u16_canvas(rng):
    img = rng.integers(0, 65536, size=(33, 47)).astype(np.uint16)
    g = tt.TileGrid.for_image(img.shape, 20, 6)
    got = tt.pad_canvas(torch.from_numpy(img), g)
    assert got.dtype == torch.uint16
    np.testing.assert_array_equal(got.numpy(), np.asarray(jt.pad_canvas(jnp.asarray(img), jt.TileGrid.for_image(img.shape, 20, 6))))


@pytest.mark.parametrize("batch", [1, 3, 8, 50])
def test_tile_map_chunks(rng, batch):
    x = torch.from_numpy(rng.random((17, 4, 5)).astype(np.float32))
    idx = torch.arange(17)
    seen = []

    def fn(t, i):
        seen.append(len(i))
        return t * 3.0, i * 2

    a, b = tile_map(fn, (x, idx), batch=batch)
    torch.testing.assert_close(a, x * 3.0)
    torch.testing.assert_close(b, idx * 2)
    assert max(seen) == min(batch, 17) and sum(seen) == 17
    torch.testing.assert_close(tile_map(lambda t: t.sum((1, 2)), (x,), batch=batch), x.sum((1, 2)))
