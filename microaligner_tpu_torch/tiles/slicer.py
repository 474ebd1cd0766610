"""Split an image into a fixed grid of halo-expanded tiles and stitch back.

PyTorch counterpart of ``microaligner_tpu/tiles/slicer.py``:

* the grid is ``ceil(H/tile_h) x ceil(W/tile_w)``;
* every tile is the ``(tile_h, tile_w)`` interior expanded by ``overlap``
  pixels on all four sides;
* samples beyond the original image bounds are zero, including the implicit
  bottom/right grid padding;
* stitching pastes each tile's interior back and crops to the original size.

Tiles are one dense tensor ``(ny*nx, tile_h + 2*overlap, tile_w + 2*overlap[, C])``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from microaligner_tpu_torch.ops.pad import zero_pad

__all__ = [
    "TileGrid",
    "split_into_tiles",
    "stitch_tiles",
    "pad_canvas",
    "tile_origins",
    "split_interiors",
    "stitch_interiors",
]


@dataclasses.dataclass(frozen=True)
class TileGrid:
    """Static tiling descriptor."""

    height: int
    width: int
    tile_h: int
    tile_w: int
    overlap: int

    @property
    def ny(self) -> int:
        return -(-self.height // self.tile_h)

    @property
    def nx(self) -> int:
        return -(-self.width // self.tile_w)

    @property
    def num_tiles(self) -> int:
        return self.ny * self.nx

    @property
    def padded_h(self) -> int:
        return self.ny * self.tile_h

    @property
    def padded_w(self) -> int:
        return self.nx * self.tile_w

    @property
    def tile_shape(self) -> tuple[int, int]:
        t = 2 * self.overlap
        return (self.tile_h + t, self.tile_w + t)

    @classmethod
    def for_image(cls, shape, tile_size: int, overlap: int) -> "TileGrid":
        return cls(int(shape[0]), int(shape[1]), tile_size, tile_size, overlap)


def _channels_first(img: torch.Tensor):
    """(H, W) or (H, W, C) -> (C, H, W) view and whether to squeeze back."""
    if img.dim() == 2:
        return img.unsqueeze(0), True
    return img.permute(2, 0, 1), False


def _channels_last(x: torch.Tensor, squeeze: bool) -> torch.Tensor:
    """Inverse of :func:`_channels_first` on a (..., C, H, W) result."""
    if squeeze:
        return x.squeeze(-3)
    return x.movedim(-3, -1)


def pad_canvas(img: torch.Tensor, grid: TileGrid) -> torch.Tensor:
    """The zero-padded canvas every halo window slices from: the image offset
    by ``overlap`` with zeros outside.  Window (i, j) is
    ``canvas[i*tile_h : i*tile_h + win_h, j*tile_w : j*tile_w + win_w]``."""
    o = grid.overlap
    x, squeeze = _channels_first(img)
    canvas = zero_pad(x, o, grid.padded_h - grid.height + o, o, grid.padded_w - grid.width + o)
    return _channels_last(canvas, squeeze)


def tile_origins(grid: TileGrid) -> np.ndarray:
    """(N, 2) int window origins (row, col) in :func:`pad_canvas` coordinates,
    row-major over the grid."""
    jj, ii = np.meshgrid(np.arange(grid.nx), np.arange(grid.ny))
    return np.stack([ii.ravel() * grid.tile_h, jj.ravel() * grid.tile_w], axis=-1).astype(np.int64)


def split_into_tiles(img: torch.Tensor, grid: TileGrid) -> torch.Tensor:
    """``(H, W[, C]) -> (ny*nx, T_h, T_w[, C])`` with zero halos outside the image."""
    canvas = pad_canvas(img, grid)
    th, tw = grid.tile_shape
    return torch.stack([canvas[r : r + th, c : c + tw] for r, c in tile_origins(grid).tolist()])


def split_interiors(arr: torch.Tensor, grid: TileGrid) -> torch.Tensor:
    """``(H, W[, C]) -> (N, tile_h, tile_w[, C])`` interior tiles (no halo)."""
    x, squeeze = _channels_first(arr)
    c = x.shape[0]
    x = zero_pad(x, 0, grid.padded_h - grid.height, 0, grid.padded_w - grid.width)
    x = x.reshape(c, grid.ny, grid.tile_h, grid.nx, grid.tile_w)
    x = x.permute(1, 3, 0, 2, 4).reshape(grid.num_tiles, c, grid.tile_h, grid.tile_w)
    return _channels_last(x, squeeze)


def stitch_interiors(tiles: torch.Tensor, grid: TileGrid) -> torch.Tensor:
    """``(N, tile_h, tile_w[, C]) -> (H, W[, C])``, the inverse of
    :func:`split_interiors`."""
    squeeze = tiles.dim() == 3
    t = tiles.unsqueeze(-1) if squeeze else tiles
    c = t.shape[-1]
    t = t.reshape(grid.ny, grid.nx, grid.tile_h, grid.tile_w, c)
    out = t.permute(0, 2, 1, 3, 4).reshape(grid.padded_h, grid.padded_w, c)
    out = out[: grid.height, : grid.width]
    return out[..., 0] if squeeze else out


def stitch_tiles(tiles: torch.Tensor, grid: TileGrid) -> torch.Tensor:
    """``(ny*nx, T_h, T_w[, C]) -> (H, W[, C])``: paste interiors, crop to size."""
    o = grid.overlap
    return stitch_interiors(tiles[:, o : o + grid.tile_h, o : o + grid.tile_w], grid)
