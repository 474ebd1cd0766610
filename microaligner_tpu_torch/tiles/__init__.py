"""Tile grid, halo windows and stitching (counterpart of ``microaligner_tpu.tiles``)."""

from microaligner_tpu_torch.tiles.slicer import (
    TileGrid,
    pad_canvas,
    split_interiors,
    split_into_tiles,
    stitch_interiors,
    stitch_tiles,
    tile_origins,
)

__all__ = [
    "TileGrid",
    "split_into_tiles",
    "stitch_tiles",
    "pad_canvas",
    "tile_origins",
    "split_interiors",
    "stitch_interiors",
]
