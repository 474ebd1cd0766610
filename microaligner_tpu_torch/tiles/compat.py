"""The reference's tiling API (list of tiles plus an info dict).

PyTorch counterpart of ``microaligner_tpu/tiles/compat.py``: drop-in
equivalents of the reference's ``split_image_into_tiles_of_size``,
``stitch_image`` and ``get_tile`` (shared_modules/slicer.py, stitcher.py)
over the dense tile tensors of ``tiles/slicer.py``.  Numpy in, numpy out.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from microaligner_tpu_torch.tiles.slicer import TileGrid, split_into_tiles, stitch_tiles

__all__ = ["split_image_into_tiles_of_size", "stitch_image", "get_tile", "get_slices"]


def get_slices(big_image, hor_f: int, hor_t: int, ver_f: int, ver_t: int, padding: Dict,
               overlap: int = 0) -> Tuple[Tuple[slice, ...], Tuple[slice, ...]]:
    """(canvas_slice, tile_slice) for pasting one tile interior into a
    stitched canvas (reference stitcher.py:25-69).  Quirk-compatible: a
    nonzero ``padding['top']``/``['left']`` shifts the tile slice's start
    without shrinking its stop, as in the reference."""
    h, w = int(big_image.shape[0]), int(big_image.shape[1])
    tp = max(0, padding["top"] - ver_f)
    lp = max(0, padding["left"] - hor_f)
    if tp > 0:
        ver_f = 0
    if lp > 0:
        hor_f = 0
    ver_t = min(ver_t, h)
    hor_t = min(hor_t, w)
    canvas = [slice(ver_f, ver_t), slice(hor_f, hor_t)]
    tile = [slice(tp + overlap, (ver_t - ver_f) + overlap),
            slice(lp + overlap, (hor_t - hor_f) + overlap)]
    if big_image.ndim > 2:
        canvas.append(slice(None))
        tile.append(slice(None))
    return tuple(canvas), tuple(tile)


def get_tile(big_image, hor_f: int, hor_t: int, ver_f: int, ver_t: int, overlap: int = 0):
    """One halo-expanded tile, zero beyond the image (reference
    slicer.py:23-66)."""
    hor_f -= overlap
    hor_t += overlap
    ver_f -= overlap
    ver_t += overlap
    h, w = big_image.shape[:2]
    lp, tp = max(0, -hor_f), max(0, -ver_f)
    rp, bp = max(0, hor_t - w), max(0, ver_t - h)
    tile = big_image[max(ver_f, 0) : min(ver_t, h), max(hor_f, 0) : min(hor_t, w)]
    pad = [(tp, bp), (lp, rp)] + [(0, 0)] * (big_image.ndim - 2)
    if max(pad) > (0, 0):
        tile = np.pad(np.asarray(tile), pad, mode="constant")
    return tile


def split_image_into_tiles_of_size(arr, tile_w: int, tile_h: int,
                                   overlap: int) -> Tuple[List[np.ndarray], Dict]:
    """The reference's signature: (list of tiles, info dict)."""
    grid = TileGrid(int(arr.shape[0]), int(arr.shape[1]), tile_h, tile_w, overlap)
    tiles = split_into_tiles(torch.as_tensor(np.asarray(arr)), grid).numpy()
    info = {
        "tile_shape": [tile_h, tile_w],
        "ntiles": {"x": grid.nx, "y": grid.ny},
        "overlap": overlap,
        "padding": {
            "left": 0,
            "right": grid.padded_w - grid.width,
            "top": 0,
            "bottom": grid.padded_h - grid.height,
        },
    }
    return [tiles[i] for i in range(tiles.shape[0])], info


def stitch_image(img_list: List[np.ndarray], slicer_info: Dict) -> np.ndarray:
    """The reference's signature: paste tile interiors back
    (stitcher.py:72-118)."""
    nx = slicer_info["ntiles"]["x"]
    ny = slicer_info["ntiles"]["y"]
    tile_h, tile_w = slicer_info["tile_shape"]
    pad = slicer_info["padding"]
    height = ny * tile_h - pad["top"] - pad["bottom"]
    width = nx * tile_w - pad["left"] - pad["right"]
    grid = TileGrid(height, width, tile_h, tile_w, slicer_info["overlap"])
    return stitch_tiles(torch.as_tensor(np.stack(img_list)), grid).numpy()
