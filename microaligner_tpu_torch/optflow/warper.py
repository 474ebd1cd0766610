"""Tiled flow-field warping and composition, and the public ``Warper``.

PyTorch counterpart of ``microaligner_tpu/optflow/warper.py`` on its default
(row-band) path.  A pixel pulls only from within its band's halo-expanded
slab, so a displacement beyond ``overlap`` reads zeros, as in the
reference's per-tile ``cv.remap``.  All sampling goes through K1, except
:func:`warp_planes_tiled`, which pulls N planes by one flow through K5.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from microaligner_tpu_torch.ops.filters import round_to_dtype
from microaligner_tpu_torch.ops.pad import zero_pad
from microaligner_tpu_torch.ops.warp import (
    compose_flows_batched,
    warp_planes_with_flow_parts,
    warp_with_flow_parts_batched,
)
from microaligner_tpu_torch.optflow.flow_calc import band_rows_for, band_slab
from microaligner_tpu_torch.parallel import tile_map
from microaligner_tpu_torch.tiles import TileGrid, pad_canvas, stitch_interiors, tile_origins

__all__ = [
    "Warper",
    "warp_tiled",
    "warp_tiled_dtype",
    "warp_planes_tiled",
    "compose_flows_tiled",
    "TORCH_DTYPES",
    "round_to_numpy_dtype",
]

_COMPOSE_BATCH = 32  # halo windows composed per chunk (bounds the live working set)


def _warp_banded(image: torch.Tensor, flow: torch.Tensor, grid: TileGrid,
                 out_dtype: torch.dtype, band_rows: int) -> torch.Tensor:
    """Full-width row-band warp: each band's slab (zeros outside the image)
    is pulled by the band's flow, zero on the halo; interiors are rounded to
    ``out_dtype`` and kept."""
    o = grid.overlap
    h, w = grid.height, grid.width
    nb = -(-h // band_rows)

    def band(i):
        row0 = int(i) * band_rows
        n_in = min(band_rows, h - row0)
        src = band_slab(image, row0, band_rows, o)
        fx = zero_pad(flow[row0 : row0 + n_in, :, 0], o, band_rows - n_in + o, o, o)
        fy = zero_pad(flow[row0 : row0 + n_in, :, 1], o, band_rows - n_in + o, o, o)
        warped = warp_with_flow_parts_batched(src[None], fx[None], fy[None])
        return round_to_dtype(warped[:, o : o + band_rows, o : o + w], out_dtype)

    out = tile_map(band, (torch.arange(nb),), batch=1)
    return out.reshape(nb * band_rows, w)[:h]


def warp_tiled(image: torch.Tensor, flow: torch.Tensor, grid: TileGrid,
               band_rows: Optional[int] = None) -> torch.Tensor:
    """Warp (H, W) ``image`` by (H, W, 2) ``flow`` band by band; f32 output."""
    return warp_tiled_dtype(image, flow, grid, torch.float32, band_rows)


def warp_tiled_dtype(image: torch.Tensor, flow: torch.Tensor, grid: TileGrid,
                     dtype: torch.dtype, band_rows: Optional[int] = None) -> torch.Tensor:
    """:func:`warp_tiled` rounded half to even and clipped to ``dtype``
    (``cv.remap`` on integer images), inside each band."""
    return _warp_banded(image, flow, grid, dtype, band_rows_for(grid, band_rows))


def warp_planes_tiled(imgs: torch.Tensor, flow: torch.Tensor, grid: TileGrid,
                      dtype: torch.dtype, band_rows: Optional[int] = None) -> torch.Tensor:
    """Warp N (N, H, W) planes by ONE shared (H, W, 2) flow, band by band,
    rounded half to even and clipped to ``dtype`` inside each band.

    The multi-channel/z apply shape (reference __main__.py:288-302), with the
    per-band halo semantics of :func:`warp_tiled_dtype` for every plane: each
    band's slab of the zero canvas (padded to a whole number of bands) is
    pulled by the band's flow, which is zero on the halo.  One K5 launch a
    band serves all N planes.
    """
    o = grid.overlap
    h, w = grid.height, grid.width
    rows = band_rows_for(grid, band_rows)
    out = torch.empty((imgs.shape[0], h, w), dtype=dtype, device=imgs.device)
    for row0 in range(0, h, rows):
        n_in = min(rows, h - row0)
        src = band_slab(imgs, row0, rows, o)
        fx = zero_pad(flow[row0 : row0 + n_in, :, 0], o, rows - n_in + o, o, o)
        fy = zero_pad(flow[row0 : row0 + n_in, :, 1], o, rows - n_in + o, o, o)
        warped = warp_planes_with_flow_parts(src, fx, fy)
        out[:, row0 : row0 + n_in] = round_to_dtype(warped[:, o : o + n_in, o : o + w], dtype)
    return out


def compose_flows_tiled(flow1: torch.Tensor, flow2: torch.Tensor, grid: TileGrid) -> torch.Tensor:
    """Tile-wise flow composition: per halo tile,
    ``merged(p) = f1(p) + f2(p - f1(p))`` with f2 zero outside the tile's
    halo window, the ``max() == 0`` short-circuits of ``merge_two_flows``
    taken on the whole halo windows, and the interiors stitched.

    The windows are cut from zero-padded canvases ``_COMPOSE_BATCH`` at a
    time, so the live working set is one chunk of windows, never all of them
    (441 windows of 1200^2 at 20480^2).
    """
    o = grid.overlap
    th, tw = grid.tile_shape
    c1 = pad_canvas(flow1, grid)
    c2 = pad_canvas(flow2, grid)

    def chunk(origins):
        starts = origins.tolist()
        f1 = torch.stack([c1[r : r + th, c : c + tw] for r, c in starts])
        f2 = torch.stack([c2[r : r + th, c : c + tw] for r, c in starts])
        return compose_flows_batched(f1, f2)[:, o : o + grid.tile_h, o : o + grid.tile_w]

    out = tile_map(chunk, (torch.from_numpy(tile_origins(grid)),), batch=_COMPOSE_BATCH)
    return stitch_interiors(out, grid)


# numpy dtypes the port warps in their own torch dtype; others (uint32,
# float64, ...) are warped in float32 and rounded back on the host
TORCH_DTYPES = {
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.uint16): torch.uint16,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.float32): torch.float32,
}


def torch_dtype_of(img) -> torch.dtype:
    """The torch dtype of a tensor, or of a numpy array's dtype (raises for
    numpy dtypes the port does not warp into)."""
    if isinstance(img, torch.Tensor):
        return img.dtype
    try:
        return TORCH_DTYPES[np.dtype(img.dtype)]
    except KeyError:
        raise TypeError(f"unsupported image dtype {img.dtype}") from None


def round_to_numpy_dtype(arr: np.ndarray, dtype) -> np.ndarray:
    """Round half to even and clip a float array to an integer numpy
    ``dtype`` (``cv.remap`` on integer images); float dtypes are a cast."""
    dtype = np.dtype(dtype)
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        arr = np.clip(np.round(arr), info.min, info.max)
    return arr.astype(dtype)


def _missing(x) -> bool:
    if x is None:
        return True
    return x.numel() == 0 if isinstance(x, torch.Tensor) else np.size(x) == 0


class Warper:
    """Property-style API of the JAX package's ``Warper``.

    >>> w = Warper(device="cuda")
    >>> w.image = img      # (H, W) numpy array or tensor
    >>> w.flow = flow      # (H, W, 2)
    >>> out = w.warp()     # numpy, the image's dtype
    """

    def __init__(self, device="cpu"):
        self.image = np.array([])
        self.flow = np.array([])
        self.tile_size = 1000
        self.overlap = 100
        self.band_rows: Optional[int] = None
        self.device = device

    def warp(self) -> np.ndarray:
        """Warp ``image`` by ``flow``; returns a numpy array of the image's
        dtype.  Integer planes are rounded half to even and clipped on the
        host, so every numpy integer dtype is supported."""
        image = self.image
        if _missing(image):
            raise ValueError("No image provided")
        if isinstance(image, np.ndarray) and np.dtype(image.dtype) not in TORCH_DTYPES:
            self.image = image.astype(np.float32)
            return round_to_numpy_dtype(self.warp_device().cpu().numpy(), image.dtype)
        return self.warp_device().cpu().numpy()

    def warp_device(self) -> torch.Tensor:
        """:meth:`warp` but the result stays on ``device`` as a tensor of the
        image's dtype, rounded and clipped inside the band warp."""
        image = self.image
        flow = self.flow
        if _missing(image):
            raise ValueError("No image provided")
        if _missing(flow):
            raise ValueError("No flow provided")
        dtype = torch_dtype_of(image)
        img_t = torch.as_tensor(image).to(self.device)
        flow_t = torch.as_tensor(flow).to(self.device, torch.float32)
        grid = TileGrid.for_image(tuple(img_t.shape), self.tile_size, self.overlap)
        out = warp_tiled_dtype(img_t, flow_t, grid, dtype, self.band_rows)
        self.image = np.array([])
        self.flow = np.array([])
        return out
