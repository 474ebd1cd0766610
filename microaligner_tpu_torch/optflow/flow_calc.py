"""Tiled Farneback flow as full-width row bands.

PyTorch counterpart of ``microaligner_tpu/optflow/flow_calc.py`` on its
default path (``MICROALIGNER_TPU_FLOW_DENSE=1``): below two tiles the flow is
computed on the whole image; otherwise the image is cut into full-width row
bands of ``band_rows`` interior rows, each with ``overlap`` rows and columns
of halo (zeros outside the image), Farneback runs per band, and the band
interiors are stitched.  The band decomposition is the JAX package's, so the
flow near band seams agrees with it.

The per-tile strict-parity path (``MICROALIGNER_TPU_FLOW_DENSE=0``) is not
ported.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from microaligner_tpu_torch.ops.warp import warp_band
from microaligner_tpu_torch.optflow.farneback import _farneback_core_parts, farneback
from microaligner_tpu_torch.parallel import tile_map
from microaligner_tpu_torch.tiles import TileGrid
from microaligner_tpu_torch.utils.device import resolve_device

__all__ = [
    "TileFlowCalc",
    "band_rows_for",
    "band_slab",
    "calc_flow_dense_banded",
    "calc_flow_and_warp_dense_banded",
]

_BAND_PIXELS = 22e6  # band working-set budget of the JAX package (see band_rows_for)


def band_rows_for(grid: TileGrid, band_rows: Optional[int] = None) -> int:
    """Interior rows per band: ``band_rows`` when given (at least 8, like the
    JAX package's ``MICROALIGNER_TPU_FLOW_BAND_ROWS``), else the JAX
    package's ``_band_rows``: about 22 Mpix of band, a multiple of 8, at least
    512, the whole image when it fits."""
    if band_rows is not None:
        return max(8, int(band_rows))
    w = grid.width + 2 * grid.overlap
    rows = int(_BAND_PIXELS // max(w, 1)) // 8 * 8
    return max(512, min(rows, grid.height))


def band_slab(img: torch.Tensor, row0: int, rows: int, o: int) -> torch.Tensor:
    """Rows ``[row0 - o, row0 + rows + o)`` of (..., H, W) ``img`` with ``o``
    columns on each side, as float32, zeros outside the image."""
    h, w = img.shape[-2:]
    top, bot = row0 - o, row0 + rows + o
    a, b = max(top, 0), min(bot, h)
    out = torch.zeros(img.shape[:-2] + (rows + 2 * o, w + 2 * o), dtype=torch.float32,
                      device=img.device)
    if b > a:
        out[..., a - top : b - top, o : o + w] = img[..., a:b, :]
    return out


def _dense_banded_core(ref_img, mov_img, warp_src, grid: TileGrid, win_size: int,
                       num_iter: int, band_rows: int, out_dtype=None):
    """Per band: Farneback on the halo'd slab pair, interiors kept; with
    ``warp_src``, ``warp_src`` is also pulled by the band's flow (its halo
    is not read: only interiors are kept), rounded to ``out_dtype`` and
    written into the band's rows, one K5 launch a band (``warp_band``, the
    band's flow in its slab coordinates).  Returns (fx, fy[, warped]), each
    (H, W)."""
    h, w, o = grid.height, grid.width, grid.overlap
    nb = -(-h // band_rows)
    warped = None
    if warp_src is not None:
        warp_src = warp_src.contiguous()
        warped = torch.empty((h, w), dtype=out_dtype, device=warp_src.device)

    def band(i):
        row0 = int(i) * band_rows
        br = band_slab(ref_img, row0, band_rows, o)
        bm = band_slab(mov_img, row0, band_rows, o)
        fx, fy = _farneback_core_parts(bm[None], br[None], win_size, num_iter, 1, 1.7)
        if warp_src is not None:
            warp_band(warp_src[None], (fx[0], fy[0]), warped[None], row0, band_rows, o)
        sl = (slice(None), slice(o, o + band_rows), slice(o, o + w))
        return fx[sl], fy[sl]

    outs = tile_map(band, (torch.arange(nb),), batch=1)
    flow = tuple(x.reshape(nb * band_rows, w)[:h] for x in outs)
    return flow if warped is None else flow + (warped,)


def calc_flow_dense_banded(ref_img, mov_img, grid: TileGrid, win_size: int, num_iter: int,
                           band_rows: Optional[int] = None) -> torch.Tensor:
    """Full-width row-band Farneback: (H, W) pair -> (H, W, 2) flow."""
    fx, fy = _dense_banded_core(ref_img, mov_img, None, grid, win_size, num_iter,
                                band_rows_for(grid, band_rows))
    return torch.stack([fx, fy], dim=-1)


def calc_flow_and_warp_dense_banded(ref_img, mov_img, warp_src, grid: TileGrid,
                                    win_size: int, num_iter: int, out_dtype: torch.dtype,
                                    band_rows: Optional[int] = None):
    """:func:`calc_flow_dense_banded` fused with the post-flow warp of
    ``warp_src``: returns ((H, W, 2) flow, (H, W) warped in ``out_dtype``)."""
    fx, fy, warped = _dense_banded_core(ref_img, mov_img, warp_src, grid, win_size, num_iter,
                                        band_rows_for(grid, band_rows), out_dtype)
    return torch.stack([fx, fy], dim=-1), warped


class TileFlowCalc:
    """Property-style API of the JAX package's ``TileFlowCalc``; ``device``
    is where the flow is computed, the first CUDA device unless another is
    named."""

    def __init__(self, device=None):
        self.ref_img = np.array([])
        self.mov_img = np.array([])
        self.num_iter = 1
        self.win_size = 51
        self.tile_size = 1000
        self.overlap = 100
        self.band_rows: Optional[int] = None
        self.device = resolve_device(device)

    def calc_flow(self) -> np.ndarray:
        ref = torch.as_tensor(self.ref_img).to(self.device)
        mov = torch.as_tensor(self.mov_img).to(self.device)
        if max(ref.shape) / self.tile_size < 2:
            flow = farneback(mov, ref, win_size=self.win_size, num_iter=self.num_iter)
        else:
            grid = TileGrid.for_image(ref.shape, self.tile_size, self.overlap)
            flow = calc_flow_dense_banded(ref, mov, grid, self.win_size, self.num_iter,
                                          self.band_rows)
        self.ref_img = np.array([])
        self.mov_img = np.array([])
        return flow.cpu().numpy()
