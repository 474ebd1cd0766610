"""Tiled Farneback flow: full-width row bands, or halo tiles.

PyTorch counterpart of ``microaligner_tpu/optflow/flow_calc.py``: below two
tiles the flow is computed on the whole image; otherwise the JAX package's
variable ``MICROALIGNER_TPU_FLOW_DENSE``, read on every call of
:func:`calc_flow_tiled`, :func:`calc_flow_and_warp_tiled` and
``TileFlowCalc.calc_flow``, picks the decomposition:

* unset or anything but ``0`` (the default): full-width row bands of
  ``band_rows`` interior rows, each with ``overlap`` rows and columns of
  halo (zeros outside the image), Farneback a band, the band interiors
  stitched;
* ``0``: the strict-parity per-tile route, the reference's exact tile
  decomposition.  Halo windows of ``tile + 2 overlap`` are sliced from the
  zero canvas (``tiles.pad_canvas``) ``MICROALIGNER_TPU_FLOW_TILE_BATCH``
  at a time (default 8), Farneback runs on the chunk (one K2 launch,
  ``num_iter`` K3 and ``num_iter - 1`` K4 launches), and the tile interiors
  are stitched.  The fused post-warp pulls each window of the warp source
  through K1 by the window's flow with a zero halo.

Both decompositions are the JAX package's, so the flow near band and tile
seams agrees with it on either route.  On either route the band or tile
axis is sharded over the tile mesh of the inputs' device
(``parallel.current_tile_mesh``); the images and canvases are passed to
``tile_map`` as ``broadcast`` tensors, so a shard on another device reads its
own copy.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from microaligner_tpu_torch.ops.filters import round_to_dtype
from microaligner_tpu_torch.ops.warp import warp_band, warp_band_rows, warp_with_flow_parts_batched
from microaligner_tpu_torch.optflow.farneback import _farneback_core_parts, farneback
from microaligner_tpu_torch.parallel.tile_runner import current_tile_mesh, mesh_is_local, tile_map
from microaligner_tpu_torch.tiles import TileGrid, pad_canvas, stitch_interiors, tile_origins
from microaligner_tpu_torch.utils.device import resolve_device

__all__ = [
    "TileFlowCalc",
    "band_rows_for",
    "band_slab",
    "dense_banded",
    "calc_flow_tiled",
    "calc_flow_and_warp_tiled",
    "calc_flow_dense_banded",
    "calc_flow_and_warp_dense_banded",
]

_BAND_PIXELS = 22e6  # band working-set budget of the JAX package (see band_rows_for)
_TILE_BATCH = 8  # halo windows a chunk of the per-tile route (the JAX package's _TILE_BATCH)


def dense_banded() -> bool:
    """The JAX package's ``MICROALIGNER_TPU_FLOW_DENSE`` test: row bands
    unless it is ``0``."""
    return os.environ.get("MICROALIGNER_TPU_FLOW_DENSE", "1") != "0"


def tile_batch() -> int:
    """Halo windows a chunk of the per-tile route:
    ``MICROALIGNER_TPU_FLOW_TILE_BATCH``, default 8, as the JAX package."""
    return int(os.environ.get("MICROALIGNER_TPU_FLOW_TILE_BATCH", _TILE_BATCH))


def halo_windows(canvas: torch.Tensor, origins: torch.Tensor, grid: TileGrid) -> torch.Tensor:
    """(B, tile + 2 overlap, ...) halo windows of a :func:`pad_canvas` at the
    (B, 2) ``origins``, in the canvas's dtype."""
    th, tw = grid.tile_shape
    return torch.stack([canvas[r : r + th, c : c + tw] for r, c in origins.tolist()])


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
    (H, W).

    The band axis is sharded over the tile mesh.  On the inputs' one
    device each band's warp is written straight into one ``warped``; over
    several devices a band warps its own source rows into an output on its
    shard's device and returns it (``warp_band_rows``)."""
    h, w, o = grid.height, grid.width, grid.overlap
    nb = -(-h // band_rows)
    mesh = current_tile_mesh(ref_img.device)
    images = (ref_img, mov_img)
    warped = None
    if warp_src is not None:
        images += (warp_src.contiguous(),)
        if mesh_is_local(mesh, ref_img.device):
            warped = torch.empty((h, w), dtype=out_dtype, device=warp_src.device)

    def band(i, ref, mov, *src):
        row0 = int(i) * band_rows
        br = band_slab(ref, row0, band_rows, o)
        bm = band_slab(mov, row0, band_rows, o)
        fx, fy = _farneback_core_parts(bm[None], br[None], win_size, num_iter, 1, 1.7)
        sl = (slice(None), slice(o, o + band_rows), slice(o, o + w))
        if not src:
            return fx[sl], fy[sl]
        if warped is not None:
            warp_band(src[0][None], (fx[0], fy[0]), warped[None], row0, band_rows, o)
            return fx[sl], fy[sl]
        return fx[sl], fy[sl], warp_band_rows(src[0][None], (fx[0], fy[0]), row0, band_rows, o, out_dtype)

    outs = tile_map(band, (torch.arange(nb),), batch=1, mesh=mesh, broadcast=images)
    flow = tuple(x.reshape(nb * band_rows, w)[:h] for x in outs[:2])
    if warp_src is None:
        return flow
    if warped is None:
        warped = outs[2].reshape(nb * band_rows, w)[:h]
    return flow + (warped,)


def _interior(grid: TileGrid) -> tuple:
    o = grid.overlap
    return (slice(None), slice(o, o + grid.tile_h), slice(o, o + grid.tile_w))


def _calc_flow_tiled(ref_img, mov_img, grid: TileGrid, win_size: int, num_iter: int,
                     batch: int) -> torch.Tensor:
    """The per-tile route: ``batch`` halo windows a chunk sliced from the
    zero canvases in the input dtype, Farneback on the chunk as float32,
    the interiors stitched into the (H, W, 2) flow."""
    canvases = (pad_canvas(ref_img, grid), pad_canvas(mov_img, grid))
    sl = _interior(grid)

    def chunk(origins, canvas_r, canvas_m):
        wr = halo_windows(canvas_r, origins, grid).to(torch.float32)
        wm = halo_windows(canvas_m, origins, grid).to(torch.float32)
        fx, fy = _farneback_core_parts(wm, wr, win_size, num_iter, 1, 1.7)
        return fx[sl], fy[sl]

    fx, fy = tile_map(chunk, (torch.from_numpy(tile_origins(grid)),), batch=batch,
                      mesh=current_tile_mesh(ref_img.device), broadcast=canvases)
    return torch.stack([stitch_interiors(fx, grid), stitch_interiors(fy, grid)], dim=-1)


def _calc_flow_and_warp_tiled(ref_img, mov_img, warp_src, grid: TileGrid, win_size: int,
                              num_iter: int, out_dtype: torch.dtype, batch: int):
    """:func:`_calc_flow_tiled` fused with the post-flow warp: each chunk's
    windows of ``warp_src`` are pulled through K1 by the windows' flow with
    a zero halo (only interiors are kept, as in the per-tile warp) and
    rounded to ``out_dtype`` inside the chunk."""
    canvases = tuple(pad_canvas(img, grid) for img in (ref_img, mov_img, warp_src))
    o = grid.overlap
    interior = torch.zeros(grid.tile_shape, dtype=torch.float32, device=ref_img.device)
    interior[o : o + grid.tile_h, o : o + grid.tile_w] = 1.0
    sl = _interior(grid)

    def chunk(origins, canvas_r, canvas_m, canvas_w, inside):
        wr, wm, ws = (halo_windows(c, origins, grid).to(torch.float32) for c in (canvas_r, canvas_m, canvas_w))
        fx, fy = _farneback_core_parts(wm, wr, win_size, num_iter, 1, 1.7)
        warped = warp_with_flow_parts_batched(ws, fx * inside, fy * inside)
        return fx[sl], fy[sl], round_to_dtype(warped[sl], out_dtype)

    fx, fy, warped = tile_map(chunk, (torch.from_numpy(tile_origins(grid)),), batch=batch,
                              mesh=current_tile_mesh(ref_img.device), broadcast=canvases + (interior,))
    flow = torch.stack([stitch_interiors(fx, grid), stitch_interiors(fy, grid)], dim=-1)
    return flow, stitch_interiors(warped, grid)


def calc_flow_tiled(ref_img, mov_img, grid: TileGrid, win_size: int, num_iter: int,
                    band_rows: Optional[int] = None) -> torch.Tensor:
    """(H, W) pair -> (H, W, 2) flow, banded or per tile as
    ``MICROALIGNER_TPU_FLOW_DENSE`` says (``band_rows`` is the bands')."""
    if dense_banded():
        return calc_flow_dense_banded(ref_img, mov_img, grid, win_size, num_iter, band_rows)
    return _calc_flow_tiled(ref_img, mov_img, grid, win_size, num_iter, tile_batch())


def calc_flow_and_warp_tiled(ref_img, mov_img, warp_src, grid: TileGrid, win_size: int,
                             num_iter: int, out_dtype: torch.dtype,
                             band_rows: Optional[int] = None):
    """:func:`calc_flow_tiled` fused with the post-flow warp of
    ``warp_src``: ((H, W, 2) flow, (H, W) warped in ``out_dtype``), exactly
    the flow followed by ``warper.warp_tiled_dtype`` on the same route."""
    if dense_banded():
        return calc_flow_and_warp_dense_banded(ref_img, mov_img, warp_src, grid, win_size,
                                               num_iter, out_dtype, band_rows)
    return _calc_flow_and_warp_tiled(ref_img, mov_img, warp_src, grid, win_size, num_iter,
                                     out_dtype, tile_batch())


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
            flow = calc_flow_tiled(ref, mov, grid, self.win_size, self.num_iter, self.band_rows)
        self.ref_img = np.array([])
        self.mov_img = np.array([])
        return flow.cpu().numpy()
