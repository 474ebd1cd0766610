"""Tiled flow-field warping and composition, and the public ``Warper``.

PyTorch counterpart of ``microaligner_tpu/optflow/warper.py``.  The one-plane
warp (:func:`warp_tiled_dtype`, and so the ``Warper``, the per-level pre-
and post-warps and the CLI's per-plane apply) takes the route that
``MICROALIGNER_TPU_FLOW_DENSE`` names on each call, as the JAX package's
``_warp_tiled_impl`` does:

* row bands (the default): a pixel pulls only from within its band's
  halo-expanded slab, one K5 launch a band, typed in and out
  (``sample_band_multi``);
* ``0``, per tile: a pixel pulls only from within its tile's halo window,
  ``_TILE_BATCH`` windows a chunk cast to float32 and pulled through K1 by
  the tile's interior flow with a zero halo, rounded inside the chunk.

Either way a displacement beyond ``overlap`` reads zeros, as in the
reference's per-tile ``cv.remap``; the two differ where a displacement
leaves a tile's halo but not its band's slab.  N planes by one flow
(:func:`warp_planes_tiled`) are always banded, as in the JAX package; the
tiled composition samples through K1.  The tile and band axes are sharded
over the tile mesh of the inputs' device (``parallel.current_tile_mesh``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from microaligner_tpu_torch.ops.filters import round_to_dtype
from microaligner_tpu_torch.ops.pad import zero_pad
from microaligner_tpu_torch.ops.warp import (
    compose_flows_batched,
    warp_band,
    warp_band_rows,
    warp_with_flow_parts_batched,
)
from microaligner_tpu_torch.optflow.flow_calc import _interior, band_rows_for, dense_banded, halo_windows
from microaligner_tpu_torch.parallel.tile_runner import current_tile_mesh, mesh_is_local, tile_map
from microaligner_tpu_torch.tiles import (
    TileGrid,
    pad_canvas,
    split_interiors,
    stitch_interiors,
    tile_origins,
)
from microaligner_tpu_torch.utils.device import resolve_device
from microaligner_tpu_torch.utils.logging import span

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
_TILE_BATCH = 32  # halo windows warped per chunk of the per-tile route (the JAX package's)


def warp_tiled(image: torch.Tensor, flow: torch.Tensor, grid: TileGrid,
               band_rows: Optional[int] = None) -> torch.Tensor:
    """Warp (H, W) ``image`` by (H, W, 2) ``flow`` band by band; f32 output."""
    return warp_tiled_dtype(image, flow, grid, torch.float32, band_rows)


def warp_tiled_dtype(image: torch.Tensor, flow: torch.Tensor, grid: TileGrid,
                     dtype: torch.dtype, band_rows: Optional[int] = None) -> torch.Tensor:
    """:func:`warp_tiled` rounded half to even and clipped to ``dtype``
    (``cv.remap`` on integer images) inside each band or chunk of tiles,
    on the route ``MICROALIGNER_TPU_FLOW_DENSE`` names.  Banded: each
    band's slab (zeros outside the image) is pulled by the band's flow,
    zero on the halo, and its interior kept; that is :func:`warp_planes_tiled`
    on one plane, one K5 launch a band where the image's dtype is
    ``dtype``, nothing allocated but the output.  Per tile:
    :func:`_warp_tiled`."""
    if not dense_banded():
        return _warp_tiled(image, flow, grid, dtype)
    return warp_planes_tiled(image[None], flow, grid, dtype, band_rows)[0]


def _warp_tiled(image: torch.Tensor, flow: torch.Tensor, grid: TileGrid,
                dtype: torch.dtype) -> torch.Tensor:
    """The per-tile warp (the JAX package's ``_warp_tiled_jit``): halo
    windows of the image's zero canvas, in its stored dtype,
    ``_TILE_BATCH`` at a time, cast to float32 and pulled through K1 by the
    tile's interior flow with a zero halo (only interior outputs are kept),
    rounded to ``dtype`` inside the chunk and stitched."""
    o = grid.overlap
    canvas = pad_canvas(image, grid)
    flow = flow.to(torch.float32)
    fx_int = split_interiors(flow[..., 0], grid)
    fy_int = split_interiors(flow[..., 1], grid)
    sl = _interior(grid)

    def chunk(origins, fxt, fyt, canvas):
        wins = halo_windows(canvas, origins, grid).to(torch.float32)
        warped = warp_with_flow_parts_batched(wins, zero_pad(fxt, o, o, o, o), zero_pad(fyt, o, o, o, o))
        return round_to_dtype(warped[sl], dtype)

    warped = tile_map(chunk, (torch.from_numpy(tile_origins(grid)), fx_int, fy_int), batch=_TILE_BATCH,
                      mesh=current_tile_mesh(image.device), broadcast=(canvas,))
    return stitch_interiors(warped, grid)


def warp_planes_tiled(imgs: torch.Tensor, flow: torch.Tensor, grid: TileGrid,
                      dtype: torch.dtype, band_rows: Optional[int] = None) -> torch.Tensor:
    """Warp N (N, H, W) planes by ONE shared (H, W, 2) flow, band by band,
    rounded half to even and clipped to ``dtype`` inside each band.

    The multi-channel/z apply shape (reference __main__.py:288-302), with the
    per-band halo semantics of the banded :func:`warp_tiled_dtype` for every
    plane, on either route (the JAX package's ``warp_planes_tiled``): each
    band's slab of the zero canvas (padded to a whole number of bands) is
    pulled by the band's flow, which is zero on the halo.  One K5 launch a
    band (:func:`warp_band`, ``sample_band_multi``) reads the planes in their
    stored dtype and writes the band's rounded rows into the output, so
    nothing but the output is allocated.  Other pairs of stored and output
    dtype go through the kernel's float32 instantiation one band's slab at a
    time, then are rounded: one slab of float32 planes and its result live
    at once.

    Over a tile mesh of several devices the band axis is sharded: each band
    warps its own source rows on its shard's device (``warp_band_rows``)
    and the bands are gathered and stacked.
    """
    flow = flow.to(torch.float32).contiguous()
    imgs = imgs.contiguous()
    rows = band_rows_for(grid, band_rows)
    h, o = grid.height, grid.overlap
    mesh = current_tile_mesh(imgs.device)
    if mesh_is_local(mesh, imgs.device):
        out = torch.empty((imgs.shape[0], h, grid.width), dtype=dtype, device=imgs.device)
        for row0 in range(0, h, rows):
            warp_band(imgs, flow, out, row0, rows, o)
        return out

    def band(i, planes, fl):
        return warp_band_rows(planes, fl, int(i) * rows, rows, o, dtype)

    nb = -(-h // rows)
    bands = tile_map(band, (torch.arange(nb),), batch=1, mesh=mesh, broadcast=(imgs, flow), unbatched=True)
    return bands.transpose(0, 1).reshape(imgs.shape[0], nb * rows, grid.width)[:, :h].contiguous()


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
    c1 = pad_canvas(flow1, grid)
    c2 = pad_canvas(flow2, grid)

    def chunk(origins, c1, c2):
        f1, f2 = halo_windows(c1, origins, grid), halo_windows(c2, origins, grid)
        return compose_flows_batched(f1, f2)[:, o : o + grid.tile_h, o : o + grid.tile_w]

    out = tile_map(chunk, (torch.from_numpy(tile_origins(grid)),), batch=_COMPOSE_BATCH,
                   mesh=current_tile_mesh(flow1.device), broadcast=(c1, c2))
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
    """Round half to even and saturate a float array to an integer numpy
    ``dtype`` (``cv.remap`` on integer images); float dtypes are a cast.
    The 32-bit types round and clip in float64, where their bounds are
    exact (:func:`round_to_dtype`)."""
    dtype = np.dtype(dtype)
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        if dtype.itemsize >= 4:
            arr = np.asarray(arr, np.float64)
        arr = np.clip(np.round(arr), info.min, info.max)
    return arr.astype(dtype)


def _missing(x) -> bool:
    if x is None:
        return True
    return x.numel() == 0 if isinstance(x, torch.Tensor) else np.size(x) == 0


class Warper:
    """Property-style API of the JAX package's ``Warper``.

    >>> w = Warper()       # the first CUDA device; Warper(device="cpu") asks for the CPU
    >>> w.image = img      # (H, W) numpy array or tensor
    >>> w.flow = flow      # (H, W, 2)
    >>> out = w.warp()     # numpy, the image's dtype
    """

    def __init__(self, device=None):
        self.image = np.array([])
        self.flow = np.array([])
        self.tile_size = 1000
        self.overlap = 100
        self.band_rows: Optional[int] = None
        self.device = resolve_device(device)

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
        image's dtype, rounded and clipped inside the band warp (the span
        ``optflow.warp`` under ``MICROALIGNER_TPU_PROFILE``)."""
        image = self.image
        flow = self.flow
        if _missing(image):
            raise ValueError("No image provided")
        if _missing(flow):
            raise ValueError("No flow provided")
        dtype = torch_dtype_of(image)
        with span("optflow.warp", self.device):
            img_t = torch.as_tensor(image).to(self.device)
            flow_t = torch.as_tensor(flow).to(self.device, torch.float32)
            grid = TileGrid.for_image(tuple(img_t.shape), self.tile_size, self.overlap)
            out = warp_tiled_dtype(img_t, flow_t, grid, dtype, self.band_rows)
        self.image = np.array([])
        self.flow = np.array([])
        return out
