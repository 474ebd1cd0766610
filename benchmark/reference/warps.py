"""Bilinear sampling, band warps, flow composition and affine warps of the
reference.

Frozen copy of the port's plain versions (``ops/kernel_sample.py``'s
``*_plain`` functions, ``ops/warp.py``, ``ops/affine_tiled.py`` and the band
and composition helpers of ``optflow/warper.py`` and
``optflow/flow_calc.py``) on one device, with no kernel and no tile mesh.
Taps outside the image read zero (``cv.remap`` with BORDER_CONSTANT); a
displacement is split into ``floor`` and fraction before it is added to the
pixel position, so the weights stay exact at 20k widths.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.filters import round_mantissa, round_to_dtype
from benchmark.reference.tiles import TileGrid, halo_windows, pad_canvas, stitch_interiors, tile_origins, zero_pad

_IDX_LIMIT = 2**30  # floor(displacement) is clamped to this before indexing
_COMPOSE_BATCH = 32  # halo windows composed a chunk
_BAND_PIXELS = 22e6  # band working-set budget (band_rows_for)
AFFINE_BAND_PIXELS = 1 << 24  # output pixels a band of the affine warp


def bilinear_taps(flat: torch.Tensor, x0: torch.Tensor, y0: torch.Tensor,
                  tx: torch.Tensor, ty: torch.Tensor, h: int, w: int, bits=None) -> torch.Tensor:
    """Blend the four taps of ``flat`` (..., h*w) at integer corners
    (y0, x0) with fractions (tx, ty); taps outside the image read 0.
    ``bits`` (the control's precision) rounds the taps' values and the
    fractions to a significand of that many bits first."""
    lead = flat.shape[:-1]
    if bits is not None:
        flat, tx, ty = round_mantissa(flat, bits), round_mantissa(tx, bits), round_mantissa(ty, bits)

    def tap(yy, xx):
        valid = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        idx = (yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)).reshape(*lead, -1)
        v = torch.gather(flat, -1, idx).reshape(x0.shape)
        return torch.where(valid, v, 0.0)

    ux = 1 - tx
    uy = 1 - ty
    out = tap(y0, x0) * ux * uy
    out = out + tap(y0, x0 + 1) * tx * uy
    out = out + tap(y0 + 1, x0) * ux * ty
    out = out + tap(y0 + 1, x0 + 1) * tx * ty
    return out


def split_displacement(fx: torch.Tensor, fy: torch.Tensor, row0: int = 0):
    """Integer corners (absolute, int64) and fractions of p + (fx, fy); the
    displacement's row 0 is image row ``row0``."""
    h, w = fx.shape[-2:]
    x1 = torch.floor(fx)
    y1 = torch.floor(fy)
    tx = fx - x1
    ty = fy - y1
    gx = torch.arange(w, device=fx.device).view(1, w)
    gy = torch.arange(row0, row0 + h, device=fx.device).view(h, 1)
    x0 = gx + x1.clamp(-_IDX_LIMIT, _IDX_LIMIT).to(torch.int64)
    y0 = gy + y1.clamp(-_IDX_LIMIT, _IDX_LIMIT).to(torch.int64)
    return x0, y0, tx, ty


def sample_displaced(img: torch.Tensor, fx: torch.Tensor, fy: torch.Tensor, row0: int = 0, bits=None) -> torch.Tensor:
    """``out(p) = img(p + (fx, fy)(p))``: (N, H, W) f32 image, (N, oh, ow)
    f32 displacements whose row 0 is image row ``row0``."""
    n, h, w = img.shape
    x0, y0, tx, ty = split_displacement(fx, fy, row0)
    return bilinear_taps(img.reshape(n, h * w), x0, y0, tx, ty, h, w, bits)


def sample_displaced_multi(imgs: torch.Tensor, fx: torch.Tensor, fy: torch.Tensor, bits=None) -> torch.Tensor:
    """(N, H, W) f32 planes pulled by one (H, W) displacement."""
    n, h, w = imgs.shape
    x0, y0, tx, ty = (t.expand(n, h, w) for t in split_displacement(fx, fy))
    return bilinear_taps(imgs.reshape(n, h * w), x0, y0, tx, ty, h, w, bits)


def band_rows_for(grid: TileGrid) -> int:
    """Interior rows a band: about 22 Mpix of band, a multiple of 8, at
    least 512, the whole image when it fits."""
    w = grid.width + 2 * grid.overlap
    rows = int(_BAND_PIXELS // max(w, 1)) // 8 * 8
    return max(512, min(rows, grid.height))


def band_bounds(h: int, row0: int, rows: int, overlap: int) -> tuple[int, int, int]:
    """(interior rows, first and one past the last source row) of a band."""
    return min(rows, h - row0), max(row0 - overlap, 0), min(row0 + rows + overlap, h)


def band_slab(img: torch.Tensor, row0: int, rows: int, o: int) -> torch.Tensor:
    """Rows ``[row0 - o, row0 + rows + o)`` of (..., H, W) ``img`` with ``o``
    columns on each side, as float32, zeros outside the image."""
    h, w = img.shape[-2:]
    top, bot = row0 - o, row0 + rows + o
    a, b = max(top, 0), min(bot, h)
    out = torch.zeros(img.shape[:-2] + (rows + 2 * o, w + 2 * o), dtype=torch.float32, device=img.device)
    if b > a:
        out[..., a - top : b - top, o : o + w] = img[..., a:b, :]
    return out


def sample_band(imgs: torch.Tensor, flow, out: torch.Tensor, row0: int, rows: int, overlap: int, bits=None) -> None:
    """One band of the banded warp of (N, H, W) ``imgs`` by one flow: the
    band's slab of the zero canvas pulled by the band's flow in slab
    coordinates (the (H, W, 2) field's band rows zero-padded to the slab, or
    the slab pair as given), its interior rounded into ``out``."""
    o = overlap
    h, w = imgs.shape[1:]
    n_in = band_bounds(h, row0, rows, o)[0]
    src = band_slab(imgs, row0, rows, o)
    if isinstance(flow, tuple):
        fx, fy = flow
    else:
        fx = zero_pad(flow[row0 : row0 + n_in, :, 0], o, rows - n_in + o, o, o)
        fy = zero_pad(flow[row0 : row0 + n_in, :, 1], o, rows - n_in + o, o, o)
    warped = sample_displaced_multi(src, -fx, -fy, bits)
    out[:, row0 : row0 + n_in] = round_to_dtype(warped[:, o : o + n_in, o : o + w], out.dtype)


def warp_planes_tiled(imgs: torch.Tensor, flow: torch.Tensor, grid: TileGrid, dtype: torch.dtype,
                      bits=None) -> torch.Tensor:
    """Warp (N, H, W) planes by one (H, W, 2) flow band by band, rounded half
    to even and clipped to ``dtype`` inside each band (the port's apply and
    Warper)."""
    flow = flow.to(torch.float32).contiguous()
    rows = band_rows_for(grid)
    h, o = grid.height, grid.overlap
    out = torch.empty((imgs.shape[0], h, grid.width), dtype=dtype, device=imgs.device)
    for row0 in range(0, h, rows):
        sample_band(imgs, flow, out, row0, rows, o, bits)
    return out


def warp_tiled_dtype(image: torch.Tensor, flow: torch.Tensor, grid: TileGrid, dtype: torch.dtype,
                     bits=None) -> torch.Tensor:
    """One (H, W) plane through :func:`warp_planes_tiled`."""
    return warp_planes_tiled(image[None], flow, grid, dtype, bits)[0]


def _compose(flow1: torch.Tensor, flow2: torch.Tensor, dims) -> torch.Tensor:
    fx, fy = (-flow1[..., 0]).contiguous(), (-flow1[..., 1]).contiguous()
    sampled = torch.stack([sample_displaced(flow2[..., c].contiguous(), fx, fy) for c in range(2)], dim=-1)
    merged = flow1 + sampled
    # merge_two_flows returns the other flow verbatim when one is all <= 0
    f1_zero = flow1.amax(dim=dims, keepdim=True) == 0
    f2_zero = flow2.amax(dim=dims, keepdim=True) == 0
    return torch.where(f1_zero, flow2, torch.where(f2_zero, flow1, merged))


def compose_flows_tiled(flow1: torch.Tensor, flow2: torch.Tensor, grid: TileGrid) -> torch.Tensor:
    """Tile-wise composition: per halo tile ``f1(p) + f2(p - f1(p))`` with f2
    zero outside the tile's halo window and the ``max() == 0``
    short-circuits on the whole windows; interiors stitched."""
    o = grid.overlap
    c1 = pad_canvas(flow1, grid)
    c2 = pad_canvas(flow2, grid)
    origins = torch.from_numpy(tile_origins(grid))
    outs = []
    for s in range(0, origins.shape[0], _COMPOSE_BATCH):
        part = origins[s : s + _COMPOSE_BATCH]
        f1, f2 = halo_windows(c1, part, grid), halo_windows(c2, part, grid)
        outs.append(_compose(f1, f2, (1, 2, 3))[:, o : o + grid.tile_h, o : o + grid.tile_w])
    return stitch_interiors(torch.cat(outs), grid)


def inverse_of(t_mat) -> np.ndarray:
    """The dst -> src 2x3 matrix of a forward 2x3 ``t_mat`` (pinv in
    float64)."""
    t = np.asarray(t_mat, dtype=np.float64)
    return np.linalg.pinv(np.vstack([t, [0.0, 0.0, 1.0]]))[:2]


def affine_warp_bands(img: torch.Tensor, inv, out_h: int, out_w: int, bits=None) -> torch.Tensor:
    """(out_h, out_w) float32 ``src(inv . p)`` of the (H, W) plane ``img``;
    ``inv`` is the dst -> src 2x3 matrix, a float64 numpy array (its terms
    rounded to float32 on the host) or a float32 device tensor."""
    src = img.to(torch.float32).contiguous()[None]
    dev = src.device
    if isinstance(inv, torch.Tensor):
        m = inv.to(dev, torch.float32)
        c = (m[0, 0] - 1.0, m[0, 1], m[0, 2], m[1, 0], m[1, 1] - 1.0, m[1, 2])

        def consts(r0):
            return c[1] * float(r0) + c[2], c[4] * float(r0) + c[5]
    else:
        a = np.asarray(inv, np.float64)
        c = (float(np.float32(a[0, 0] - 1.0)), float(np.float32(a[0, 1])), None,
             float(np.float32(a[1, 0])), float(np.float32(a[1, 1] - 1.0)), None)

        def consts(r0):
            return (float(np.float32(a[0, 1] * r0 + a[0, 2])),
                    float(np.float32((a[1, 1] - 1.0) * r0 + a[1, 2])))

    xs = torch.arange(out_w, device=dev, dtype=torch.float32).view(1, out_w)
    rows = min(max(1, AFFINE_BAND_PIXELS // max(1, out_w)), max(out_h, 1))
    out = torch.empty((out_h, out_w), dtype=torch.float32, device=dev)
    for r0 in range(0, out_h, rows):
        bh = min(rows, out_h - r0)
        yl = torch.arange(bh, device=dev, dtype=torch.float32).view(bh, 1)
        cx, cy = consts(r0)
        fx = c[0] * xs + (c[1] * yl + cx)
        fy = c[3] * xs + (c[4] * yl + cy)
        out[r0 : r0 + bh] = sample_displaced(src, fx[None], fy[None], r0, bits)[0]
    return out


def inverse_affine_traced(fwd: torch.Tensor) -> torch.Tensor:
    """Inverse (2, 3) of a forward (2, 3) float32 device matrix via the
    adjugate; a singular matrix gives the zero matrix."""
    a, b, tx = fwd[0, 0], fwd[0, 1], fwd[0, 2]
    c, d, ty = fwd[1, 0], fwd[1, 1], fwd[1, 2]
    det = a * d - b * c
    nonsingular = torch.abs(det) > 1e-12
    idet = torch.where(nonsingular, 1.0 / torch.where(nonsingular, det, 1.0), 0.0)
    ia, ib = d * idet, -b * idet
    ic, id_ = -c * idet, a * idet
    itx = -(ia * tx + ib * ty)
    ity = -(ic * tx + id_ * ty)
    return torch.stack([torch.stack([ia, ib, itx]), torch.stack([ic, id_, ity])])


def affine_warp_traced(img: torch.Tensor, fwd: torch.Tensor) -> torch.Tensor:
    """``cv.warpAffine`` by a forward 2x3 float32 device matrix: float32
    (H, W) output."""
    h, w = img.shape
    return affine_warp_bands(img, inverse_affine_traced(fwd.to(torch.float32)), h, w)
