"""Affine warps through K1, one band of output rows at a time.

PyTorch counterpart of ``microaligner_tpu/ops/affine_tiled.py``:
``dst(p) = bilinear src(inv . p)``, zero outside (``cv.warpAffine`` with
BORDER_CONSTANT), for the inverse (dst -> src) 2x3 matrix ``inv``.

For each band of output rows the displacement ``inv . p - p`` is built in
float32 from band-local rows, ``M . (x, y_local) + c`` with ``M = A - I``
and the band's constant ``c`` (taken in float64 when the matrix is on the
host), and K1 samples the whole source plane with it (its output window
starts at the band's first row).  An absolute float32 source coordinate
would keep only about 1.2e-3 px at 20k; the displacement keeps the
fraction exact to float32 rounding of a few hundred pixels at most.  No
whole-plane displacement field exists at any time.

K1 gathers its four taps anywhere in the plane, so it is exact for any
matrix: the JAX package's band contract (``plan_affine_tiled``), its
windowed canvas and its exact-gather fallback, which exist because a TPU
gathers slowly, have no counterpart here.

The band axis is sharded over the tile mesh of the plane's device
(``parallel.current_tile_mesh``), as the JAX package's ``_affine_tiled_exec``
shards its tiles; on the plane's one device each band is written straight
into the output.
"""

from __future__ import annotations

import numpy as np
import torch

from microaligner_tpu_torch.ops.kernel_sample import sample_displaced
from microaligner_tpu_torch.parallel.tile_runner import current_tile_mesh, mesh_is_local, tile_map

__all__ = ["affine_warp_bands", "affine_warp_traced", "inverse_affine_traced"]

BAND_PIXELS = 1 << 24  # output pixels per band (two 64 MiB displacement fields)


def affine_warp_bands(img: torch.Tensor, inv, out_h: int, out_w: int,
                      band_rows: int | None = None) -> torch.Tensor:
    """(out_h, out_w) float32 ``src(inv . p)`` of the (H, W) plane ``img``
    on its device.  ``inv`` is the dst -> src 2x3 matrix: a numpy array
    (host, float64) or a float32 tensor on the device (the register's
    matrices, never read back)."""
    src = img.to(torch.float32).contiguous()[None]
    dev = src.device
    if isinstance(inv, torch.Tensor):
        m = inv.to(dev, torch.float32)

        def coefs(m):  # M = A - I and the translation, on m's device
            return m[0, 0] - 1.0, m[0, 1], m[0, 2], m[1, 0], m[1, 1] - 1.0, m[1, 2]

        def consts(c, r0):
            return c[1] * float(r0) + c[2], c[4] * float(r0) + c[5]
    else:
        a = np.asarray(inv, np.float64)
        m = torch.zeros(0)  # nothing to copy: the host matrix's terms are Python floats

        def coefs(m):
            return (float(np.float32(a[0, 0] - 1.0)), float(np.float32(a[0, 1])), None,
                    float(np.float32(a[1, 0])), float(np.float32(a[1, 1] - 1.0)), None)

        def consts(c, r0):
            return (float(np.float32(a[0, 1] * r0 + a[0, 2])),
                    float(np.float32((a[1, 1] - 1.0) * r0 + a[1, 2])))

    def band(r0, bh, src, c, xs):
        yl = torch.arange(bh, device=src.device, dtype=torch.float32).view(bh, 1)
        cx, cy = consts(c, r0)
        fx = c[0] * xs + (c[1] * yl + cx)
        fy = c[3] * xs + (c[4] * yl + cy)
        return sample_displaced(src, fx[None], fy[None], row0=r0)[0]

    def xs_on(device):
        return torch.arange(out_w, device=device, dtype=torch.float32).view(1, out_w)

    rows = min(band_rows or max(1, BAND_PIXELS // max(1, out_w)), max(out_h, 1))
    mesh = current_tile_mesh(dev)
    if mesh_is_local(mesh, dev):
        c, xs = coefs(m), xs_on(dev)
        out = torch.empty((out_h, out_w), dtype=torch.float32, device=dev)
        for r0 in range(0, out_h, rows):
            out[r0 : r0 + rows] = band(r0, min(rows, out_h - r0), src, c, xs)
        return out
    # every band samples all ``rows`` rows (those past ``out_h`` are dropped)
    # so that the shards' outputs stack
    nb = -(-out_h // rows)
    bands = tile_map(lambda i, src, m: band(int(i) * rows, rows, src, coefs(m), xs_on(src.device)),
                     (torch.arange(nb),), batch=1, mesh=mesh, broadcast=(src, m.to(dev)), unbatched=True)
    return bands.reshape(nb * rows, out_w)[:out_h]


def inverse_affine_traced(fwd: torch.Tensor) -> torch.Tensor:
    """Inverse (2, 3) of a forward (2, 3) float32 device matrix via the
    adjugate, on the device; a singular matrix (|det| <= 1e-12) gives the
    zero matrix, which samples the source's (0, 0) everywhere, as the JAX
    package's gather branch does."""
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
    """``cv.warpAffine`` by a forward (src -> dst) 2x3 float32 matrix that
    stays on the device (no host round trip): float32 (H, W) output of the
    (H, W) ``img``."""
    h, w = img.shape
    return affine_warp_bands(img, inverse_affine_traced(fwd.to(torch.float32)), h, w)
