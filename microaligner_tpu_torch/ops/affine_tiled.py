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
"""

from __future__ import annotations

import numpy as np
import torch

from microaligner_tpu_torch.ops.kernel_sample import sample_displaced

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
        m00, m01, tx = m[0, 0] - 1.0, m[0, 1], m[0, 2]
        m10, m11, ty = m[1, 0], m[1, 1] - 1.0, m[1, 2]

        def consts(r0):
            return m01 * float(r0) + tx, m11 * float(r0) + ty
    else:
        a = np.asarray(inv, np.float64)
        m00, m01 = float(np.float32(a[0, 0] - 1.0)), float(np.float32(a[0, 1]))
        m10, m11 = float(np.float32(a[1, 0])), float(np.float32(a[1, 1] - 1.0))

        def consts(r0):
            return (float(np.float32(a[0, 1] * r0 + a[0, 2])),
                    float(np.float32((a[1, 1] - 1.0) * r0 + a[1, 2])))
    xs = torch.arange(out_w, device=dev, dtype=torch.float32).view(1, out_w)
    rows = band_rows or max(1, BAND_PIXELS // max(1, out_w))
    out = torch.empty((out_h, out_w), dtype=torch.float32, device=dev)
    for r0 in range(0, out_h, rows):
        bh = min(rows, out_h - r0)
        yl = torch.arange(bh, device=dev, dtype=torch.float32).view(bh, 1)
        cx, cy = consts(r0)
        fx = m00 * xs + (m01 * yl + cx)
        fy = m10 * xs + (m11 * yl + cy)
        out[r0 : r0 + bh] = sample_displaced(src, fx[None], fy[None], row0=r0)[0]
    return out


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
