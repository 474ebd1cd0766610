"""DAISY dense descriptors (Tola et al., PAMI 2010).

PyTorch counterpart of ``microaligner_tpu/features/daisy.py``, with the
reference's parameters (``cv.xfeatures2d.DAISY``: radius 21, 3 rings of 8
points, 8 orientation bins, bilinear interpolation, no keypoint orientation)
-> 200-d descriptors.

Pipeline: a slight pre-smooth, x/y gradients, 8 rectified orientation
layers, incrementally smoothed cubes (one sigma a ring), then bilinear
gathers at the 25 grid points around each keypoint.  The ring blurs are
operator products (``ops/filters.py::gaussian_blur_mxu``) whose operands
are float32 or bf16 (float32 sums either way): the JAX package asks for
DEFAULT precision for them on every backend (bf16 operands on its TPU;
XLA's CPU multiplies in float32) unless ``MICROALIGNER_TPU_DAISY_EXACT=1``,
and the port follows that rule by device (:func:`daisy_operand_dtype`).
The short pre-smooth stays float32 on both routes.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from microaligner_tpu_torch.features.routes import daisy_operand_dtype
from microaligner_tpu_torch.ops.filters import _reflect101_index, gaussian_blur_mxu, gaussian_kernel

__all__ = ["daisy_at_points", "DAISY_DIM"]

_RADIUS = 21.0
_Q_RADIUS = 3
_Q_THETA = 8
_Q_HIST = 8
DAISY_DIM = (1 + _Q_RADIUS * _Q_THETA) * _Q_HIST  # 200
_GATHER_CHUNK = 1 << 17  # keypoints per gather: bounds the (8, K, 25) tap tensors


@functools.lru_cache(maxsize=None)
def _grid_offsets() -> np.ndarray:
    """(25, 2) [dx, dy] grid offsets: centre, then rings inside-out."""
    pts = [(0.0, 0.0)]
    for ring in range(_Q_RADIUS):
        r = _RADIUS * (ring + 1) / _Q_RADIUS
        for k in range(_Q_THETA):
            a = 2.0 * np.pi * k / _Q_THETA
            pts.append((r * np.cos(a), r * np.sin(a)))
    return np.asarray(pts, dtype=np.float32)


@functools.lru_cache(maxsize=None)
def _ring_of_point() -> np.ndarray:
    """(25,) cube index per grid point: the centre uses the innermost cube."""
    return np.asarray([0] + [r for r in range(_Q_RADIUS) for _ in range(_Q_THETA)], np.int32)


@functools.lru_cache(maxsize=None)
def _sigmas() -> np.ndarray:
    """Per-ring smoothing: sigma_i = R*(i+1)/(2*Q) -> 3.5, 7, 10.5."""
    return np.asarray([_RADIUS * (i + 1) / (2 * _Q_RADIUS) for i in range(_Q_RADIUS)], np.float32)


def _increments() -> list:
    """The incremental smoothing of each ring's cube, sqrt(s_i^2 - s_{i-1}^2)."""
    out, prev = [], 0.0
    for s in _sigmas():
        out.append(float(np.sqrt(s * s - prev * prev)))
        prev = float(s)
    return out


def _ksize(sigma: float) -> int:
    return int(round(sigma * 4)) * 2 + 1


def _blur_chw(x: torch.Tensor, sigma: float, operand_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Gaussian blur of a (C, H, W) stack along H, then W (REFLECT_101).

    The ring sigmas (ksize 29..63) are operator products with
    ``operand_dtype`` operands; short kernels are float32 shifted-slice
    sums, one multiply and one add a tap in ascending order, as the JAX
    package writes them.
    """
    ksize = _ksize(sigma)
    if ksize >= 13 and min(x.shape[-2:]) > (ksize - 1) // 2:
        return gaussian_blur_mxu(x, ksize, sigma, operand_dtype)
    taps = gaussian_kernel(ksize, sigma).tolist()
    r = (ksize - 1) // 2

    def corr(a, axis):
        size = a.shape[axis]
        ap = a.index_select(axis, _reflect101_index(size, r, a.device))
        out = None
        for i, k in enumerate(taps):
            sl = ap.narrow(axis, i, size) * k
            out = sl if out is None else out + sl
        return out

    return corr(corr(x, 1), 2)


def _orientation_cubes(img: torch.Tensor, operand_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(H, W) image -> (8, Q_RADIUS, H, W) smoothed rectified gradient
    layers, the ring blurs' products on ``operand_dtype`` operands."""
    f = _blur_chw(img.to(torch.float32)[None], 0.5)[0]
    h, w = f.shape
    fp = f.index_select(0, _reflect101_index(h, 1, f.device)).index_select(
        1, _reflect101_index(w, 1, f.device))
    gx = (fp[1:-1, 2:] - fp[1:-1, :-2]) * 0.5
    gy = (fp[2:, 1:-1] - fp[:-2, 1:-1]) * 0.5
    thetas = 2.0 * np.pi * np.arange(_Q_HIST) / _Q_HIST
    cos = torch.from_numpy(np.cos(thetas).astype(np.float32)).to(f.device).view(-1, 1, 1)
    sin = torch.from_numpy(np.sin(thetas).astype(np.float32)).to(f.device).view(-1, 1, 1)
    layers = torch.clamp_min(gx[None] * cos + gy[None] * sin, 0.0)  # (8, H, W)
    del fp, gx, gy
    cubes = []
    cur = layers
    for inc in _increments():
        cur = _blur_chw(cur, inc, operand_dtype)
        cubes.append(cur)
    # orientation-major (8, Q, H, W): the (8, Q*H*W) gather table without a copy
    return torch.stack(cubes, dim=1)


def _gather_descriptors(cubes: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """All 25 grid points of K keypoints as four flat takes (one a bilinear
    tap) over the (8, Q*H*W) cube table -> (K, 200).  Taps are clamped to
    the cube, as the reference's DAISY clamps them."""
    _, q, h, w = cubes.shape
    flat = cubes.reshape(_Q_HIST, q * h * w)
    offs = torch.from_numpy(_grid_offsets()).to(cubes.device)
    base = torch.from_numpy(_ring_of_point().astype(np.int64) * (h * w)).to(cubes.device)[None]
    outs = []
    for c0 in range(0, coords.shape[0], _GATHER_CHUNK):
        c = coords[c0 : c0 + _GATHER_CHUNK]
        xs = torch.clamp(c[:, 0:1] + offs[None, :, 0], 0.0, w - 1.000001)  # (K, 25)
        ys = torch.clamp(c[:, 1:2] + offs[None, :, 1], 0.0, h - 1.000001)
        fx0 = torch.floor(xs)
        fy0 = torch.floor(ys)
        tx = (xs - fx0)[None]
        ty = (ys - fy0)[None]
        x0 = fx0.to(torch.int64)
        y0 = fy0.to(torch.int64)
        x1 = torch.clamp_max(x0 + 1, w - 1)
        y1 = torch.clamp_max(y0 + 1, h - 1)
        k, p = xs.shape

        def take(yy, xx):
            return flat[:, (base + yy * w + xx).reshape(-1)].reshape(_Q_HIST, k, p)

        out = take(y0, x0) * (1 - tx) * (1 - ty)
        out = out + take(y0, x1) * tx * (1 - ty)
        out = out + take(y1, x0) * (1 - tx) * ty
        out = out + take(y1, x1) * tx * ty  # (8, K, 25)
        outs.append(out.permute(1, 2, 0).reshape(k, p * _Q_HIST))
    return torch.cat(outs) if len(outs) > 1 else outs[0]


def normalize_descriptors(desc: torch.Tensor) -> torch.Tensor:
    """Unit L2 norm per row (rows of norm below 1e-8 are divided by 1e-8)."""
    return desc / torch.clamp_min(torch.linalg.vector_norm(desc, dim=-1, keepdim=True), 1e-8)


def daisy_at_points(img: torch.Tensor, coords: torch.Tensor, normalize: bool = True,
                    operand_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Descriptors (K, 200) of ``img`` at ``coords`` (K, 2) [x, y], sampled
    at exactly the given coords.  ``normalize=True`` (the JAX package's
    default) L2-normalizes each descriptor; ``False`` is the reference's
    NRM_NONE.  ``operand_dtype`` is the blur products' (float32 or bf16);
    None reads :func:`daisy_operand_dtype` for ``img``'s device."""
    img = torch.as_tensor(img)
    coords = torch.as_tensor(coords, dtype=torch.float32).to(img.device)
    if operand_dtype is None:
        operand_dtype = daisy_operand_dtype(img.device)
    desc = _gather_descriptors(_orientation_cubes(img, operand_dtype), coords)
    return normalize_descriptors(desc) if normalize else desc
