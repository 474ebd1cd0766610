"""Farneback dense optical flow (single level, Gaussian window).

PyTorch counterpart of ``microaligner_tpu/optflow/farneback.py``, matching
``cv.calcOpticalFlowFarneback(prev=mov, next=ref, pyr_scale=0.5, levels=0,
winsize, iterations, poly_n=1, poly_sigma=1.7, OPTFLOW_FARNEBACK_GAUSSIAN)``.

Stages, on (N, H, W) batches with the flow kept as separate x and y planes:

1. 3x3 pre-smooth ([1, 2, 1] / 4, REFLECT_101), padded by one replicated px;
2. K2 (:func:`~microaligner_tpu_torch.ops.kernel_poly.poly_pair_m`): both
   polynomial expansions R0, R1 = [b_y, b_x, A_yy, A_xx, A_xy] and the
   first iteration's normal equations M0 at zero flow;
3. per iteration, K3 (:func:`~microaligner_tpu_torch.ops.kernel_agg.smooth5_solve`):
   Gaussian window aggregation of M plus the regularised 2x2 solve;
4. between iterations, K4
   (:func:`~microaligner_tpu_torch.ops.kernel_matrices.update_matrices`):
   R1 resampled at the new flow and recombined into M.

All of it runs in float32; borders replicate, as in OpenCV, except the
pre-smooth's REFLECT_101.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from microaligner_tpu_torch.ops.filters import sep_filter2d
from microaligner_tpu_torch.ops.kernel_agg import agg_kernel, smooth5_solve
from microaligner_tpu_torch.ops.kernel_matrices import (
    BORDER_SCALE,
    edge_scale_map,
    inbounds_map,
    update_matrices,
    zero_flow_matrices,
)
from microaligner_tpu_torch.ops.kernel_poly import poly_pair_m

__all__ = ["farneback", "poly_exp"]

# the JAX package's names for tables and maps that live beside the kernels here
_BORDER_SCALE = BORDER_SCALE
_PRESMOOTH = np.array([0.25, 0.5, 0.25], dtype=np.float32)
_agg_kernel = agg_kernel
_edge_scale_map = edge_scale_map
_inbounds_map = inbounds_map
_update_matrices_zero_flow_cf = zero_flow_matrices


@functools.lru_cache(maxsize=None)
def _poly_exp_coeffs(n: int, sigma: float):
    """Gaussian applicability kernels g, xg, xxg over [-n, n] and the inverse
    normal-matrix entries of OpenCV's FarnebackPolyExp setup (G_ij = sum
    g(y)g(x) b_i b_j, b = [1, x, y, x^2, y^2, xy]), in float64 then cast."""
    x = np.arange(-n, n + 1, dtype=np.float64)
    g = np.exp(-(x**2) / (2.0 * sigma * sigma))
    g /= g.sum()
    xg = x * g
    xxg = x * x * g
    xs, ys = np.meshgrid(x, x)
    wgt = np.outer(g, g)
    basis = np.stack([np.ones_like(xs), xs, ys, xs * xs, ys * ys, xs * ys], axis=-1)
    G = np.einsum("yx,yxi,yxj->ij", wgt, basis, basis)
    invG = np.linalg.inv(G)
    return (
        g.astype(np.float32),
        xg.astype(np.float32),
        xxg.astype(np.float32),
        float(invG[1, 1]),
        float(invG[0, 3]),
        float(invG[3, 3]),
        float(invG[5, 5]),
    )


def _poly_coeff_tuple(n: int, sigma: float):
    """The eight scalars K2 takes: (g0, g1, xg1, xxg1, ig11, ig03, ig33, ig55)."""
    g, xg, xxg, ig11, ig03, ig33, ig55 = _poly_exp_coeffs(n, float(sigma))
    return (float(g[0]), float(g[1]), float(xg[2]), float(xxg[2]), ig11, ig03, ig33, ig55)


def _replicate_index(size: int, r: int, device) -> torch.Tensor:
    return torch.arange(-r, size + r, device=device).clamp(0, size - 1)


def _corr_axis_multi(x: torch.Tensor, kernels, axis: int):
    """Correlate (..., H, W) with several short 1-D kernels along ``axis``,
    replicate-padded, same-size output; zero taps are skipped and taps are
    summed in ascending order, as the JAX package sums them."""
    taps = len(kernels[0])
    r = (taps - 1) // 2
    size = x.shape[axis]
    xp = x.index_select(axis, _replicate_index(size, r, x.device))
    outs = [None] * len(kernels)
    for i in range(taps):
        sl = xp.narrow(axis, i, size)
        for j, ker in enumerate(kernels):
            wgt = float(ker[i])
            if wgt == 0.0:
                continue
            t = sl * wgt
            if outs[j] is None:
                outs[j] = t
            else:
                outs[j] += t
    return [o if o is not None else torch.zeros_like(x) for o in outs]


def _poly_exp_cf(img: torch.Tensor, n: int = 1, sigma: float = 1.7) -> torch.Tensor:
    """Polynomial expansion of (..., H, W) -> (..., 5, H, W) channels
    [b_y, b_x, A_yy, A_xx, A_xy], for any ``n`` (K2 covers n = 1)."""
    g, xg, xxg, ig11, ig03, ig33, ig55 = _poly_exp_coeffs(n, float(sigma))
    f = img.to(torch.float32)
    row0, row1, row2 = _corr_axis_multi(f, (g, xg, xxg), axis=-2)
    b1, b2, b4 = _corr_axis_multi(row0, (g, xg, xxg), axis=-1)
    b3, b6 = _corr_axis_multi(row1, (g, xg), axis=-1)
    (b5,) = _corr_axis_multi(row2, (g,), axis=-1)
    return torch.stack(
        [b3 * ig11, b2 * ig11, b5 * ig33 + b1 * ig03, b4 * ig33 + b1 * ig03, b6 * ig55],
        dim=-3,
    )


def poly_exp(img: torch.Tensor, n: int = 1, sigma: float = 1.7) -> torch.Tensor:
    """Polynomial expansion -> (H, W, 5), the public channels-last view."""
    return _poly_exp_cf(img, n, sigma).movedim(-3, -1)


def _pre_smooth(img: torch.Tensor) -> torch.Tensor:
    """OpenCV's per-level 3x3 blur ([1, 2, 1] / 4, REFLECT_101)."""
    return sep_filter2d(img.to(torch.float32), _PRESMOOTH, _PRESMOOTH)


def _pad_replicate1(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W) -> (N, H+2, W+2), one replicated pixel on every side."""
    h, w = x.shape[-2:]
    x = x.index_select(-2, _replicate_index(h, 1, x.device))
    return x.index_select(-1, _replicate_index(w, 1, x.device)).contiguous()


def _poly_pair_m(movs: torch.Tensor, refs: torch.Tensor, n: int, sigma: float):
    """(N, H, W) pair -> (R0, R1, M0); K2 for n = 1, the plain expansion and
    combine for other ``n`` (the JAX package has no kernel for those either)."""
    s0 = _pre_smooth(movs)
    s1 = _pre_smooth(refs)
    if n == 1:
        return poly_pair_m(_pad_replicate1(s0), _pad_replicate1(s1), _poly_coeff_tuple(n, sigma))
    r0 = _poly_exp_cf(s0, n, sigma)
    r1 = _poly_exp_cf(s1, n, sigma)
    return r0, r1, zero_flow_matrices(r0, r1)


def _farneback_core_parts(
    movs: torch.Tensor,
    refs: torch.Tensor,
    win_size: int,
    num_iter: int,
    poly_n: int,
    poly_sigma: float,
):
    """Batched (N, H, W) Farneback -> (fx, fy), each (N, H, W) float32."""
    if num_iter < 1:
        raise ValueError(f"farneback requires num_iter >= 1, got {num_iter}")
    r0, r1, m = _poly_pair_m(movs, refs, poly_n, poly_sigma)
    fx = fy = None
    for i in range(num_iter):
        fx, fy = smooth5_solve(m, win_size)
        if i < num_iter - 1:
            m = update_matrices(r0, r1, fx, fy)
    return fx, fy


def farneback(
    mov_img,
    ref_img,
    win_size: int = 51,
    num_iter: int = 1,
    poly_n: int = 1,
    poly_sigma: float = 1.7,
    device=None,
) -> torch.Tensor:
    """Dense (H, W, 2) flow such that ``mov(p) ~ ref(p + flow(p))``.

    ``mov`` plays OpenCV's ``prev`` and ``ref`` its ``next``; the Warper then
    pulls ``mov`` samples from ``p - flow``.  Takes numpy arrays or tensors;
    ``device`` defaults to the device of ``mov_img`` (CPU for numpy).
    """
    mov = torch.as_tensor(mov_img)
    dev = torch.device(device) if device is not None else mov.device
    mov = mov.to(dev, torch.float32)
    ref = torch.as_tensor(ref_img).to(dev, torch.float32)
    fx, fy = _farneback_core_parts(
        mov[None], ref[None], int(win_size), int(num_iter), int(poly_n), float(poly_sigma)
    )
    return torch.stack([fx[0], fy[0]], dim=-1)
