"""K3: Gaussian window aggregation of the normal equations + 2x2 solve.

Replaces ``microaligner_tpu/ops/pallas_agg.py::pallas_smooth5_solve`` (pass 1
``_smooth_w_padded`` / ``_w_kernel_ring``, also public as
``pallas_smooth_w``; pass 2 ``_h_solve_kernel_ring``), which runs in every
Farneback iteration
(``microaligner_tpu/optflow/farneback.py::_update_flow_gaussian_cf``).

The five planes of M = [G11, G12, G22, h1, h2] are smoothed with the
2r+1-tap Gaussian of ``FarnebackUpdateFlow_GaussianBlur`` (r = winsize // 2,
sigma = 0.3 r, replicate border), first along W and then along H, and each
pixel's system is solved with the 1e-3 regulariser:
det = g11 g22 - g12^2 + 1e-3, fx = (g11 h2 - g12 h1) / det,
fy = (g22 h1 - g12 h2) / det.

On the H100 the kernel (``csrc/agg.cu``) is bound by f32 arithmetic: 2r+1
multiply-adds per pass, channel and pixel (99 x 5 x 2 on the main path).
Each block stages its strip and the r-pixel halo in shared memory, so each
input is read from device memory once per pass; the row pass writes a
scratch tensor this wrapper allocates, and the column pass fuses the solve
and writes only fx and fy.  Its staging limits r to 128, checked here.  The
row pass alone is :func:`smooth_w`, the counterpart of ``pallas_smooth_w``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from microaligner_tpu_torch.ops import cuda_lib

__all__ = [
    "agg_kernel",
    "smooth_axis_plain",
    "smooth5_solve",
    "smooth5_solve_plain",
    "smooth_w",
    "smooth_w_plain",
]

MAX_HALF_WINDOW = 128  # the CUDA kernel's shared-memory staging limit on r


@functools.lru_cache(maxsize=None)
def agg_kernel(winsize: int) -> np.ndarray:
    """Gaussian aggregation kernel of FarnebackUpdateFlow_GaussianBlur:
    length 2*(winsize//2)+1, sigma = (winsize//2)*0.3, normalized."""
    m = winsize // 2
    i = np.arange(-m, m + 1, dtype=np.float64)
    k = np.exp(-(i**2) / (2.0 * (m * 0.3) ** 2))
    k /= k.sum()
    return k.astype(np.float32)


def smooth_axis_plain(x: torch.Tensor, taps: np.ndarray, axis: int) -> torch.Tensor:
    """Replicate-border correlation of ``x`` with ``taps`` along ``axis``
    (-1 or -2): out[i] = sum_k taps[k] x[clamp(i + k - r)], summed in
    ascending k with a separate multiply and add per tap."""
    r = (len(taps) - 1) // 2
    n = x.shape[axis]
    idx = torch.arange(-r, n + r, device=x.device).clamp(0, n - 1)
    xp = x.index_select(axis, idx)
    acc = None
    for k, wk in enumerate(taps.tolist()):
        t = xp.narrow(axis, k, n) * wk
        if acc is None:
            acc = t
        else:
            acc += t  # in place: same rounding as acc + t
    return acc


def smooth5_solve_plain(M: torch.Tensor, winsize: int):
    """Plain PyTorch version of K3: (N, 5, H, W) -> (fx, fy), each (N, H, W)."""
    smooth5_solve_plain.calls += 1
    taps = agg_kernel(winsize)
    s = smooth_axis_plain(smooth_axis_plain(M, taps, -1), taps, -2)
    g11, g12, g22, h1, h2 = s.unbind(1)
    idet = 1.0 / (g11 * g22 - g12 * g12 + 1e-3)
    return (g11 * h2 - g12 * h1) * idet, (g22 * h1 - g12 * h2) * idet


smooth5_solve_plain.calls = 0


@functools.lru_cache(maxsize=None)
def _taps_on(winsize: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(agg_kernel(winsize), device=device)


def _check_cuda_window(name: str, winsize: int, planes: int, h: int) -> int:
    r = winsize // 2
    if r > MAX_HALF_WINDOW:
        raise ValueError(f"{name}: winsize // 2 = {r} exceeds the kernel's limit {MAX_HALF_WINDOW}")
    cuda_lib.check_grid(name, planes, h)  # the row pass: one block row per image row
    return r


def smooth_w_plain(x: torch.Tensor, winsize: int) -> torch.Tensor:
    """Plain PyTorch version of K3's row pass alone."""
    smooth_w_plain.calls += 1
    return smooth_axis_plain(x, agg_kernel(winsize), -1)


smooth_w_plain.calls = 0


def smooth_w(x: torch.Tensor, winsize: int) -> torch.Tensor:
    """K3's row pass alone (``pallas_smooth_w``): (N, C, H, W) contiguous
    float32 smoothed along W.  A CPU tensor takes the plain version; a CUDA
    tensor launches the row kernel or raises."""
    if x.dim() != 4 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("smooth_w takes a contiguous float32 (N, C, H, W) tensor")
    if winsize < 1:
        raise ValueError(f"smooth_w: winsize must be >= 1, got {winsize}")
    if x.device.type == "cpu":
        return smooth_w_plain(x, winsize)
    cuda_lib.require_cuda(x)
    n, c, h, w = x.shape
    r = _check_cuda_window("smooth_w", winsize, n * c, h)
    out = torch.empty_like(x)
    cuda_lib.call("ma_smooth_rows", x.device, x, out, _taps_on(winsize, x.device), n * c, h, w, r)
    smooth_w.launches += 1
    return out


smooth_w.launches = 0


def smooth5_solve(M: torch.Tensor, winsize: int):
    """Window aggregation + solve: (N, 5, H, W) contiguous float32 ->
    (fx, fy).  A CPU tensor takes the plain version; a CUDA tensor launches
    K3 or raises."""
    if M.dim() != 4 or M.shape[1] != 5:
        raise ValueError(f"smooth5_solve takes (N, 5, H, W), got {tuple(M.shape)}")
    if M.dtype != torch.float32 or not M.is_contiguous():
        raise ValueError("smooth5_solve: M must be contiguous float32")
    if winsize < 1:
        raise ValueError(f"smooth5_solve: winsize must be >= 1, got {winsize}")
    if M.device.type == "cpu":
        return smooth5_solve_plain(M, winsize)
    cuda_lib.require_cuda(M)
    n, _, h, w = M.shape
    r = _check_cuda_window("smooth5_solve", winsize, 5 * n, h)
    scratch = torch.empty_like(M)
    fx = torch.empty((n, h, w), dtype=torch.float32, device=M.device)
    fy = torch.empty_like(fx)
    cuda_lib.call("ma_smooth5_solve", M.device, M, scratch, fx, fy,
                  _taps_on(winsize, M.device), n, h, w, r)
    smooth5_solve.launches += 1
    return fx, fy


smooth5_solve.launches = 0
