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

On the H100 the kernel (``csrc/agg.cu``) is bound by float32 arithmetic: one
fused multiply-add a tap, pass, channel and pixel (99 x 5 x 2 on the main
path), with the scratch's round trip through device memory second.  A
thread owns 16 consecutive outputs along the filtered axis and slides a
register window over the inputs they need, so each value loaded from shared
memory feeds 16 multiply-adds; the taps come in the kernel's parameters
(constant memory), not from shared memory.  A tile is 256 outputs along the
axis by 32 lines, staged with its 2r halo lines in dynamic shared memory;
persistent blocks walk over the tiles and copy the next one with
``cp.async`` (16 bytes a thread where W is a multiple of 4) while they sum
the current one.  The row pass writes a scratch tensor this wrapper
allocates, and the column pass fuses the solve and writes only fx and fy.
The fused multiply-add rounds once a tap where the plain version rounds
twice, so the kernel agrees with :func:`smooth5_solve_plain` to a bar
(1e-4 px) and is no further from a float64 run than the plain version is;
it is not bit-equal to it.  The tap table limits r to 128, checked here.
The row pass alone is :func:`smooth_w`, the counterpart of
``pallas_smooth_w``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from microaligner_tpu_torch.ops import cuda_lib

__all__ = [
    "agg_kernel",
    "block_shared_bytes",
    "smooth_axis_plain",
    "smooth5_solve",
    "smooth5_solve_plain",
    "smooth_w",
    "smooth_w_plain",
]

# the CUDA kernel's limit on r: its tap table in the kernel parameters holds
# 2 * 128 + 1 taps (two staged tiles of 256 + 2r lines then take 130 KB of the
# 227 KB of shared memory a block can have)
MAX_HALF_WINDOW = 128
# agg.cu's launch shape: a tile of either pass is 32 lines x 256 outputs along
# the filtered axis, a block is 512 threads, a step of the sum takes 20 taps
# in the row pass and 11 in the column pass
_TILE = (32, 256)
BLOCK_THREADS = 512
_STEP_TAPS = {"smooth_rows_kernel": 20, "smooth_cols_solve_kernel": 11}


def block_shared_bytes(kernel: str, r: int) -> int:
    """Dynamic shared memory a block of ``smooth_rows_kernel`` or
    ``smooth_cols_solve_kernel`` takes at half-window ``r``: two tiles of
    256 + 2r lines (the taps rounded up to whole steps) by 32 floats.  The
    row pass rounds its row stride up to 4 mod 8 floats."""
    step = _STEP_TAPS[kernel]
    ntp = -(-(2 * r + 1) // step) * step
    if kernel == "smooth_rows_kernel":
        lines = -(-(_TILE[1] + ntp) // 4) * 4
        lines += 4 if lines % 8 == 0 else 0
    else:
        lines = _TILE[1] + ntp - 1
    return 4 * 2 * _TILE[0] * lines


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
def _taps_host(winsize: int) -> torch.Tensor:
    """The taps as a CPU tensor: the C entry points copy them into the
    kernels' parameters."""
    return torch.from_numpy(agg_kernel(winsize))


def _check_cuda_window(name: str, winsize: int, planes: int, h: int, w: int) -> int:
    r = winsize // 2
    if r > MAX_HALF_WINDOW:
        raise ValueError(f"{name}: winsize // 2 = {r} exceeds the kernel's limit {MAX_HALF_WINDOW}")
    # the kernels number their tiles with an int; the row pass has the most
    # (its tiles start up to 3 columns left of the image)
    if planes * -(-h // _TILE[0]) * -(-(w + 3) // _TILE[1]) >= 2**31:
        raise ValueError(f"{name}: {planes} planes of {h} x {w} are more tiles than an int counts")
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
    r = _check_cuda_window("smooth_w", winsize, n * c, h, w)
    out = torch.empty_like(x)
    cuda_lib.call("ma_smooth_rows", x.device, x, out, _taps_host(winsize), n * c, h, w, r)
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
    r = _check_cuda_window("smooth5_solve", winsize, 5 * n, h, w)
    scratch = torch.empty_like(M)
    fx = torch.empty((n, h, w), dtype=torch.float32, device=M.device)
    fy = torch.empty_like(fx)
    cuda_lib.call("ma_smooth5_solve", M.device, M, scratch, fx, fy,
                  _taps_host(winsize), n, h, w, r)
    smooth5_solve.launches += 1
    return fx, fy


smooth5_solve.launches = 0
