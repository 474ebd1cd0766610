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

The bfloat16 entry.  Where M is bfloat16 (Farneback's reduced-precision
route, ``MICROALIGNER_TPU_AGG_PRECISION=default``), both functions compute
what the TPU kernel computes for bf16 M: its banded operator's coefficients
rounded to bf16 (:func:`bf16_operator`; the TPU operator folds the taps
that the replicate border sends to an edge pixel into one coefficient,
``_banded_smooth_matrix``), products summed in float32, pass 1's result
stored in bf16 (``smooth_w`` returns it), pass 2 summed from those values
and the solve in float32.  On the card that entry is a banded bf16 product
on the tensor cores (``csrc/agg_tc.cu``), the Hopper form of the TPU
kernel's MXU matmul, bound by bytes: a warp owns 32 outputs along the
filtered axis and multiplies their 32 + 2 R8 sources (R8 = r rounded up to
8) by the operator's slice, which :func:`tc_factor_table` lays out on the
host in the lanes' fragment order, one slot a 32-output group, the groups
at least r from both ends sharing one Toeplitz slot.  The tensor cores sum
in their own order, so the entry is held to its plain version within bars,
not bit for bit: the row pass within one bf16 unit plus the bound on two
float32 orders of the same sum, 2 (2r+1) 2^-24 sum_k |c_k x_k|; the flow
within 1e-4 px in mean and 1e-2 px at most; and no further than the plain
version from a float64 run of the same operator.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from microaligner_tpu_torch.ops import cuda_lib
from microaligner_tpu_torch.ops.kernel_matrices import STORED_DTYPES

__all__ = [
    "agg_kernel",
    "bf16_operator",
    "block_shared_bytes",
    "smooth_axis_plain",
    "smooth5_solve",
    "smooth5_solve_plain",
    "smooth_w",
    "smooth_w_plain",
    "tc_factor_table",
]

# the CUDA kernels' limit on r: the float32 entry's tap table in the kernel
# parameters holds 2 * 128 + 1 taps (two staged tiles of 256 + 2r lines then
# take 130 KB of the 227 KB of shared memory a block can have); the bf16
# entry's staged sources are sized for it too
MAX_HALF_WINDOW = 128
# agg.cu's launch shape (the float32 entry): a tile of either pass is 32
# lines x 256 outputs along the filtered axis, a block is 512 threads, a step
# of the sum takes 20 taps in the row pass and 11 in the column pass
_TILE = (32, 256)
BLOCK_THREADS = 512
_STEP_TAPS = {"smooth_rows_kernel": 20, "smooth_cols_solve_kernel": 11}
# agg_tc.cu's (the bf16 entry): 128 outputs a block along the filtered axis,
# 32 a warp (one factor slot), 4 warps; pass 1 takes 64 rows a block, pass 2
# 16 columns (of pass 1's sums, which smooth5_solve stores transposed)
TC_BLOCK, TC_GROUP, TC_THREADS, TC_ROWS, TC_COLS = 128, 32, 128, 64, 16
KERNEL_THREADS = {"smooth_rows_kernel": BLOCK_THREADS, "smooth_cols_solve_kernel": BLOCK_THREADS,
                  "agg_rows_tc_kernel": TC_THREADS, "agg_cols_solve_tc_kernel": TC_THREADS}


def tc_halo(r: int) -> int:
    """R8: the sources a 32-output group of the bf16 entry reads left (and
    right) of its outputs, r rounded up to 8 (so staged rows start on 16
    bytes)."""
    return -(-r // 8) * 8


def tc_sources(r: int) -> int:
    """Sources a 128-output block of the bf16 entry stages: 128 + 2 R8, the
    128 + 2r that block reads rounded up to 16 (240 at window 99, 384 at r =
    128)."""
    return TC_BLOCK + 2 * tc_halo(r)


def tc_steps(r: int) -> int:
    """k-steps of 16 sources a warp of the bf16 entry makes for its 32
    outputs: (32 + 2 R8) / 16 (9 at window 99)."""
    return (TC_GROUP + 2 * tc_halo(r)) // 16


def block_shared_bytes(kernel: str, r: int) -> int:
    """Dynamic shared memory a block of one of K3's kernels takes at
    half-window ``r``.  The float32 entry (``smooth_rows_kernel``,
    ``smooth_cols_solve_kernel``): two tiles of 256 + 2r lines (the taps
    rounded up to whole steps) by 32 floats, the row pass's row stride
    rounded up to 4 mod 8 elements.  The bf16 entry: ``agg_rows_tc_kernel``
    stages 64 rows of 128 + 2 R8 bf16 sources on a stride one 16-byte unit
    longer (or, at r = 0, holds the 128 x 72 transposed sums that take their
    place); ``agg_cols_solve_tc_kernel`` stages 5 planes x 16 columns of
    them."""
    if kernel == "agg_rows_tc_kernel":
        return 2 * max(TC_ROWS * (tc_sources(r) + 8), TC_BLOCK * (TC_ROWS + 8))
    if kernel == "agg_cols_solve_tc_kernel":
        return 2 * 5 * TC_COLS * (tc_sources(r) + 8)
    step = _STEP_TAPS[kernel]
    ntp = -(-(2 * r + 1) // step) * step
    if kernel == "smooth_rows_kernel":
        lines = -(-(_TILE[1] + ntp) // 4) * 4
        lines += 4 if lines % 8 == 0 else 0
        return 4 * 2 * _TILE[0] * lines
    return 4 * 2 * _TILE[0] * (_TILE[1] + ntp - 1)


@functools.lru_cache(maxsize=None)
def agg_kernel(winsize: int) -> np.ndarray:
    """Gaussian aggregation kernel of FarnebackUpdateFlow_GaussianBlur:
    length 2*(winsize//2)+1, sigma = (winsize//2)*0.3, normalized."""
    m = winsize // 2
    i = np.arange(-m, m + 1, dtype=np.float64)
    k = np.exp(-(i**2) / (2.0 * (m * 0.3) ** 2))
    k /= k.sum()
    return k.astype(np.float32)


def _to_bf16(values) -> np.ndarray:
    """float64 values rounded to float32, then to bfloat16 (to nearest
    even), returned as float32."""
    f32 = torch.from_numpy(np.asarray(values, dtype=np.float64).astype(np.float32))
    return f32.to(torch.bfloat16).to(torch.float32).numpy()


@functools.lru_cache(maxsize=None)
def _bf16_operator(tap_bytes: bytes):
    taps = np.frombuffer(tap_bytes, dtype=np.float32)
    r = (len(taps) - 1) // 2
    k = taps.astype(np.float64)
    # float64 sums in ascending tap order, one add after another, as np.add.at folds them
    lead = np.cumsum(k)[r::-1]
    trail = [np.cumsum(k[r + d :])[-1] for d in range(r + 1)]
    return _to_bf16(taps), _to_bf16(lead), _to_bf16(trail), float(_to_bf16(np.cumsum(k)[-1:])[0])


def bf16_operator(taps: np.ndarray):
    """The bf16 route's coefficients for the 2r+1 float32 ``taps``:
    ``(taps, lead, trail, total)``, each rounded to bf16 (values as float32).
    ``taps`` apply where a tap reads a pixel of the axis that no other tap
    of the same output reads; ``lead[i]`` is what output i <= r applies to
    pixel 0 (the taps 0..r-i, which the replicate border sends there),
    ``trail[d]`` what output n-1-d applies to pixel n-1, and ``total`` what
    the one output of a one-pixel axis applies to its pixel.  Each is the
    TPU operator's entry (``microaligner_tpu/optflow/farneback.py::
    _banded_smooth_matrix``): the float32 taps summed in float64, then
    rounded to float32 and to bf16."""
    return _bf16_operator(np.ascontiguousarray(taps, dtype=np.float32).tobytes())


@functools.lru_cache(maxsize=16)  # (2r+1) x n floats each: 8 MB at n = 20680, window 99
def _bf16_table(tap_bytes: bytes, n: int) -> torch.Tensor:
    """(2r+1, n) coefficients: entry [k, i] is what output i applies to the
    tap k reads, pixel clamp(i + k - r) (see :func:`bf16_operator`)."""
    taps, lead, trail, total = _bf16_operator(tap_bytes)
    r = (len(taps) - 1) // 2
    k = np.arange(2 * r + 1).reshape(-1, 1)
    i = np.arange(n).reshape(1, -1)
    j = i + k - r  # the pixel, before the clamp
    table = np.where((j >= 0) & (j < n), np.broadcast_to(taps.reshape(-1, 1), j.shape), 0.0)
    table = np.where(j == n - 1, trail[np.clip(n - 1 - i, 0, r)], table)
    table = np.where(j == 0, lead[np.clip(i, 0, r)], table)
    if n == 1:
        table = np.where(j == 0, total, table)
    return torch.from_numpy(table.astype(np.float32))


def tc_groups(n: int, winsize: int) -> tuple:
    """``(groups, gl, gt)`` of the bf16 entry's factor table for an axis of
    n pixels: the 32-output groups its blocks cover (4 a 128-output block)
    and the interior ones, [gl, gt), whose outputs lie at least r from both
    ends and so read one Toeplitz slice (gl = gt = groups where none does).
    Group g's slot is g below gl, gl inside, gl + 1 + g - gt above."""
    r = winsize // 2
    groups = -(-n // TC_BLOCK) * (TC_BLOCK // TC_GROUP)
    inner = [g for g in range(groups) if g * TC_GROUP >= r and g * TC_GROUP + TC_GROUP - 1 <= n - 1 - r]
    if not inner:
        return groups, groups, groups
    return groups, inner[0], inner[-1] + 1


@functools.lru_cache(maxsize=64)
def tc_factor_table(n: int, winsize: int) -> tuple:
    """The bf16 entry's operator for an axis of n pixels, as the B
    fragments of ``mma.m16n8k16`` in the order the lanes hold them:
    ``(table, gl, gt)``, table an int16 array (the bf16 bits) of shape
    (slots, steps, 2, 32, 8).  Slot q is the slot of one group g
    (:func:`tc_groups`), whose 32 outputs read sources from 32 g - R8 on:
    for k-step s, pair p and lane l, the 8 values are the registers b01 and
    b23 of n-tiles 2p and 2p + 1, b01 = (B[k, j], B[k + 1, j]) and b23 =
    (B[k + 8, j], B[k + 9, j]) with k = 16 s + 2 (l % 4), j = 8 t + l // 4
    and B[k, j] = D[32 g - R8 + k, 32 g + j], D[src, out] the coefficient
    output ``out`` applies to pixel ``src`` (:func:`_bf16_table`; 0 off the
    axis and the band).  Every entry of the operator's block slices
    (``_band_factors`` of the JAX package, in bf16) lies in some group's B,
    and nothing else does."""
    r = winsize // 2
    coeffs = _bf16_table(np.ascontiguousarray(agg_kernel(winsize), dtype=np.float32).tobytes(), n).numpy()
    groups, gl, gt = tc_groups(n, winsize)
    reps = list(range(gl)) + ([gl] if gl < gt else []) + list(range(gt, groups))
    steps = tc_steps(r)
    s = np.arange(steps).reshape(-1, 1, 1, 1)
    p = np.arange(2).reshape(1, -1, 1, 1)
    lane = np.arange(32).reshape(1, 1, -1, 1)
    e = np.arange(8).reshape(1, 1, 1, -1)
    reg = e // 2  # b01(2p), b23(2p), b01(2p + 1), b23(2p + 1); low half first
    k = 16 * s + 2 * (lane % 4) + e % 2 + 8 * (reg % 2)
    j = 8 * (2 * p + reg // 2) + lane // 4
    tap = k - j - tc_halo(r) + r  # the tap of output 32 g + j that reads source 32 g - R8 + k
    table = []
    for g in reps:
        out = TC_GROUP * g + j
        inside = (out < n) & (tap >= 0) & (tap <= 2 * r)
        table.append(np.where(inside, coeffs[np.clip(tap, 0, 2 * r), np.minimum(out, n - 1)], 0.0))
    table = np.stack(table).astype(np.float32)
    bits = torch.from_numpy(table).to(torch.bfloat16).view(torch.int16).numpy()
    return bits, gl, gt


@functools.lru_cache(maxsize=64)
def _tc_factors_on(n: int, winsize: int, device: torch.device) -> tuple:
    """:func:`tc_factor_table` on ``device``: ``(tensor, gl, gt)``."""
    bits, gl, gt = tc_factor_table(n, winsize)
    return torch.from_numpy(bits).to(device), gl, gt


def smooth_axis_plain(x: torch.Tensor, taps: np.ndarray, axis: int) -> torch.Tensor:
    """Replicate-border correlation of ``x`` with ``taps`` along ``axis``
    (-1 or -2): out[i] = sum_k taps[k] x[clamp(i + k - r)], summed in
    ascending k with a separate multiply and add per tap.

    A bfloat16 ``x`` takes the bf16 route: it is widened to float32 and each
    tap k of output i applies the bf16 coefficient of the TPU operator
    (:func:`bf16_operator`; a tap outside the axis applies 0 and the edge
    pixel's tap the folded sum); the products are exact and the float32 sums
    are returned unrounded."""
    r = (len(taps) - 1) // 2
    n = x.shape[axis]
    idx = torch.arange(-r, n + r, device=x.device).clamp(0, n - 1)
    if x.dtype == torch.bfloat16:
        table = _bf16_table(np.ascontiguousarray(taps, dtype=np.float32).tobytes(), n).to(x.device)
        if axis == -2:
            table = table.unsqueeze(-1)
        coeffs = list(table)
        x = x.float()
    else:
        coeffs = taps.tolist()
    xp = x.index_select(axis, idx)
    acc = None
    for k, wk in enumerate(coeffs):
        t = xp.narrow(axis, k, n) * wk
        if acc is None:
            acc = t
        else:
            acc += t  # in place: same rounding as acc + t
    return acc


def smooth5_solve_plain(M: torch.Tensor, winsize: int):
    """Plain PyTorch version of K3: (N, 5, H, W) -> (fx, fy), each (N, H, W).
    A bfloat16 M stores pass 1's sums in bf16 before pass 2 (the bf16
    route); the solve is float32."""
    smooth5_solve_plain.calls += 1
    taps = agg_kernel(winsize)
    pass1 = smooth_axis_plain(M, taps, -1)
    s = smooth_axis_plain(pass1.to(M.dtype), taps, -2)
    g11, g12, g22, h1, h2 = s.unbind(1)
    idet = 1.0 / (g11 * g22 - g12 * g12 + 1e-3)
    return (g11 * h2 - g12 * h1) * idet, (g22 * h1 - g12 * h2) * idet


smooth5_solve_plain.calls = 0


@functools.lru_cache(maxsize=None)
def _taps_host(winsize: int) -> torch.Tensor:
    """The taps as a CPU tensor: the float32 entry's C entry points copy
    them into the kernels' parameters."""
    return torch.from_numpy(agg_kernel(winsize))


def _check_cuda_window(name: str, winsize: int, planes: int, h: int, w: int, bf16: bool = False) -> int:
    r = winsize // 2
    if r > MAX_HALF_WINDOW:
        raise ValueError(f"{name}: winsize // 2 = {r} exceeds the kernel's limit {MAX_HALF_WINDOW}")
    if bf16:
        # agg_tc.cu's row pass: a grid of (W blocks, 64-row tiles, planes)
        cuda_lib.check_grid(name, planes, -(-h // TC_ROWS))
    # the float32 kernels number their tiles with an int; the row pass has the
    # most (its tiles start up to 3 columns left of the image)
    elif planes * -(-h // _TILE[0]) * -(-(w + 3) // _TILE[1]) >= 2**31:
        raise ValueError(f"{name}: {planes} planes of {h} x {w} are more tiles than an int counts")
    return r


def smooth_w_plain(x: torch.Tensor, winsize: int) -> torch.Tensor:
    """Plain PyTorch version of K3's row pass alone, stored in ``x``'s
    dtype (a bfloat16 ``x`` takes the bf16 route)."""
    smooth_w_plain.calls += 1
    return smooth_axis_plain(x, agg_kernel(winsize), -1).to(x.dtype)


smooth_w_plain.calls = 0


def smooth_w(x: torch.Tensor, winsize: int) -> torch.Tensor:
    """K3's row pass alone (``pallas_smooth_w``): (N, C, H, W) contiguous
    float32 or bfloat16 smoothed along W, in its dtype.  A CPU tensor takes
    the plain version; a CUDA tensor launches the row kernel or raises."""
    if x.dim() != 4 or x.dtype not in STORED_DTYPES or not x.is_contiguous():
        raise ValueError("smooth_w takes a contiguous float32 or bfloat16 (N, C, H, W) tensor")
    if winsize < 1:
        raise ValueError(f"smooth_w: winsize must be >= 1, got {winsize}")
    if x.device.type == "cpu":
        return smooth_w_plain(x, winsize)
    cuda_lib.require_cuda(x)
    n, c, h, w = x.shape
    bf16 = x.dtype == torch.bfloat16
    r = _check_cuda_window("smooth_w", winsize, n * c, h, w, bf16)
    out = torch.empty_like(x)
    if bf16:
        frag, gl, gt = _tc_factors_on(w, winsize, x.device)
        cuda_lib.call("ma_smooth_rows_tc", x.device, x, out, frag, gl, gt, n * c, h, w, r)
    else:
        cuda_lib.call("ma_smooth_rows", x.device, x, out, _taps_host(winsize), n * c, h, w, r)
    smooth_w.launches += 1
    return out


smooth_w.launches = 0


def smooth5_solve(M: torch.Tensor, winsize: int):
    """Window aggregation + solve: (N, 5, H, W) contiguous float32 or
    bfloat16 -> (fx, fy), float32; the entry is chosen by M's dtype.  A CPU
    tensor takes the plain version; a CUDA tensor launches K3 or raises."""
    if M.dim() != 4 or M.shape[1] != 5:
        raise ValueError(f"smooth5_solve takes (N, 5, H, W), got {tuple(M.shape)}")
    if M.dtype not in STORED_DTYPES or not M.is_contiguous():
        raise ValueError("smooth5_solve: M must be contiguous float32 or bfloat16")
    if winsize < 1:
        raise ValueError(f"smooth5_solve: winsize must be >= 1, got {winsize}")
    if M.device.type == "cpu":
        return smooth5_solve_plain(M, winsize)
    cuda_lib.require_cuda(M)
    n, _, h, w = M.shape
    bf16 = M.dtype == torch.bfloat16
    r = _check_cuda_window("smooth5_solve", winsize, 5 * n, h, w, bf16)
    scratch = torch.empty_like(M)
    fx = torch.empty((n, h, w), dtype=torch.float32, device=M.device)
    fy = torch.empty_like(fx)
    if bf16:
        cuda_lib.check_grid("smooth5_solve", n, -(-w // TC_COLS))  # (H blocks, 16-column strips, images)
        frag_w, gl_w, gt_w = _tc_factors_on(w, winsize, M.device)
        frag_h, gl_h, gt_h = _tc_factors_on(h, winsize, M.device)
        cuda_lib.call("ma_smooth5_solve_tc", M.device, M, scratch, fx, fy, frag_w, gl_w, gt_w,
                      frag_h, gl_h, gt_h, n, h, w, r)
    else:
        cuda_lib.call("ma_smooth5_solve", M.device, M, scratch, fx, fy, _taps_host(winsize), n, h, w, r)
    smooth5_solve.launches += 1
    smooth5_solve.bf16_launches += bf16
    return fx, fy


smooth5_solve.launches = 0
smooth5_solve.bf16_launches = 0  # the launches of the bfloat16 entry
