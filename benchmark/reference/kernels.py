"""Plain versions of the Farneback kernels K2, K3 and K4.

Frozen copy of the port's ``poly_pair_m_plain`` (``ops/kernel_poly.py``),
``update_matrices_plain`` and its helpers (``ops/kernel_matrices.py``) and
``smooth5_solve_plain`` with the bf16 route's operator
(``ops/kernel_agg.py``).  Each tap is one multiply and one add, in
ascending tap order; the port's kernels fuse them, so their sums differ in
the last bits.

:class:`FlowPrecision` is the route: the float32 route (the port's
default), the bf16 route (``MICROALIGNER_TPU_AGG_PRECISION=default``: R and
M stored in bf16, or M alone under ``MICROALIGNER_TPU_R_BF16=0``; K3's
coefficients and its row pass's sums stored as M is, float32 arithmetic
between), or a control one precision below either: TF32 operands in the
expansion's and the aggregation's products, or fp8 e4m3's significand
where the bf16 route stores bf16.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from benchmark.reference.filters import round_mantissa
from benchmark.reference.warps import bilinear_taps, split_displacement

# OpenCV down-weights the displacement equations in the outer BORDER pixels
_BORDER = 5
BORDER_SCALE = np.array([0.14, 0.14, 0.4472, 0.4472, 0.4472], dtype=np.float32)


@dataclass(frozen=True)
class FlowPrecision:
    """``ops_bits``: the significand of the expansion's and the window
    aggregation's operands (the image, M and the taps; None: float32, 10:
    TF32).  ``r_bits``, ``m_bits``: the significand R and M are stored with
    (None: float32, 7: bf16, 3: fp8 e4m3's); K3's coefficients and its row
    pass are stored as M is."""

    ops_bits: int | None = None
    r_bits: int | None = None
    m_bits: int | None = None


def _rounder(bits):
    if bits is None:
        return lambda x: x
    return lambda x: round_mantissa(x, bits)


def _f32(v: float, bits=None) -> float:
    t = torch.tensor(v, dtype=torch.float32)
    return float(t if bits is None else round_mantissa(t, bits))


def poly_exp5(sp: torch.Tensor, coeffs: tuple, bits=None) -> torch.Tensor:
    """(..., H+2, W+2) replicate-padded image -> (..., 5, H, W) expansion,
    taps summed vertical first, then horizontal."""
    g0, g1, xg1, xxg1, ig11, ig03, ig33, ig55 = (_f32(c) for c in coeffs)
    rg0, rg1, rxg1, rxxg1 = (_f32(c, bits) for c in (g0, g1, xg1, xxg1))
    sp = _rounder(bits)(sp)
    h, w = sp.shape[-2] - 2, sp.shape[-1] - 2
    up, mid, dn = sp[..., 0:h, :], sp[..., 1 : h + 1, :], sp[..., 2 : h + 2, :]
    row0 = up * rg0 + mid * rg1 + dn * rg0
    row1 = up * -rxg1 + dn * rxg1
    row2 = up * rxxg1 + dn * rxxg1
    rnd = _rounder(bits)
    row0, row1, row2 = rnd(row0), rnd(row1), rnd(row2)

    def g(r):
        return r[..., 0:w] * rg0 + r[..., 1 : w + 1] * rg1 + r[..., 2 : w + 2] * rg0

    def xg(r):
        return r[..., 0:w] * -rxg1 + r[..., 2 : w + 2] * rxg1

    b1, b2 = g(row0), xg(row0)
    b4 = row0[..., 0:w] * rxxg1 + row0[..., 2 : w + 2] * rxxg1
    b3, b6 = g(row1), xg(row1)
    b5 = g(row2)
    return torch.stack(
        [b3 * ig11, b2 * ig11, b5 * ig33 + b1 * ig03, b4 * ig33 + b1 * ig03, b6 * ig55],
        dim=-3,
    )


def edge_scale_map(h: int, w: int, device) -> torch.Tensor:
    """(H, W) per-pixel border down-weighting of the outer 5 px."""
    bs = torch.as_tensor(BORDER_SCALE, device=device)

    def edge_scale(i, size):
        lead = torch.where(i < _BORDER, bs[i.clamp(0, _BORDER - 1)], 1.0)
        trail = torch.where(i >= size - _BORDER, bs[(size - i - 1).clamp(0, _BORDER - 1)], 1.0)
        return lead * trail

    ix = torch.arange(w, device=device)
    iy = torch.arange(h, device=device)
    return edge_scale(ix, w).view(1, w) * edge_scale(iy, h).view(h, 1)


def combine_matrices(R0, dx, dy, samp, inb, scale) -> torch.Tensor:
    """Normal equations M = [G11, G12, G22, h1, h2], (N, 5, H, W)."""
    r2 = torch.where(inb, samp[:, 0], 0.0)
    r3 = torch.where(inb, samp[:, 1], 0.0)
    r4 = torch.where(inb, (R0[:, 2] + samp[:, 2]) * 0.5, R0[:, 2])
    r5 = torch.where(inb, (R0[:, 3] + samp[:, 3]) * 0.5, R0[:, 3])
    r6 = torch.where(inb, (R0[:, 4] + samp[:, 4]) * 0.25, R0[:, 4] * 0.5)

    r2 = (R0[:, 0] - r2) * 0.5
    r3 = (R0[:, 1] - r3) * 0.5
    r2 = r2 + r4 * dy + r6 * dx
    r3 = r3 + r6 * dy + r5 * dx

    r2 = r2 * scale
    r3 = r3 * scale
    r4 = r4 * scale
    r5 = r5 * scale
    r6 = r6 * scale
    return torch.stack(
        [r4 * r4 + r6 * r6, (r4 + r5) * r6, r5 * r5 + r6 * r6, r4 * r2 + r6 * r3, r6 * r2 + r5 * r3],
        dim=1,
    )


def zero_flow_matrices(R0, R1) -> torch.Tensor:
    """M of the first iteration: R1 sampled at p itself, the 2x2 stencil
    inside except on the last row and column."""
    n, _, h, w = R0.shape
    zero = R0.new_zeros((n, h, w), dtype=torch.float32)
    ix = torch.arange(w, device=R0.device).view(1, w)
    iy = torch.arange(h, device=R0.device).view(h, 1)
    inb = ((ix < w - 1) & (iy < h - 1)).expand(n, h, w)
    return combine_matrices(R0, zero, zero, R1, inb, edge_scale_map(h, w, R0.device))


def poly_pair_m(sp0: torch.Tensor, sp1: torch.Tensor, coeffs: tuple, prec: FlowPrecision = FlowPrecision()):
    """(R0, R1, M0) of two padded images, each (N, 5, H, W), M0 combined
    from the expansions before they are stored."""
    r0 = poly_exp5(sp0, coeffs, prec.ops_bits)
    r1 = poly_exp5(sp1, coeffs, prec.ops_bits)
    store_r = _rounder(prec.r_bits)
    return store_r(r0), store_r(r1), _rounder(prec.m_bits)(zero_flow_matrices(r0, r1))


def update_matrices(R0, R1, fx, fy, prec: FlowPrecision = FlowPrecision()) -> torch.Tensor:
    """M at the flow (fx, fy): R1 resampled at p + flow and recombined,
    stored as ``prec`` stores M."""
    n, c, h, w = R0.shape
    x0, y0, tx, ty = split_displacement(fx, fy)
    inb = (x0 >= 0) & (x0 < w - 1) & (y0 >= 0) & (y0 < h - 1)
    samp = bilinear_taps(
        R1.reshape(n, c, h * w), x0.unsqueeze(1).expand(n, c, h, w),
        y0.unsqueeze(1).expand(n, c, h, w), tx.unsqueeze(1), ty.unsqueeze(1), h, w,
    )
    return _rounder(prec.m_bits)(combine_matrices(R0, fx, fy, samp, inb, edge_scale_map(h, w, R0.device)))


@functools.lru_cache(maxsize=None)
def agg_kernel(winsize: int) -> np.ndarray:
    """Gaussian aggregation kernel of FarnebackUpdateFlow_GaussianBlur:
    length 2*(winsize//2)+1, sigma = (winsize//2)*0.3, normalized."""
    m = winsize // 2
    i = np.arange(-m, m + 1, dtype=np.float64)
    k = np.exp(-(i**2) / (2.0 * (m * 0.3) ** 2))
    k /= k.sum()
    return k.astype(np.float32)


def _stored(values, bits: int) -> np.ndarray:
    """float64 values rounded to float32, then to a ``bits``-bit
    significand, as float32."""
    return round_mantissa(torch.from_numpy(np.asarray(values, dtype=np.float64).astype(np.float32)), bits).numpy()


@functools.lru_cache(maxsize=16)
def stored_table(tap_bytes: bytes, n: int, bits: int) -> torch.Tensor:
    """(2r+1, n) coefficients of the bf16 route's operator, stored with a
    ``bits``-bit significand: entry [k, i] is what output i applies to the
    pixel tap k reads, clamp(i + k - r); a tap outside the axis applies 0,
    and the edge pixel's tap the sum of the taps the replicate border sends
    there (summed in float64, ascending)."""
    taps = np.frombuffer(tap_bytes, dtype=np.float32)
    r = (len(taps) - 1) // 2
    k64 = taps.astype(np.float64)
    lead = _stored(np.cumsum(k64)[r::-1], bits)
    trail = _stored([np.cumsum(k64[r + d :])[-1] for d in range(r + 1)], bits)
    total = float(_stored(np.cumsum(k64)[-1:], bits)[0])
    k = np.arange(2 * r + 1).reshape(-1, 1)
    i = np.arange(n).reshape(1, -1)
    j = i + k - r  # the pixel, before the clamp
    table = np.where((j >= 0) & (j < n), np.broadcast_to(_stored(taps, bits).reshape(-1, 1), j.shape), 0.0)
    table = np.where(j == n - 1, trail[np.clip(n - 1 - i, 0, r)], table)
    table = np.where(j == 0, lead[np.clip(i, 0, r)], table)
    if n == 1:
        table = np.where(j == 0, total, table)
    return torch.from_numpy(table.astype(np.float32))


def smooth_axis(x: torch.Tensor, taps, axis: int, coeffs=None) -> torch.Tensor:
    """Replicate-border correlation of ``x`` with ``taps`` along ``axis``:
    out[i] = sum_k taps[k] x[clamp(i + k - r)], in ascending k; with
    ``coeffs`` (a :func:`stored_table`), tap k of output i applies
    ``coeffs[k, i]`` instead."""
    r = (len(taps) - 1) // 2
    n = x.shape[axis]
    idx = torch.arange(-r, n + r, device=x.device).clamp(0, n - 1)
    if coeffs is not None:
        taps = list(coeffs.to(x.device).unsqueeze(-1) if axis == -2 else coeffs.to(x.device))
    xp = x.index_select(axis, idx)
    acc = None
    for k, wk in enumerate(taps):
        t = xp.narrow(axis, k, n) * wk
        if acc is None:
            acc = t
        else:
            acc += t
    return acc


def smooth5_solve(M: torch.Tensor, winsize: int, prec: FlowPrecision = FlowPrecision()):
    """Window aggregation of (N, 5, H, W) M and the regularised 2x2 solve ->
    (fx, fy), each (N, H, W).  Where M is stored below float32, the
    operator's coefficients are too and pass 1's sums are stored as M is
    before pass 2; the sums and the solve are float32."""
    taps = agg_kernel(winsize)
    if prec.m_bits is not None:
        tap_bytes = np.ascontiguousarray(taps).tobytes()
        store = _rounder(prec.m_bits)
        pass1 = smooth_axis(M, taps, -1, stored_table(tap_bytes, M.shape[-1], prec.m_bits))
        s = smooth_axis(store(pass1), taps, -2, stored_table(tap_bytes, M.shape[-2], prec.m_bits))
    else:
        rnd = _rounder(prec.ops_bits)
        if prec.ops_bits is not None:
            taps = round_mantissa(torch.from_numpy(taps), prec.ops_bits).numpy()
        taps = taps.tolist()
        pass1 = smooth_axis(rnd(M), taps, -1)
        s = smooth_axis(rnd(pass1), taps, -2)
    g11, g12, g22, h1, h2 = s.unbind(1)
    idet = 1.0 / (g11 * g22 - g12 * g12 + 1e-3)
    return (g11 * h2 - g12 * h1) * idet, (g22 * h1 - g12 * h2) * idet
