"""K2: polynomial expansion of an image pair plus the zero-flow equations,
and K6, the expansion of one image.

Replaces ``microaligner_tpu/ops/pallas_poly.py::pallas_poly_pair_m`` (Pallas
body ``_pair_kernel``, moments in ``_moments5``), which starts every
Farneback call (``optflow/farneback.py::_farneback_core_parts``).

Inputs are the two pre-smoothed images, each padded by one replicated pixel:
(N, H+2, W+2) f32.  Outputs are R0 and R1, each image's expansion
[b_y, b_x, A_yy, A_xx, A_xy] from the 3-tap g/xg/xxg moments (poly_n = 1),
and M0, the first iteration's normal equations [G11, G12, G22, h1, h2] at
zero flow; all three are (N, 5, H, W), R0 and R1 stored as ``r_dtype`` and
M0 as ``m_dtype`` (float32 by default; bfloat16 on Farneback's
reduced-precision route, as the TPU kernel's ``r_dtype`` and ``m_dtype``).
The expansion and the combine run in float32; M0 is combined from the
values before they are rounded, and the rounding is to nearest even.

On the H100 the kernel (``csrc/poly.cu``) is bound by bytes: two planes in,
fifteen out, about forty flops a pixel.  A thread owns 4 consecutive pixels
of a plane's flat index: where they lie in one row it computes the vertical
taps of their windows' 6 columns once, in both images, and writes each of
the fifteen output planes with one packed store (8 bytes of bf16, 16 of
float32) where H * W is a multiple of 4; a group across a row end computes
each pixel from its own (y, x).  The expansion is never re-read from device
memory to build M0, and the arithmetic runs in the plain version's order.

K6 (:func:`poly_exp5`, ``csrc/poly.cu``) replaces
``microaligner_tpu/ops/pallas_poly.py::pallas_poly_exp5`` (Pallas body
``_kernel``): the expansion of one (N, H+2, W+2) padded image into
(N, 5, H, W), no M0.  It runs only on Farneback's unpaired route
(``optflow/farneback.py::_poly_exp_batched``).  It is bound by bytes (one
plane in, five out) and calls the same ``moments5`` device function as K2,
so its output equals K2's R0 and R1, and :func:`poly_exp5_plain`, bit for
bit.
"""

from __future__ import annotations

import torch

from microaligner_tpu_torch.ops import cuda_lib
from microaligner_tpu_torch.ops.kernel_matrices import STORED_DTYPES, zero_flow_matrices

__all__ = ["poly_pair_m", "poly_pair_m_plain", "poly_exp5", "poly_exp5_plain"]


def _f32(v: float) -> float:
    """``v`` rounded to float32, as the TPU kernel and the kernel here use it."""
    return float(torch.tensor(v, dtype=torch.float32))


def poly_exp5_plain(sp: torch.Tensor, coeffs: tuple) -> torch.Tensor:
    """(..., H+2, W+2) replicate-padded image -> (..., 5, H, W) expansion;
    the plain version of K6, and half of K2's.

    ``coeffs`` is ``(g0, g1, xg1, xxg1, ig11, ig03, ig33, ig55)``
    (optflow/farneback.py::_poly_coeff_tuple).  Taps are summed vertical
    first, then horizontal, in the order of the reference
    ``_poly_exp_cf`` (zero taps skipped).
    """
    poly_exp5_plain.calls += 1
    g0, g1, xg1, xxg1, ig11, ig03, ig33, ig55 = (_f32(c) for c in coeffs)
    h, w = sp.shape[-2] - 2, sp.shape[-1] - 2
    up, mid, dn = sp[..., 0:h, :], sp[..., 1 : h + 1, :], sp[..., 2 : h + 2, :]
    row0 = up * g0 + mid * g1 + dn * g0
    row1 = up * -xg1 + dn * xg1
    row2 = up * xxg1 + dn * xxg1

    def g(r):
        return r[..., 0:w] * g0 + r[..., 1 : w + 1] * g1 + r[..., 2 : w + 2] * g0

    def xg(r):
        return r[..., 0:w] * -xg1 + r[..., 2 : w + 2] * xg1

    b1, b2 = g(row0), xg(row0)
    b4 = row0[..., 0:w] * xxg1 + row0[..., 2 : w + 2] * xxg1
    b3, b6 = g(row1), xg(row1)
    b5 = g(row2)
    return torch.stack(
        [b3 * ig11, b2 * ig11, b5 * ig33 + b1 * ig03, b4 * ig33 + b1 * ig03, b6 * ig55],
        dim=-3,
    )


poly_exp5_plain.calls = 0


def _check_padded(name: str, t: torch.Tensor, device) -> None:
    if t.dtype != torch.float32 or not t.is_contiguous() or t.device != device:
        raise ValueError(f"{name} must be contiguous float32 on one device")


def _check_coeffs(name: str, coeffs: tuple) -> None:
    if len(coeffs) != 8:
        raise ValueError(f"{name}: coeffs is (g0, g1, xg1, xxg1, ig11, ig03, ig33, ig55)")


def poly_exp5(sp: torch.Tensor, coeffs: tuple) -> torch.Tensor:
    """Expansion (N, 5, H, W) of a pre-smoothed, padded (N, H+2, W+2)
    float32 image.  A CPU tensor takes the plain version; a CUDA tensor
    launches K6 or raises."""
    if sp.dim() != 3 or sp.shape[1] < 3 or sp.shape[2] < 3:
        raise ValueError(f"poly_exp5 takes an (N, H+2, W+2) tensor, got {tuple(sp.shape)}")
    _check_padded("poly_exp5: sp", sp, sp.device)
    _check_coeffs("poly_exp5", coeffs)
    if sp.device.type == "cpu":
        return poly_exp5_plain(sp, coeffs)
    cuda_lib.require_cuda(sp)
    n, h, w = sp.shape[0], sp.shape[1] - 2, sp.shape[2] - 2
    cuda_lib.check_grid("poly_exp5", n, -(-h // 8))  # 32 x 8 threads a block
    r = torch.empty((n, 5, h, w), dtype=torch.float32, device=sp.device)
    cuda_lib.call("ma_poly_exp5", sp.device, sp, r, n, h, w, *(_f32(c) for c in coeffs))
    poly_exp5.launches += 1
    return r


poly_exp5.launches = 0


def poly_pair_m_plain(sp0: torch.Tensor, sp1: torch.Tensor, coeffs: tuple,
                      r_dtype=torch.float32, m_dtype=torch.float32):
    """Plain PyTorch version of K2: (R0, R1, M0), each (N, 5, H, W), M0
    combined from the float32 expansions before they are stored as
    ``r_dtype``."""
    poly_pair_m_plain.calls += 1
    r0 = poly_exp5_plain(sp0, coeffs)
    r1 = poly_exp5_plain(sp1, coeffs)
    return r0.to(r_dtype), r1.to(r_dtype), zero_flow_matrices(r0, r1, m_dtype)


poly_pair_m_plain.calls = 0


def poly_pair_m(sp0: torch.Tensor, sp1: torch.Tensor, coeffs: tuple,
                r_dtype=torch.float32, m_dtype=torch.float32):
    """Expansions R0, R1 (stored as ``r_dtype``) of a pre-smoothed, padded
    pair and the zero-flow equations M0 (``m_dtype``); each dtype is float32
    or bfloat16.  ``sp0``/``sp1`` are (N, H+2, W+2) float32 on one device;
    a CPU tensor takes the plain version, a CUDA tensor launches K2 or raises.
    """
    if sp0.dim() != 3 or sp0.shape != sp1.shape or sp0.shape[1] < 3 or sp0.shape[2] < 3:
        raise ValueError(
            f"poly_pair_m takes two (N, H+2, W+2) tensors of one shape, "
            f"got {tuple(sp0.shape)} and {tuple(sp1.shape)}"
        )
    for name, t in (("sp0", sp0), ("sp1", sp1)):
        _check_padded(f"poly_pair_m: {name}", t, sp0.device)
    _check_coeffs("poly_pair_m", coeffs)
    if r_dtype not in STORED_DTYPES or m_dtype not in STORED_DTYPES:
        raise ValueError(f"poly_pair_m: r_dtype and m_dtype must be float32 or bfloat16, got {r_dtype}, {m_dtype}")
    if sp0.device.type == "cpu":
        return poly_pair_m_plain(sp0, sp1, coeffs, r_dtype, m_dtype)
    cuda_lib.require_cuda(sp0, sp1)
    n, h, w = sp0.shape[0], sp0.shape[1] - 2, sp0.shape[2] - 2
    cuda_lib.check_grid("poly_pair_m", 1, n)  # one grid row an image, 1,024 pixels a block
    if h * w >= 2**31 - 4:
        raise ValueError(f"poly_pair_m: a plane of {h} x {w} has more pixels than the kernel's int counts")
    r0, r1, m0 = (torch.empty((n, 5, h, w), dtype=dt, device=sp0.device)
                  for dt in (r_dtype, r_dtype, m_dtype))
    cuda_lib.call("ma_poly_pair_m", sp0.device, sp0, sp1, r0, r1, m0, n, h, w,
                  *(_f32(c) for c in coeffs), int(r_dtype == torch.bfloat16), int(m_dtype == torch.bfloat16))
    poly_pair_m.launches += 1
    if torch.bfloat16 in (r_dtype, m_dtype):
        poly_pair_m.bf16_launches += 1
    return r0, r1, m0


poly_pair_m.launches = 0
poly_pair_m.bf16_launches = 0  # the launches that stored R or M0 in bfloat16
