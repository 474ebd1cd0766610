"""K2: polynomial expansion of an image pair plus the zero-flow equations.

Replaces ``microaligner_tpu/ops/pallas_poly.py::pallas_poly_pair_m`` (Pallas
body ``_pair_kernel``, moments in ``_moments5``), which starts every
Farneback call (``optflow/farneback.py::_farneback_core_parts``).

Inputs are the two pre-smoothed images, each padded by one replicated pixel:
(N, H+2, W+2) f32.  Outputs are R0 and R1, each image's expansion
[b_y, b_x, A_yy, A_xx, A_xy] from the 3-tap g/xg/xxg moments (poly_n = 1),
and M0, the first iteration's normal equations [G11, G12, G22, h1, h2] at
zero flow; all three are (N, 5, H, W) f32.

On the H100 the kernel (``csrc/poly.cu``) is bound by bytes: two planes in,
fifteen out, about forty flops a pixel.  One thread per pixel reads its 3x3
window of both images (neighbours share rows through L1) and writes all
fifteen outputs, so the expansion is never re-read from device memory to
build M0.
"""

from __future__ import annotations

import torch

from microaligner_tpu_torch.ops import cuda_lib
from microaligner_tpu_torch.ops.kernel_matrices import zero_flow_matrices

__all__ = ["poly_pair_m", "poly_pair_m_plain", "poly_exp5_plain"]


def _f32(v: float) -> float:
    """``v`` rounded to float32, as the TPU kernel and the kernel here use it."""
    return float(torch.tensor(v, dtype=torch.float32))


def poly_exp5_plain(sp: torch.Tensor, coeffs: tuple) -> torch.Tensor:
    """(..., H+2, W+2) replicate-padded image -> (..., 5, H, W) expansion.

    ``coeffs`` is ``(g0, g1, xg1, xxg1, ig11, ig03, ig33, ig55)``
    (optflow/farneback.py::_poly_coeff_tuple).  Taps are summed vertical
    first, then horizontal, in the order of the reference
    ``_poly_exp_cf`` (zero taps skipped).
    """
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


def poly_pair_m_plain(sp0: torch.Tensor, sp1: torch.Tensor, coeffs: tuple):
    """Plain PyTorch version of K2: (R0, R1, M0), each (N, 5, H, W)."""
    poly_pair_m_plain.calls += 1
    r0 = poly_exp5_plain(sp0, coeffs)
    r1 = poly_exp5_plain(sp1, coeffs)
    return r0, r1, zero_flow_matrices(r0, r1)


poly_pair_m_plain.calls = 0


def poly_pair_m(sp0: torch.Tensor, sp1: torch.Tensor, coeffs: tuple):
    """Expansions R0, R1 of a pre-smoothed, padded pair and the zero-flow
    equations M0.  ``sp0``/``sp1`` are (N, H+2, W+2) float32 on one device;
    a CPU tensor takes the plain version, a CUDA tensor launches K2 or raises.
    """
    if sp0.dim() != 3 or sp0.shape != sp1.shape or sp0.shape[1] < 3 or sp0.shape[2] < 3:
        raise ValueError(
            f"poly_pair_m takes two (N, H+2, W+2) tensors of one shape, "
            f"got {tuple(sp0.shape)} and {tuple(sp1.shape)}"
        )
    for name, t in (("sp0", sp0), ("sp1", sp1)):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != sp0.device:
            raise ValueError(f"poly_pair_m: {name} must be contiguous float32 on one device")
    if len(coeffs) != 8:
        raise ValueError("poly_pair_m: coeffs is (g0, g1, xg1, xxg1, ig11, ig03, ig33, ig55)")
    if sp0.device.type == "cpu":
        return poly_pair_m_plain(sp0, sp1, coeffs)
    cuda_lib.require_cuda(sp0, sp1)
    n, h, w = sp0.shape[0], sp0.shape[1] - 2, sp0.shape[2] - 2
    cuda_lib.check_grid("poly_pair_m", n, -(-h // 8))  # 32 x 8 threads a block
    r0, r1, m0 = (torch.empty((n, 5, h, w), dtype=torch.float32, device=sp0.device)
                  for _ in range(3))
    cuda_lib.call("ma_poly_pair_m", sp0.device, sp0, sp1, r0, r1, m0, n, h, w,
                  *(_f32(c) for c in coeffs))
    poly_pair_m.launches += 1
    return r0, r1, m0


poly_pair_m.launches = 0
