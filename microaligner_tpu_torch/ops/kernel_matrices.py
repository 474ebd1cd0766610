"""K4: the Farneback matrix update of iterations 2..n.

Replaces ``microaligner_tpu/ops/pallas_matrices.py::pallas_update_matrices``
(Pallas body ``_kernel``), reached from
``microaligner_tpu/optflow/farneback.py::_update_matrices_batched_cf``.

For every pixel p the five channels of R1 are sampled bilinearly at
p + (fx, fy)(p) and combined with R0(p) into M = [G11, G12, G22, h1, h2]
(``_combine_matrices_cf``): the sample counts only where the whole 2x2
stencil lies inside the image, and the outer 5 px are down-weighted.

On the H100 the kernel (``csrc/matrices.cu``) is bound by bytes: R0's five
planes, four taps of R1's five planes and the flow in, five planes out.  One
thread per pixel gathers its taps directly, so it is exact for any
displacement; the TPU kernel's band and the exact-gather fallback that
guarded it are gone.

Stored types (the JAX package's ``out_dtype`` and its bf16 R storage, which
Farneback's reduced-precision route selects): R0 and R1 are float32 or
bfloat16, both the same; every load is widened to float32 and the
arithmetic is the float32 one; M is stored in ``out_dtype`` (float32 or
bfloat16, rounded to nearest even).  One kernel template covers the four
pairs, and each equals its plain version bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from microaligner_tpu_torch.ops import cuda_lib
from microaligner_tpu_torch.ops.kernel_sample import bilinear_taps, split_displacement

__all__ = [
    "BORDER_SCALE",
    "STORED_DTYPES",
    "edge_scale_map",
    "inbounds_map",
    "combine_matrices",
    "zero_flow_matrices",
    "update_matrices",
    "update_matrices_plain",
]

STORED_DTYPES = (torch.float32, torch.bfloat16)

# OpenCV down-weights the displacement equations in the outer BORDER pixels
_BORDER = 5
BORDER_SCALE = np.array([0.14, 0.14, 0.4472, 0.4472, 0.4472], dtype=np.float32)


def edge_scale_map(h: int, w: int, device) -> torch.Tensor:
    """(H, W) per-pixel border down-weighting of the outer 5 px."""
    bs = torch.as_tensor(BORDER_SCALE, device=device)

    def edge_scale(i, size):
        lead = torch.where(i < _BORDER, bs[i.clamp(0, _BORDER - 1)], 1.0)
        trail = torch.where(
            i >= size - _BORDER, bs[(size - i - 1).clamp(0, _BORDER - 1)], 1.0
        )
        return lead * trail

    ix = torch.arange(w, device=device)
    iy = torch.arange(h, device=device)
    return edge_scale(ix, w).view(1, w) * edge_scale(iy, h).view(h, 1)


def inbounds_map(fx: torch.Tensor, fy: torch.Tensor) -> torch.Tensor:
    """OpenCV validity: the whole 2x2 stencil of p + flow(p) is inside."""
    h, w = fx.shape[-2:]
    ax, ay, _, _ = split_displacement(fx, fy)
    return (ax >= 0) & (ax < w - 1) & (ay >= 0) & (ay < h - 1)


def combine_matrices(R0, dx, dy, samp, inb, scale) -> torch.Tensor:
    """Normal equations M = [G11, G12, G22, h1, h2], (N, 5, H, W).

    ``R0``/``samp`` are (N, 5, H, W); ``dx``/``dy``/``inb`` are (N, H, W);
    ``scale`` is the (H, W) edge map.
    """
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
        [r4 * r4 + r6 * r6, (r4 + r5) * r6, r5 * r5 + r6 * r6, r4 * r2 + r6 * r3,
         r6 * r2 + r5 * r3],
        dim=1,
    )


def zero_flow_matrices(R0, R1, out_dtype=torch.float32) -> torch.Tensor:
    """M of the first iteration from (N, 5, H, W) expansions (float32 or
    bfloat16, combined in float32), stored as ``out_dtype``: at zero flow R1
    is sampled at p itself, and the 2x2 stencil is inside except on the last
    row and column."""
    n, _, h, w = R0.shape
    zero = R0.new_zeros((n, h, w), dtype=torch.float32)
    ix = torch.arange(w, device=R0.device).view(1, w)
    iy = torch.arange(h, device=R0.device).view(h, 1)
    inb = ((ix < w - 1) & (iy < h - 1)).expand(n, h, w)
    m = combine_matrices(R0.float(), zero, zero, R1.float(), inb, edge_scale_map(h, w, R0.device))
    return m.to(out_dtype)


def update_matrices_plain(R0, R1, fx, fy, out_dtype=torch.float32) -> torch.Tensor:
    """Plain PyTorch version of K4: (N, 5, H, W) expansions (float32 or
    bfloat16, widened to float32), (N, H, W) flow; M stored as ``out_dtype``."""
    update_matrices_plain.calls += 1
    n, c, h, w = R0.shape
    x0, y0, tx, ty = split_displacement(fx, fy)
    inb = (x0 >= 0) & (x0 < w - 1) & (y0 >= 0) & (y0 < h - 1)
    samp = bilinear_taps(
        R1.float().reshape(n, c, h * w), x0.unsqueeze(1).expand(n, c, h, w),
        y0.unsqueeze(1).expand(n, c, h, w), tx.unsqueeze(1), ty.unsqueeze(1), h, w,
    )
    m = combine_matrices(R0.float(), fx, fy, samp, inb, edge_scale_map(h, w, R0.device))
    return m.to(out_dtype)


update_matrices_plain.calls = 0


def update_matrices(R0, R1, fx, fy, out_dtype=torch.float32) -> torch.Tensor:
    """M, stored as ``out_dtype``, from the expansions R0, R1 (N, 5, H, W;
    both float32 or both bfloat16) and the float32 flow (N, H, W), all
    contiguous on one device.  A CPU tensor takes the plain version; a CUDA
    tensor launches K4 or raises."""
    if R0.dim() != 4 or R0.shape[1] != 5 or R1.shape != R0.shape:
        raise ValueError(f"update_matrices: R0/R1 must be (N, 5, H, W), got "
                         f"{tuple(R0.shape)} and {tuple(R1.shape)}")
    if R0.dtype not in STORED_DTYPES or R1.dtype != R0.dtype or out_dtype not in STORED_DTYPES:
        raise ValueError(f"update_matrices: R0, R1 and out_dtype must each be float32 or bfloat16, R0 and R1 "
                         f"the same; got {R0.dtype}, {R1.dtype} and {out_dtype}")
    fshape = (R0.shape[0],) + tuple(R0.shape[2:])
    for name, t in (("R0", R0), ("R1", R1), ("fx", fx), ("fy", fy)):
        if not t.is_contiguous() or t.device != R0.device:
            raise ValueError(f"update_matrices: {name} must be contiguous on R0's device")
    if fx.dtype != torch.float32 or fy.dtype != torch.float32:
        raise ValueError("update_matrices: the flow must be float32")
    if tuple(fx.shape) != fshape or tuple(fy.shape) != fshape:
        raise ValueError(f"update_matrices: flow must be {fshape}, got {tuple(fx.shape)}")
    if R0.device.type == "cpu":
        return update_matrices_plain(R0, R1, fx, fy, out_dtype)
    cuda_lib.require_cuda(R0, R1, fx, fy)
    n, _, h, w = R0.shape
    cuda_lib.check_grid("update_matrices", n, -(-h // 8))  # 32 x 8 threads a block
    out = torch.empty(R0.shape, dtype=out_dtype, device=R0.device)
    cuda_lib.call("ma_update_matrices", R0.device, R0, R1, fx, fy, out, n, h, w,
                  int(R0.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16))
    update_matrices.launches += 1
    if torch.bfloat16 in (R0.dtype, out_dtype):
        update_matrices.bf16_launches += 1
    return out


update_matrices.launches = 0
update_matrices.bf16_launches = 0  # the launches that read R or stored M in bfloat16
