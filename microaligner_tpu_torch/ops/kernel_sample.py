"""K1: bilinear displacement sampling, ``out(p) = img(p + (fx, fy)(p))``,
and K5, the same for N planes that share one displacement field.

Replaces ``microaligner_tpu/ops/pallas_sample.py::pallas_sample_displaced``
(Pallas body ``_kernel_batched``), which every per-level warp, the Warper,
the tiled flow composition and the per-plane apply go through.

Taps outside the image read zero (``cv.remap`` with BORDER_CONSTANT).  The
displacement is split into ``floor`` and fraction before it is added to the
pixel position, so the weights stay exact at 20k widths, where an absolute
f32 coordinate would keep only 2**-9 px.

On the H100 the kernel (``csrc/sample.cu``) is bound by bytes: it reads fx,
fy and four taps and writes one f32 per pixel.  One thread per pixel gathers
its taps directly, so it is exact for any displacement and needs none of the
TPU kernel's band of shifted views or its exact-gather fallback.

K5 (:func:`sample_displaced_multi`, ``csrc/sample.cu``) replaces
``microaligner_tpu/ops/pallas_sample.py::pallas_sample_displaced_multi``, the
z-stack apply: every plane of a cycle pulled by the cycle's one flow.  Its
thread reads the flow and computes the taps' offsets and weights once, then
gathers from every plane; each plane equals a K1 launch on it bit for bit.
"""

from __future__ import annotations

import torch

from microaligner_tpu_torch.ops import cuda_lib

__all__ = [
    "sample_displaced",
    "sample_displaced_plain",
    "sample_displaced_multi",
    "sample_displaced_multi_plain",
    "bilinear_taps",
]

_IDX_LIMIT = 2**30  # floor(displacement) is clamped to this before indexing


def bilinear_taps(flat: torch.Tensor, x0: torch.Tensor, y0: torch.Tensor,
                  tx: torch.Tensor, ty: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Blend the four taps of ``flat`` (..., h*w) at integer corners
    (y0, x0) with fractions (tx, ty); taps outside the image read 0.

    ``x0``/``y0``/``tx``/``ty`` have the output's shape (..., H, W), whose
    leading dims match ``flat``'s.
    """
    lead = flat.shape[:-1]

    def tap(yy, xx):
        valid = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        idx = (yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)).reshape(*lead, -1)
        v = torch.gather(flat, -1, idx).reshape(x0.shape)
        return torch.where(valid, v, 0.0)

    ux = 1 - tx
    uy = 1 - ty
    out = tap(y0, x0) * ux * uy
    out = out + tap(y0, x0 + 1) * tx * uy
    out = out + tap(y0 + 1, x0) * ux * ty
    out = out + tap(y0 + 1, x0 + 1) * tx * ty
    return out


def split_displacement(fx: torch.Tensor, fy: torch.Tensor):
    """Integer corners (absolute, int64) and fractions of p + (fx, fy)."""
    h, w = fx.shape[-2:]
    x1 = torch.floor(fx)
    y1 = torch.floor(fy)
    tx = fx - x1
    ty = fy - y1
    gx = torch.arange(w, device=fx.device).view(1, w)
    gy = torch.arange(h, device=fx.device).view(h, 1)
    x0 = gx + x1.clamp(-_IDX_LIMIT, _IDX_LIMIT).to(torch.int64)
    y0 = gy + y1.clamp(-_IDX_LIMIT, _IDX_LIMIT).to(torch.int64)
    return x0, y0, tx, ty


def sample_displaced_plain(img: torch.Tensor, fx: torch.Tensor, fy: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K1: (N, H, W) f32 image and displacements."""
    sample_displaced_plain.calls += 1
    n, h, w = img.shape
    x0, y0, tx, ty = split_displacement(fx, fy)
    return bilinear_taps(img.reshape(n, h * w), x0, y0, tx, ty, h, w)


sample_displaced_plain.calls = 0


def _check(img, fx, fy):
    if img.dim() != 3:
        raise ValueError(f"sample_displaced takes (N, H, W) tensors, got {tuple(img.shape)}")
    for name, t in (("img", img), ("fx", fx), ("fy", fy)):
        if t.dtype != torch.float32:
            raise TypeError(f"sample_displaced: {name} must be float32, got {t.dtype}")
        if t.shape != img.shape:
            raise ValueError(
                f"sample_displaced: {name} shape {tuple(t.shape)} != {tuple(img.shape)}"
            )
        if t.device != img.device:
            raise ValueError(f"sample_displaced: {name} on {t.device}, img on {img.device}")
        if not t.is_contiguous():
            raise ValueError(f"sample_displaced: {name} must be contiguous")


def sample_displaced(img: torch.Tensor, fx: torch.Tensor, fy: torch.Tensor) -> torch.Tensor:
    """Batched ``out(p) = bilinear img(p + (fx, fy)(p))``, zero outside.

    ``img``, ``fx``, ``fy`` are (N, H, W) float32 on one device.  A CPU
    tensor takes the plain version; a CUDA tensor launches K1 or raises.
    """
    _check(img, fx, fy)
    if img.device.type == "cpu":
        return sample_displaced_plain(img, fx, fy)
    cuda_lib.require_cuda(img, fx, fy)
    n, h, w = img.shape
    cuda_lib.check_grid("sample_displaced", n, -(-h // 8))  # 32 x 8 threads a block
    out = torch.empty_like(img)
    cuda_lib.call("ma_sample_displaced", img.device, img, fx, fy, out, n, h, w)
    sample_displaced.launches += 1
    return out


sample_displaced.launches = 0


def sample_displaced_multi_plain(imgs: torch.Tensor, fx: torch.Tensor, fy: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K5: (N, H, W) f32 planes, (H, W) f32
    displacements shared by every plane."""
    sample_displaced_multi_plain.calls += 1
    n, h, w = imgs.shape
    x0, y0, tx, ty = (t.expand(n, h, w) for t in split_displacement(fx, fy))
    return bilinear_taps(imgs.reshape(n, h * w), x0, y0, tx, ty, h, w)


sample_displaced_multi_plain.calls = 0


def _check_multi(imgs, fx, fy):
    if imgs.dim() != 3:
        raise ValueError(f"sample_displaced_multi takes (N, H, W) planes, got {tuple(imgs.shape)}")
    for name, t in (("imgs", imgs), ("fx", fx), ("fy", fy)):
        if t.dtype != torch.float32:
            raise TypeError(f"sample_displaced_multi: {name} must be float32, got {t.dtype}")
        if name != "imgs" and t.shape != imgs.shape[1:]:
            raise ValueError(
                f"sample_displaced_multi: {name} shape {tuple(t.shape)} != {tuple(imgs.shape[1:])}"
            )
        if t.device != imgs.device:
            raise ValueError(f"sample_displaced_multi: {name} on {t.device}, imgs on {imgs.device}")
        if not t.is_contiguous():
            raise ValueError(f"sample_displaced_multi: {name} must be contiguous")


def sample_displaced_multi(imgs: torch.Tensor, fx: torch.Tensor, fy: torch.Tensor) -> torch.Tensor:
    """``out[n](p) = bilinear imgs[n](p + (fx, fy)(p))``, zero outside, for
    (N, H, W) float32 planes and one (H, W) float32 displacement field.

    A CPU tensor takes the plain version; a CUDA tensor launches K5 or raises.
    """
    _check_multi(imgs, fx, fy)
    if imgs.device.type == "cpu":
        return sample_displaced_multi_plain(imgs, fx, fy)
    cuda_lib.require_cuda(imgs, fx, fy)
    n, h, w = imgs.shape
    cuda_lib.check_grid("sample_displaced_multi", 1, -(-h // 8))  # 32 x 8 threads a block
    out = torch.empty_like(imgs)
    cuda_lib.call("ma_sample_displaced_multi", imgs.device, imgs, fx, fy, out, n, h, w)
    sample_displaced_multi.launches += 1
    return out


sample_displaced_multi.launches = 0
