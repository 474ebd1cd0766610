"""K1: bilinear displacement sampling, ``out(p) = img(p + (fx, fy)(p))``,
and K5, the same for N planes that share one displacement field.

Replaces ``microaligner_tpu/ops/pallas_sample.py::pallas_sample_displaced``
(Pallas body ``_kernel_batched``), which the tiled flow composition and the
affine warps go through; the band warps of the Warper, the per-level warps
and the per-plane apply take K5's band entry at one plane (below).

Taps outside the image read zero (``cv.remap`` with BORDER_CONSTANT).  The
displacement is split into ``floor`` and fraction before it is added to the
pixel position, so the weights stay exact at 20k widths, where an absolute
f32 coordinate would keep only 2**-9 px.

On the H100 the kernel (``csrc/sample.cu``) is bound by bytes: it reads fx,
fy and four taps and writes one f32 per pixel.  A thread owns 4 outputs and
issues all their flow loads, then all 16 gathers, which it makes directly,
so it is exact for any displacement and needs none of the TPU kernel's band
of shifted views or its exact-gather fallback.

The output may be a window: ``fx``/``fy`` of (N, oh, ow) whose row 0 is row
``row0`` of the (N, H, W) image (output pixel (x, y) samples the image at
(x + fx, row0 + y + fy)).  The affine warps (``ops/affine_tiled.py``) pass one
band of output rows at a time this way, so they never hold a whole-plane
displacement field; the default (oh, ow) = (H, W), ``row0`` = 0 is the
plain K1.

K5 (:func:`sample_displaced_multi`, ``csrc/sample.cu``) replaces
``microaligner_tpu/ops/pallas_sample.py::pallas_sample_displaced_multi``, the
z-stack apply: every plane of a cycle pulled by the cycle's one flow.  A
block reads the flow and computes its outputs' taps once, stages each
plane's window of taps in shared memory (or gathers straight from global
memory where a flow tears the tile apart), and sums every plane from it;
each plane equals a K1 launch on it bit for bit.  :func:`sample_band_multi`
is the same kernel typed in and out: one band of a band warp of N planes
(the z-stack apply) or of one plane (the Warper, the per-plane apply, the
banded Farneback's post-warp), read from the stored planes and rounded
into the output (``round_to_dtype``), with the band's halo read as zeros.
At one plane it was faster on the H100 than a typed band entry of K1's own
(``PERF.md``).
"""

from __future__ import annotations

import torch

from microaligner_tpu_torch.ops import cuda_lib
from microaligner_tpu_torch.ops.filters import round_to_dtype
from microaligner_tpu_torch.ops.pad import zero_pad

__all__ = [
    "sample_displaced",
    "sample_displaced_plain",
    "sample_displaced_multi",
    "sample_displaced_multi_plain",
    "sample_band_multi",
    "sample_band_multi_plain",
    "bilinear_taps",
]

_IDX_LIMIT = 2**30  # floor(displacement) is clamped to this before indexing
K1_TILE = (16, 64)  # output rows and columns of a K1 block (csrc/sample.cu, k1::kTileH, kTileW)


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


def split_displacement(fx: torch.Tensor, fy: torch.Tensor, row0: int = 0):
    """Integer corners (absolute, int64) and fractions of p + (fx, fy); the
    displacement's row 0 is image row ``row0``."""
    h, w = fx.shape[-2:]
    x1 = torch.floor(fx)
    y1 = torch.floor(fy)
    tx = fx - x1
    ty = fy - y1
    gx = torch.arange(w, device=fx.device).view(1, w)
    gy = torch.arange(row0, row0 + h, device=fx.device).view(h, 1)
    x0 = gx + x1.clamp(-_IDX_LIMIT, _IDX_LIMIT).to(torch.int64)
    y0 = gy + y1.clamp(-_IDX_LIMIT, _IDX_LIMIT).to(torch.int64)
    return x0, y0, tx, ty


def sample_displaced_plain(img: torch.Tensor, fx: torch.Tensor, fy: torch.Tensor,
                           row0: int = 0) -> torch.Tensor:
    """Plain PyTorch version of K1: (N, H, W) f32 image, (N, oh, ow) f32
    displacements whose row 0 is image row ``row0``."""
    sample_displaced_plain.calls += 1
    n, h, w = img.shape
    x0, y0, tx, ty = split_displacement(fx, fy, row0)
    return bilinear_taps(img.reshape(n, h * w), x0, y0, tx, ty, h, w)


sample_displaced_plain.calls = 0


def _check(img, fx, fy, row0):
    if img.dim() != 3 or fx.dim() != 3:
        raise ValueError(f"sample_displaced takes (N, H, W) tensors, got {tuple(img.shape)}")
    for name, t in (("img", img), ("fx", fx), ("fy", fy)):
        if t.dtype != torch.float32:
            raise TypeError(f"sample_displaced: {name} must be float32, got {t.dtype}")
        if t.shape != fx.shape and name != "img":
            raise ValueError(
                f"sample_displaced: {name} shape {tuple(t.shape)} != {tuple(fx.shape)}"
            )
        if t.device != img.device:
            raise ValueError(f"sample_displaced: {name} on {t.device}, img on {img.device}")
        if not t.is_contiguous():
            raise ValueError(f"sample_displaced: {name} must be contiguous")
    if fx.shape[0] != img.shape[0] or not 0 <= row0 <= 2**30:
        raise ValueError(f"sample_displaced: {tuple(fx.shape)} displacements for "
                         f"{tuple(img.shape)} images at row {row0}")
    h, w = img.shape[1:]
    if max((h + 1) * w + 1, fx.shape[1] * fx.shape[2]) >= 2**31:
        raise ValueError(f"sample_displaced: planes of {tuple(img.shape[1:])} and {tuple(fx.shape[1:])} "
                         "exceed K1's 32-bit offsets inside a plane")


def sample_displaced(img: torch.Tensor, fx: torch.Tensor, fy: torch.Tensor,
                     row0: int = 0) -> torch.Tensor:
    """Batched ``out(p) = bilinear img(p + (fx, fy)(p))``, zero outside.

    ``img`` is (N, H, W) float32; ``fx``, ``fy`` and the output are
    (N, oh, ow), a window whose row 0 is image row ``row0`` (by default the
    whole image).  A CPU tensor takes the plain version; a CUDA tensor
    launches K1 or raises.
    """
    _check(img, fx, fy, row0)
    if img.device.type == "cpu":
        return sample_displaced_plain(img, fx, fy, row0)
    cuda_lib.require_cuda(img, fx, fy)
    n, h, w = img.shape
    oh, ow = fx.shape[1:]
    out = torch.empty_like(fx)
    if n and oh and ow:
        cuda_lib.check_grid("sample_displaced", n, -(-oh // K1_TILE[0]))
        cuda_lib.call("ma_sample_displaced", img.device, img, fx, fy, out, n, h, w, oh, ow, row0)
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

# dtypes K5 reads and writes, by their code in csrc/sample.cu
DTYPE_CODES = {torch.uint8: 0, torch.int8: 1, torch.uint16: 2, torch.int16: 3, torch.int32: 4,
               torch.float32: 5}

K5_TILE = (16, 64)  # output rows and columns of a K5 block (csrc/sample.cu, k5::kTileH, kTileW)


def _launch_multi(name, imgs, fx, fy, fstride, fpitch, fsign, out, row0, rows, lo, hi, staged) -> bool:
    """One K5 launch writing rows [row0, row0 + rows) of every plane of
    ``out``; ``fx``/``fy`` are tensors whose first element is output row
    ``row0``'s first pixel's, ``fpitch`` elements a row.  Returns whether it
    launched (nothing to write launches nothing)."""
    n, h, w = imgs.shape
    if max((h + K5_TILE[0]) * w, (rows + K5_TILE[0]) * fpitch) >= 2**31:
        raise ValueError(f"{name}: planes of {h} x {w} exceed K5's 32-bit offsets inside a plane")
    if staged is not None and (staged.dtype != torch.int32 or staged.device != imgs.device):
        raise ValueError(f"{name}: staged must be an int32 tensor on {imgs.device}")
    if n == 0 or rows == 0 or w == 0:
        return False
    cuda_lib.check_grid(name, 1, -(-rows // K5_TILE[0]))
    # the staged windows' 16-byte copies need a row stride and a base on 16 bytes; without
    # them every tile gathers from global memory (the direct branch)
    vec = (w * imgs.element_size()) % 16 == 0 and imgs.data_ptr() % 16 == 0
    cuda_lib.call("ma_sample_multi", imgs.device, imgs, fx, fy, fstride, fpitch, fsign, out, n, h, w,
                  row0, rows, lo, hi, DTYPE_CODES[imgs.dtype], int(vec), staged)
    return True


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


def sample_displaced_multi(imgs: torch.Tensor, fx: torch.Tensor, fy: torch.Tensor,
                           staged: torch.Tensor | None = None) -> torch.Tensor:
    """``out[n](p) = bilinear imgs[n](p + (fx, fy)(p))``, zero outside, for
    (N, H, W) float32 planes and one (H, W) float32 displacement field.

    A CPU tensor takes the plain version; a CUDA tensor launches K5 or
    raises.  ``staged``, a one-element int32 tensor on the card, counts the
    kernel's tiles that took the staged branch (no path of the system passes
    one).
    """
    _check_multi(imgs, fx, fy)
    if imgs.device.type == "cpu":
        return sample_displaced_multi_plain(imgs, fx, fy)
    cuda_lib.require_cuda(imgs, fx, fy)
    n, h, w = imgs.shape
    out = torch.empty_like(imgs)
    if _launch_multi("sample_displaced_multi", imgs, fx, fy, 1, w, 1.0, out, 0, h, 0, h, staged):
        sample_displaced_multi.launches += 1
    return out


sample_displaced_multi.launches = 0


def band_bounds(h: int, row0: int, rows: int, overlap: int) -> tuple[int, int, int]:
    """(interior rows, first and one past the last source row) of the band
    of ``rows`` interior rows at ``row0`` with ``overlap`` rows of halo."""
    return min(rows, h - row0), max(row0 - overlap, 0), min(row0 + rows + overlap, h)


def sample_band_multi_plain(imgs: torch.Tensor, flow, out: torch.Tensor,
                            row0: int, rows: int, overlap: int) -> torch.Tensor:
    """Plain version of :func:`sample_band_multi`: the band's slab of the
    zero canvas (``band_slab``), pulled by the band's flow in slab
    coordinates (the (H, W, 2) field's band rows zero-padded to the slab, or
    the slab pair as given) through K5's plain version; the interior rounded
    into ``out``."""
    from microaligner_tpu_torch.optflow.flow_calc import band_slab  # optflow imports this module

    sample_band_multi_plain.calls += 1
    o = overlap
    h, w = imgs.shape[1:]
    n_in = band_bounds(h, row0, rows, o)[0]
    src = band_slab(imgs, row0, rows, o)
    if isinstance(flow, tuple):
        fx, fy = flow
    else:
        fx = zero_pad(flow[row0 : row0 + n_in, :, 0], o, rows - n_in + o, o, o)
        fy = zero_pad(flow[row0 : row0 + n_in, :, 1], o, rows - n_in + o, o, o)
    warped = sample_displaced_multi_plain(src, -fx, -fy)
    out[:, row0 : row0 + n_in] = round_to_dtype(warped[:, o : o + n_in, o : o + w], out.dtype)
    return out


sample_band_multi_plain.calls = 0


def _check_band(imgs, flow, out, row0, rows, overlap):
    if imgs.dim() != 3 or out.shape != imgs.shape:
        raise ValueError(f"sample_band_multi takes (N, H, W) planes and output, got "
                         f"{tuple(imgs.shape)} and {tuple(out.shape)}")
    if imgs.dtype not in DTYPE_CODES or out.dtype != imgs.dtype:
        raise TypeError(f"sample_band_multi: {imgs.dtype} planes into {out.dtype} are not taken "
                        f"(one dtype of {sorted(map(str, DTYPE_CODES))} in and out)")
    h, w = imgs.shape[1:]
    if isinstance(flow, tuple):
        if len(flow) != 2:
            raise ValueError(f"sample_band_multi: a slab flow is a pair (fx, fy), got {len(flow)} tensors")
        flows, want = dict(zip(("fx", "fy"), flow)), (rows + 2 * overlap, w + 2 * overlap)
    else:
        flows, want = {"flow": flow}, (h, w, 2)
    for name, t in flows.items():
        if t.dtype != torch.float32:
            raise TypeError(f"sample_band_multi: {name} must be float32, got {t.dtype}")
        if tuple(t.shape) != want:
            raise ValueError(f"sample_band_multi: {name} {tuple(t.shape)} is not {want}")
    for name, t in (("imgs", imgs), ("out", out), *flows.items()):
        if t.device != imgs.device:
            raise ValueError(f"sample_band_multi: {name} on {t.device}, imgs on {imgs.device}")
        if not t.is_contiguous():
            raise ValueError(f"sample_band_multi: {name} must be contiguous")
    if not (0 <= row0 < h and rows >= 1 and overlap >= 0):
        raise ValueError(f"sample_band_multi: band at row {row0} of {rows} rows and overlap "
                         f"{overlap} is outside {h} rows")


def sample_band_multi(imgs: torch.Tensor, flow, out: torch.Tensor, row0: int,
                      rows: int, overlap: int, staged: torch.Tensor | None = None) -> torch.Tensor:
    """One band of the banded warp of N planes by one flow in one K5 launch,
    typed in and out: the z-stack apply and, with N = 1, the one-plane band
    warps (the Warper, the per-plane apply, the banded Farneback's
    post-warp).

    Writes rows ``[row0, row0 + n_in)`` of (N, H, W) ``out`` (``n_in`` the
    band's interior rows, fewer in the last band):
    ``round_to_dtype(bilinear imgs(p - flow(p)), out.dtype)`` for the
    (N, H, W) planes in their stored dtype (``out``'s, one of
    ``DTYPE_CODES``).  ``flow`` is the (H, W, 2) float32 field, or the
    band's own pair ``(fx, fy)`` in slab coordinates: (rows + 2 overlap,
    W + 2 overlap) float32 planes whose pixel (x + overlap, y + overlap) is
    the band's interior pixel (x, y) (the banded Farneback's flow; its halo
    is not read).  Taps on source rows outside
    ``[row0 - overlap, row0 + rows + overlap)`` or outside the image read
    zero, as the zero canvas of ``band_slab`` gives.  Returns ``out``.

    A CPU tensor takes the plain version; a CUDA tensor launches K5 or
    raises.  ``staged`` as for :func:`sample_displaced_multi`.
    """
    _check_band(imgs, flow, out, row0, rows, overlap)
    if imgs.device.type == "cpu":
        return sample_band_multi_plain(imgs, flow, out, row0, rows, overlap)
    h, w = imgs.shape[1:]
    o = overlap
    if isinstance(flow, tuple):
        cuda_lib.require_cuda(imgs, out, *flow)
        fx, fy, fstride, fpitch = flow[0][o, o:], flow[1][o, o:], 1, w + 2 * o
    else:
        cuda_lib.require_cuda(imgs, flow, out)
        fx, fy, fstride, fpitch = flow[row0], flow[row0, :, 1], 2, 2 * w
    n_in, lo, hi = band_bounds(h, row0, rows, o)
    if _launch_multi("sample_band_multi", imgs, fx, fy, fstride, fpitch, -1.0, out, row0, n_in, lo, hi, staged):
        sample_band_multi.launches += 1
    return out


sample_band_multi.launches = 0
