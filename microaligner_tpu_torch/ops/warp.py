"""Bilinear resampling: remap, flow application and flow composition.

PyTorch counterpart of ``microaligner_tpu/ops/warp.py`` (``cv.remap`` with
INTER_LINEAR and BORDER_CONSTANT(0)): taps that fall outside the source read
zero, so a sample straddling the border blends with zeros.

Every displacement sample goes through K1 (:func:`sample_displaced`), an
exact four-tap gather for any displacement; N planes that share one flow go
through K5 (:func:`sample_displaced_multi`), and so does each band of the
banded warps of one or N planes, typed in and out (:func:`warp_band`).  The JAX package's banded
gather-free sampler and the ``lax.cond`` that guarded it against large
displacements existed only because gathers are slow on a TPU; they have no
counterpart here.

Layouts are the JAX package's: images (H, W) or (N, H, W[, C]), flows
(H, W, 2) or (N, H, W, 2) with channel 0 = x.

The affine warps (:func:`affine_warp`, :func:`transform_img_with_tmat`,
``cv.warpAffine``) invert the matrix on the host (pinv of the 3 x 3
homogeneous form) and sample through K1 one band of rows at a time
(``ops/affine_tiled.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from microaligner_tpu_torch.ops.affine_tiled import affine_warp_bands
from microaligner_tpu_torch.ops.filters import round_to_dtype
from microaligner_tpu_torch.ops.kernel_sample import (
    DTYPE_CODES,
    band_bounds,
    bilinear_taps,
    sample_band_multi,
    sample_displaced,
    sample_displaced_multi,
)
from microaligner_tpu_torch.utils.device import resolve_device

__all__ = [
    "bilinear_remap",
    "sample_displaced_batched",
    "warp_with_flow",
    "warp_with_flow_batched",
    "warp_with_flow_parts_batched",
    "warp_band",
    "warp_band_rows",
    "warp_planes_with_flow",
    "warp_planes_with_flow_parts",
    "compose_flows",
    "compose_flows_batched",
    "affine_warp",
    "transform_img_with_tmat",
]


def bilinear_remap(img: torch.Tensor, map_x: torch.Tensor, map_y: torch.Tensor) -> torch.Tensor:
    """Sample ``img`` (H, W) or (H, W, C) at absolute float coordinates
    (map_y, map_x) of shape (Ho, Wo), zero outside.  Integer images are
    rounded half to even and clipped back to their dtype (``cv.remap``)."""
    squeeze = img.dim() == 2
    x = img.to(torch.float32)
    if squeeze:
        x = x.unsqueeze(-1)
    h, w, c = x.shape
    fx0 = torch.floor(map_x)
    fy0 = torch.floor(map_y)
    tx, ty = map_x - fx0, map_y - fy0
    x0 = fx0.to(torch.int64)
    y0 = fy0.to(torch.int64)
    flat = x.permute(2, 0, 1).reshape(c, h * w)
    lead = (c,) + tuple(map_x.shape)
    out = bilinear_taps(flat, x0.expand(lead), y0.expand(lead), tx, ty, h, w)
    out = out.permute(*range(1, out.dim()), 0)
    if squeeze:
        out = out[..., 0]
    return out if img.dtype.is_floating_point else round_to_dtype(out, img.dtype)


def sample_displaced_batched(imgs: torch.Tensor, flows: torch.Tensor) -> torch.Tensor:
    """``out(p) = bilinear imgs(p + flows(p))``, zero outside; ``imgs`` is
    (N, H, W, C) float32, ``flows`` (N, H, W, 2).  One K1 launch a channel."""
    fx = flows[..., 0].contiguous()
    fy = flows[..., 1].contiguous()
    chans = [sample_displaced(imgs[..., c].contiguous(), fx, fy) for c in range(imgs.shape[-1])]
    return torch.stack(chans, dim=-1)


def warp_with_flow_parts_batched(imgs: torch.Tensor, fx: torch.Tensor, fy: torch.Tensor) -> torch.Tensor:
    """The Warper's pull, ``out(p) = imgs(p - flow(p))``, with the flow as
    separate (N, H, W) channels; f32 output."""
    return sample_displaced(imgs.to(torch.float32).contiguous(), -fx, -fy)


def warp_band(imgs: torch.Tensor, flow, out: torch.Tensor, row0: int, rows: int, overlap: int) -> None:
    """One band of the banded warp of the (N, H, W) planes ``imgs`` by one
    flow into rows ``[row0, row0 + n_in)`` of ``out``, rounded to
    ``out.dtype`` (:func:`sample_band_multi`; ``flow`` is the (H, W, 2) field
    or the band's slab-coordinate pair).  Where the planes' dtype is
    ``out``'s and one of the kernel's six, that is one launch that reads the
    stored planes and writes the rounded rows; other pairs of dtype go
    through the float32 instantiation on the band's source rows as float32,
    then are rounded."""
    if imgs.dtype == out.dtype and out.dtype in DTYPE_CODES:
        sample_band_multi(imgs, flow, out, row0, rows, overlap)
        return
    n_in, lo, hi = band_bounds(imgs.shape[1], row0, rows, overlap)
    slab = imgs[:, lo:hi].to(torch.float32).contiguous()
    band_flow = flow if isinstance(flow, tuple) else flow[lo:hi]
    warped = sample_band_multi(slab, band_flow, torch.empty_like(slab), row0 - lo, rows, overlap)
    out[:, row0 : row0 + n_in] = round_to_dtype(warped[:, row0 - lo : row0 - lo + n_in], out.dtype)


def warp_band_rows(imgs: torch.Tensor, flow, row0: int, rows: int, overlap: int,
                   dtype: torch.dtype) -> torch.Tensor:
    """The band of :func:`warp_band` as its own (N, rows, W) tensor of
    ``dtype`` (rows past the image are zero), for a band map whose shards
    cannot write into one output: :func:`warp_band` on the band's source
    rows alone, which gives the same values (the kernel splits each
    displacement into integer and fraction before adding the row, so the
    shifted origin changes no bit)."""
    n, h, w = imgs.shape
    n_in, lo, hi = band_bounds(h, row0, rows, overlap)
    slab = imgs[:, lo:hi].contiguous()
    out = torch.empty(slab.shape, dtype=dtype, device=imgs.device)
    warp_band(slab, flow if isinstance(flow, tuple) else flow[lo:hi], out, row0 - lo, rows, overlap)
    res = out.new_zeros((n, rows, w))
    res[:, :n_in] = out[:, row0 - lo : row0 - lo + n_in]
    return res


def warp_planes_with_flow(imgs: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Warp N planes by ONE shared flow: ``out[n](p) = imgs[n](p - flow(p))``.

    The z-stack apply: every channel and z-plane of a cycle is pulled by the
    cycle's flow.  ``imgs`` (N, H, W), ``flow`` (H, W, 2); (N, H, W) f32
    output.  One K5 launch, exact for any displacement (the JAX package's
    band check and ``lax.cond`` have no counterpart, as for K1).
    """
    return warp_planes_with_flow_parts(imgs, flow[..., 0], flow[..., 1])


def warp_planes_with_flow_parts(imgs: torch.Tensor, fx: torch.Tensor, fy: torch.Tensor) -> torch.Tensor:
    """:func:`warp_planes_with_flow` with the flow as separate (H, W)
    channels; f32 output."""
    return sample_displaced_multi(imgs.to(torch.float32).contiguous(),
                                  (-fx).contiguous(), (-fy).contiguous())


def warp_with_flow_batched(imgs: torch.Tensor, flows: torch.Tensor) -> torch.Tensor:
    """``out(p) = imgs(p - flows(p))`` for (N, H, W[, C]) images and
    (N, H, W, 2) flows; f32 output."""
    x = imgs.to(torch.float32)
    if x.dim() == 3:
        return warp_with_flow_parts_batched(x, flows[..., 0], flows[..., 1])
    return sample_displaced_batched(x, -flows)


def warp_with_flow(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Warp (H, W) ``img`` by (H, W, 2) ``flow``: out(p) = img(p - flow(p)),
    f32 output (the reference Warper's remap by ``-flow + meshgrid``)."""
    return warp_with_flow_parts_batched(img[None], flow[None, ..., 0], flow[None, ..., 1])[0]


def _compose(flow1: torch.Tensor, flow2: torch.Tensor, dims) -> torch.Tensor:
    sampled = sample_displaced_batched(flow2, -flow1)
    merged = flow1 + sampled
    # merge_two_flows returns the other flow verbatim when one is all <= 0
    f1_zero = flow1.amax(dim=dims, keepdim=True) == 0
    f2_zero = flow2.amax(dim=dims, keepdim=True) == 0
    return torch.where(f1_zero, flow2, torch.where(f2_zero, flow1, merged))


def compose_flows_batched(flow1: torch.Tensor, flow2: torch.Tensor) -> torch.Tensor:
    """Batched (N, H, W, 2) ``flow1 + flow2(p - flow1(p))`` with the
    per-item ``max() == 0`` short-circuits of ``merge_two_flows``."""
    return _compose(flow1, flow2, (1, 2, 3))


def compose_flows(flow1: torch.Tensor, flow2: torch.Tensor) -> torch.Tensor:
    """Compose two (H, W, 2) flows: ``flow1 + remap(flow2, -flow1 + grid)``,
    returning one of them verbatim when the other's max is 0."""
    return compose_flows_batched(flow1[None], flow2[None])[0]


def inverse_of(t_mat) -> np.ndarray:
    """The dst -> src 2x3 matrix of a forward 2x3 ``t_mat``: pinv of the
    homogeneous 3 x 3 in float64 (singular matrices included, as the
    reference's transform_img_with_tmat)."""
    t = np.asarray(t_mat, dtype=np.float64)
    return np.linalg.pinv(np.vstack([t, [0.0, 0.0, 1.0]]))[:2]


def affine_warp(img, t_mat, dsize: tuple[int, int] | None = None, device=None) -> torch.Tensor:
    """``cv.warpAffine(img, t_mat, dsize)``: ``t_mat`` maps src coords to dst
    coords; ``dsize`` is (H, W), by default the input's.  Float32 output on
    ``device``; by default a tensor stays where it is and a numpy array goes
    to the first CUDA device (raising when there is no card)."""
    if device is not None or not isinstance(img, torch.Tensor):
        img = torch.as_tensor(img).to(resolve_device(device))
    out_h, out_w = dsize if dsize is not None else img.shape[:2]
    return affine_warp_bands(img, inverse_of(t_mat), int(out_h), int(out_w))


def transform_img_with_tmat(img, target_shape, transform_matrix, device=None) -> np.ndarray:
    """Pad ``img`` (numpy, 2-D) to ``target_shape``, then apply the affine,
    keeping the dtype (reference shared_modules/utils.py:98-114): an
    identity matrix skips the warp; otherwise the bilinear output is cast
    with numpy's truncating ``astype``, as the reference casts after its
    skimage warp.  The warp runs on ``device``: the first CUDA device unless
    another is named, raising when there is no card."""
    from microaligner_tpu_torch.ops.pad import pad_to_shape

    device = resolve_device(device)
    original_dtype = np.asarray(img).dtype
    img, _ = pad_to_shape(np.asarray(img), tuple(target_shape))
    tm = np.asarray(transform_matrix, np.float64)
    if np.array_equal(tm, np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])):
        return np.asarray(img).astype(original_dtype)
    src = torch.from_numpy(np.ascontiguousarray(img).astype(np.float32))
    out = affine_warp(src, tm, device=device).cpu().numpy()
    return out.astype(original_dtype)
