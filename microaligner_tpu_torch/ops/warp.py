"""Bilinear resampling: remap, flow application and flow composition.

PyTorch counterpart of ``microaligner_tpu/ops/warp.py`` (``cv.remap`` with
INTER_LINEAR and BORDER_CONSTANT(0)): taps that fall outside the source read
zero, so a sample straddling the border blends with zeros.

Every displacement sample goes through K1 (:func:`sample_displaced`), an
exact four-tap gather for any displacement; N planes that share one flow go
through K5 (:func:`sample_displaced_multi`).  The JAX package's banded
gather-free sampler and the ``lax.cond`` that guarded it against large
displacements existed only because gathers are slow on a TPU; they have no
counterpart here.

Layouts are the JAX package's: images (H, W) or (N, H, W[, C]), flows
(H, W, 2) or (N, H, W, 2) with channel 0 = x.
"""

from __future__ import annotations

import torch

from microaligner_tpu_torch.ops.filters import round_to_dtype
from microaligner_tpu_torch.ops.kernel_sample import (
    bilinear_taps,
    sample_displaced,
    sample_displaced_multi,
)

__all__ = [
    "bilinear_remap",
    "sample_displaced_batched",
    "warp_with_flow",
    "warp_with_flow_batched",
    "warp_with_flow_parts_batched",
    "warp_planes_with_flow",
    "warp_planes_with_flow_parts",
    "compose_flows",
    "compose_flows_batched",
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
