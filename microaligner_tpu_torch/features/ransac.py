"""Batched RANSAC for a 4-DoF partial affine (rotation, scale, translation).

PyTorch counterpart of ``microaligner_tpu/features/ransac.py``, which
replaces ``cv.estimateAffinePartial2D(method=RANSAC)``: 2048 two-point
similarity hypotheses are fitted and scored at once (threshold 3 px), the
best is refined by three rounds of least squares on its inliers, and a
refinement that collapses (< 2 inliers) keeps the best hypothesis.

Model: [x'] = [a -b] [x] + [tx]
       [y']   [b  a] [y]   [ty]

The hypotheses' random pairs cannot be the JAX package's (``jax.random``'s
threefry).  Here one float64 uniform a hypothesis end comes from a
``torch.Generator`` seeded from ``seed``, drawn on the CPU and moved to the
device; the device scales it by the number of valid rows.  So a CPU run and
a card run draw the same pairs, and nothing is read back to the host.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["estimate_affine_partial_2d"]

REPROJ_THR = 3.0  # OpenCV's default ransacReprojThreshold
NUM_HYPOTHESES = 2048
REFINE_ROUNDS = 3
_SCORE_ELEMS = 1 << 26  # residuals per scoring chunk (hypotheses x points)


@functools.lru_cache(maxsize=8)
def _uniforms(seed: int, num: int) -> torch.Tensor:
    """(2, num) float64 uniforms in [0, 1) from a CPU generator."""
    g = torch.Generator(device="cpu")
    g.manual_seed(int(seed))
    return torch.rand((2, num), generator=g, dtype=torch.float64)


def _fit_two_points(p0, p1, q0, q1):
    """Closed-form similarity from point pairs p -> q, each (N, 2);
    returns (a, b, tx, ty), each (N,)."""
    dp = p1 - p0
    dq = q1 - q0
    den = dp[:, 0] * dp[:, 0] + dp[:, 1] * dp[:, 1]
    den = torch.where(den > 1e-12, den, 1e-12)
    a = (dp[:, 0] * dq[:, 0] + dp[:, 1] * dq[:, 1]) / den
    b = (dp[:, 0] * dq[:, 1] - dp[:, 1] * dq[:, 0]) / den
    tx = q0[:, 0] - (a * p0[:, 0] - b * p0[:, 1])
    ty = q0[:, 1] - (b * p0[:, 0] + a * p0[:, 1])
    return a, b, tx, ty


def _residual2(a, b, tx, ty, src, dst):
    """Squared reprojection error; the parameters broadcast against the
    points (scalars, or (N, 1) for N hypotheses)."""
    px = a * src[:, 0] - b * src[:, 1] + tx
    py = b * src[:, 0] + a * src[:, 1] + ty
    return (px - dst[:, 0]) ** 2 + (py - dst[:, 1]) ** 2


def _weighted_ls(src, dst, wgt) -> torch.Tensor:
    """Weighted least-squares similarity (linear in [a, b, tx, ty]), summed
    in float64 (the sums' order differs between the CPU and the card) and
    rounded to float32."""
    src, dst, wgt = src.to(torch.float64), dst.to(torch.float64), wgt.to(torch.float64)
    n = torch.clamp_min(torch.sum(wgt), 1e-9)
    mx = torch.sum(wgt * src[:, 0]) / n
    my = torch.sum(wgt * src[:, 1]) / n
    ux = torch.sum(wgt * dst[:, 0]) / n
    uy = torch.sum(wgt * dst[:, 1]) / n
    sx = src[:, 0] - mx
    sy = src[:, 1] - my
    dx = dst[:, 0] - ux
    dy = dst[:, 1] - uy
    den = torch.sum(wgt * (sx * sx + sy * sy))
    den = torch.where(den > 1e-12, den, 1e-12)
    a = torch.sum(wgt * (sx * dx + sy * dy)) / den
    b = torch.sum(wgt * (sx * dy - sy * dx)) / den
    tx = ux - (a * mx - b * my)
    ty = uy - (b * mx + a * my)
    return torch.stack([a, b, tx, ty]).to(torch.float32)


def _ransac_core(src: torch.Tensor, dst: torch.Tensor, valid: torch.Tensor, seed: int = 0,
                 num_hypotheses: int = NUM_HYPOTHESES):
    """(params [a, b, tx, ty] (4,), inlier count) as device tensors; no
    host round trip.  ``src``/``dst`` (n, 2) float32, ``valid`` (n,) bool."""
    n = src.shape[0]
    thr2 = REPROJ_THR * REPROJ_THR
    denom = torch.clamp_min(torch.sum(valid), 1)
    # valid rows first, in order: pairs are drawn among them
    order = torch.argsort((~valid).to(torch.int32), stable=True)
    u = _uniforms(seed, num_hypotheses).to(src.device)
    i0 = torch.minimum((u[0] * denom).floor().to(torch.int64), denom - 1)
    i1 = torch.minimum((u[1] * denom).floor().to(torch.int64), denom - 1)
    i1 = torch.where(i1 == i0, (i1 + 1) % denom, i1)
    p0, p1 = order[i0], order[i1]
    a, b, tx, ty = _fit_two_points(src[p0], src[p1], dst[p0], dst[p1])

    step = max(1, _SCORE_ELEMS // max(1, n))
    counts = torch.cat([
        ((_residual2(a[s : s + step, None], b[s : s + step, None], tx[s : s + step, None],
                     ty[s : s + step, None], src, dst) <= thr2) & valid[None, :]).sum(dim=1)
        for s in range(0, num_hypotheses, step)
    ])
    best = torch.argmax(counts)
    best_params = torch.stack([a[best], b[best], tx[best], ty[best]])
    best_count = counts[best]

    # refinement: iterated least squares on the inlier set (OpenCV refines
    # with Levenberg-Marquardt; the similarity problem is linear)
    refined = best_params
    for _ in range(REFINE_ROUNDS):
        r = _residual2(*refined, src, dst)
        refined = _weighted_ls(src, dst, ((r <= thr2) & valid).to(torch.float32))
    refined_count = torch.sum((_residual2(*refined, src, dst) <= thr2) & valid)
    degenerate = refined_count < 2
    final = torch.where(degenerate, best_params, refined)
    return final, torch.where(degenerate, best_count, refined_count)


def estimate_affine_partial_2d(src, dst, valid=None, seed: int = 0, nvalid_hint=None):
    """The 2x3 partial-affine matrix mapping ``src`` -> ``dst``.

    Returns ``(tmat (2, 3) float64 numpy, inlier count)``: identity and 0
    when fewer than 2 valid pairs are given.  Runs on the device of ``src``
    when it is a tensor; ``nvalid_hint`` skips the count's round trip.
    """
    src = torch.as_tensor(src).to(torch.float32)
    dst = torch.as_tensor(dst).to(src.device, torch.float32)
    if valid is None:
        valid = torch.ones(src.shape[0], dtype=torch.bool, device=src.device)
    valid = torch.as_tensor(valid).to(src.device, torch.bool)
    nvalid = int(nvalid_hint) if nvalid_hint is not None else int(valid.sum())
    if nvalid < 2:
        return np.eye(2, 3), 0
    params, count = _ransac_core(src, dst, valid, seed)
    fetched = torch.cat([params.to(torch.float64), count.to(torch.float64).view(1)]).cpu().numpy()
    a, b, tx, ty = fetched[:4]
    return np.array([[a, -b, tx], [b, a, ty]]), int(fetched[4])
