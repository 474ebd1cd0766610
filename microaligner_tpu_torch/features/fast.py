"""FAST-9/16 corner detection as a dense score map plus top-k.

PyTorch counterpart of ``microaligner_tpu/features/fast.py``
(``cv.FastFeatureDetector``, threshold 1, non-max suppression, TYPE_9_16):
every pixel's 16-pixel Bresenham ring is tested for a contiguous arc of at
least 9 brighter or darker pixels, the score is OpenCV's largest passing
threshold minus one, non-maxima are suppressed over 3 x 3, and the strongest
``k`` corners are taken with scan-order tie-breaking.

Everything is integer arithmetic, and the top-k key is tie-free, so the
port is bit-exact with the JAX package (and with cv2) on any device.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["RING", "fast_score_map", "fast_detect_topk", "fast_detect_topk_grid"]

# Bresenham circle of radius 3, OpenCV pixel order, as (dy, dx)
RING = np.array(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3),
        (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3),
        (0, -3), (-1, -3), (-2, -2), (-3, -1),
    ],
    dtype=np.int32,
)
_ARC = 9  # TYPE_9_16: at least 9 contiguous ring pixels
_INT32_MAX = np.iinfo(np.int32).max


def _replicate_pad(img: torch.Tensor, r: int) -> torch.Tensor:
    h, w = img.shape[-2:]
    rows = torch.arange(-r, h + r, device=img.device).clamp(0, h - 1)
    cols = torch.arange(-r, w + r, device=img.device).clamp(0, w - 1)
    return img.index_select(-2, rows).index_select(-1, cols)


def _ring_values(img: torch.Tensor) -> torch.Tensor:
    """(H, W) -> (16, H, W) ring neighbour values (replicate-padded borders;
    the 3 px frame is masked out of the score map anyway)."""
    h, w = img.shape
    p = _replicate_pad(img, 3)
    return torch.stack([p[3 + dy : 3 + dy + h, 3 + dx : 3 + dx + w] for dy, dx in RING.tolist()])


def _arc_score(d: torch.Tensor) -> torch.Tensor:
    """Max over the 16 arc starts of the min over 9 consecutive ring values.
    The window minima come from doubling runs (2, 4, 8, then 9): min is
    exact, so the order of the reductions does not matter."""
    dd = torch.cat([d, d[: _ARC - 1]], dim=0)  # (24, H, W)
    m2 = torch.minimum(dd[:-1], dd[1:])  # runs of 2 from each start: 23
    m4 = torch.minimum(m2[:-2], m2[2:])  # 21
    m8 = torch.minimum(m4[:-4], m4[4:])  # 17
    m9 = torch.minimum(m8[:16], dd[8:24])  # starts 0..15
    return m9.amax(dim=0)


def _raw_score(img: torch.Tensor) -> torch.Tensor:
    """Unmasked FAST-9/16 corner score at every pixel (OpenCV's
    cornerScore<16>: the largest passing threshold minus one).  u8 inputs
    compute in int16, wider dtypes in int32."""
    dt = torch.int16 if img.dtype == torch.uint8 else torch.int32
    v = _ring_values(img).to(dt)
    p = img.to(dt)[None]
    return torch.maximum(_arc_score(v - p), _arc_score(p - v)) - 1


def _nms_keep(score: torch.Tensor, inside: torch.Tensor, threshold: int) -> torch.Tensor:
    """Mask, then 3 x 3 non-max suppression: the score where the pixel is a
    kept corner, 0 elsewhere.  Masked pixels have no score and cannot
    suppress their neighbours (OpenCV's frame handling)."""
    h, w = score.shape
    is_corner = (score >= threshold) & inside
    s = torch.where(is_corner, score, torch.zeros_like(score))
    sp = s.new_zeros((h + 2, w + 2))
    sp[1 : h + 1, 1 : w + 1] = s
    neigh = None
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            view = sp[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]
            neigh = view if neigh is None else torch.maximum(neigh, view)
    keep = is_corner & (s > neigh)
    return torch.where(keep, s, torch.zeros_like(s))


def _frame_mask(h: int, w: int, tile_h: int, tile_w: int, device) -> torch.Tensor:
    """Pixels at least 3 px inside their (tile_h, tile_w) tile."""
    iy = torch.arange(h, device=device).view(h, 1) % tile_h
    ix = torch.arange(w, device=device).view(1, w) % tile_w
    return (iy >= 3) & (iy < tile_h - 3) & (ix >= 3) & (ix < tile_w - 3)


def fast_score_map(img: torch.Tensor, threshold: int = 1) -> torch.Tensor:
    """Dense FAST-9/16 score map (int32); 0 where not a corner or not a
    local maximum.  Only pixels 3 px inside the frame are scored."""
    img = torch.as_tensor(img)
    h, w = img.shape
    inside = _frame_mask(h, w, h, w, img.device)
    return _nms_keep(_raw_score(img), inside, threshold).to(torch.int32)


def _topk_rows(s: torch.Tensor, k: int, threshold: int):
    """Per-row top-k of (..., n) int32 scores with scan-order tie-break.

    Returns ``(top_idx (..., k) int64, resp (..., k) float32, valid (..., k)
    bool)``: the reference's stable ``sorted(kp, key=response,
    reverse=True)[:k]``.  Below 8.4 Mpix a row's composite int32 key (score
    major, reverse scan index minor) is unique, so ``torch.topk`` has no
    ties; longer rows take a stable sort.
    """
    n = s.shape[-1]
    if 256 * n - 1 <= _INT32_MAX:
        idx = torch.arange(n, device=s.device, dtype=torch.int32)
        key = s * n + (n - 1 - idx)
        top_keys, top_idx = torch.topk(key, k, dim=-1)
        valid = top_keys >= threshold * n
        resp = torch.div(top_keys, n, rounding_mode="floor").to(torch.float32)
        return top_idx, resp, valid
    neg, order = torch.sort(-s, dim=-1, stable=True)
    top_s = -neg[..., :k]
    return order[..., :k], top_s.to(torch.float32), top_s >= threshold


def fast_detect_topk(img: torch.Tensor, k: int, threshold: int = 1):
    """Top-k corners by response with scan-order tie-break: ``(coords (k, 2)
    float32 [x, y], response (k,) float32, valid (k,) bool)``."""
    img = torch.as_tensor(img)
    w = img.shape[1]
    s = fast_score_map(img, threshold).reshape(-1)
    top_idx, resp, valid = _topk_rows(s, k, threshold)
    coords = torch.stack([(top_idx % w).to(torch.float32), (top_idx // w).to(torch.float32)], dim=-1)
    return coords, resp, valid


def fast_detect_topk_grid(canvas: torch.Tensor, tile_h: int, tile_w: int, k: int,
                          threshold: int = 1):
    """Per-tile FAST top-k over a whole (ny*tile_h, nx*tile_w) interior
    canvas in one pass, bit-exact with ``fast_detect_topk`` on each tile:
    the per-tile 3 px frame is masked before the NMS, and the tie-break is
    the within-tile scan order.  Returns tile-local ``(coords (N, k, 2),
    resp (N, k), valid (N, k))``, tiles in row-major grid order."""
    h, w = canvas.shape
    ny, nx = h // tile_h, w // tile_w
    inside = _frame_mask(h, w, tile_h, tile_w, canvas.device)
    s = _nms_keep(_raw_score(canvas), inside, threshold).to(torch.int32)
    rows = s.reshape(ny, tile_h, nx, tile_w).permute(0, 2, 1, 3).reshape(ny * nx, tile_h * tile_w)
    top_idx, resp, valid = _topk_rows(rows, k, threshold)
    coords = torch.stack([(top_idx % tile_w).to(torch.float32),
                          (top_idx // tile_w).to(torch.float32)], dim=-1)
    return coords, resp, valid
