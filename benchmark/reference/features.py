"""FeatureReg's register, plain PyTorch.

Frozen copy of the port's default FeatureReg route on the card
(``features/registrator.py``'s ``_calc_ref_fused`` and ``_register_fused``,
the whole-level feature path of ``features/tile_features.py``, FAST from
``features/fast.py``, DAISY from ``features/daisy.py``, the knn and ratio
test of ``features/match.py``, RANSAC from ``features/ransac.py``), with the
affine warps' kernel replaced by its plain version (``warps.py``).

The DAISY ring blurs take ``daisy_dtype`` operands and the knn cross term
``match_dtype`` ones: bf16 (float32 sums; the route the port takes on the
card unless ``MICROALIGNER_TPU_DAISY_EXACT`` or ``MICROALIGNER_TPU_MATCH_F32``
is ``1``), float32, or a control's ``FP8`` (below bf16) or ``TF32`` (below
float32).  DAISY descriptors are unit-norm (``MICROALIGNER_TPU_DAISY_NRM``
unset).
"""

from __future__ import annotations

import collections
import functools

import numpy as np
import torch

from benchmark.reference.filters import (
    FP8,
    TF32,
    _reflect101_index,
    dog_traced,
    gaussian_blur_mxu,
    gaussian_kernel,
    ieee_float32,
    product_f32,
    pyr_down,
    round_mantissa,
    round_to_dtype,
)
from benchmark.reference.optflow import mi_tiled
from benchmark.reference.tiles import TileGrid, zero_pad
from benchmark.reference.warps import affine_warp_traced

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


_RADIUS = 21.0
_Q_RADIUS = 3
_Q_THETA = 8
_Q_HIST = 8
DAISY_DIM = (1 + _Q_RADIUS * _Q_THETA) * _Q_HIST  # 200
_GATHER_CHUNK = 1 << 17  # keypoints per gather: bounds the (8, K, 25) tap tensors


@functools.lru_cache(maxsize=None)
def _grid_offsets() -> np.ndarray:
    """(25, 2) [dx, dy] grid offsets: centre, then rings inside-out."""
    pts = [(0.0, 0.0)]
    for ring in range(_Q_RADIUS):
        r = _RADIUS * (ring + 1) / _Q_RADIUS
        for k in range(_Q_THETA):
            a = 2.0 * np.pi * k / _Q_THETA
            pts.append((r * np.cos(a), r * np.sin(a)))
    return np.asarray(pts, dtype=np.float32)


@functools.lru_cache(maxsize=None)
def _ring_of_point() -> np.ndarray:
    """(25,) cube index per grid point: the centre uses the innermost cube."""
    return np.asarray([0] + [r for r in range(_Q_RADIUS) for _ in range(_Q_THETA)], np.int32)


@functools.lru_cache(maxsize=None)
def _sigmas() -> np.ndarray:
    """Per-ring smoothing: sigma_i = R*(i+1)/(2*Q) -> 3.5, 7, 10.5."""
    return np.asarray([_RADIUS * (i + 1) / (2 * _Q_RADIUS) for i in range(_Q_RADIUS)], np.float32)


def _increments() -> list:
    """The incremental smoothing of each ring's cube, sqrt(s_i^2 - s_{i-1}^2)."""
    out, prev = [], 0.0
    for s in _sigmas():
        out.append(float(np.sqrt(s * s - prev * prev)))
        prev = float(s)
    return out


def _ksize(sigma: float) -> int:
    return int(round(sigma * 4)) * 2 + 1


def _blur_chw(x: torch.Tensor, sigma: float, operand_dtype=torch.float32) -> torch.Tensor:
    """Gaussian blur of a (C, H, W) stack along H, then W (REFLECT_101).

    The ring sigmas (ksize 29..63) are operator products with
    ``operand_dtype`` operands; short kernels are float32 shifted-slice
    sums, one multiply and one add a tap in ascending order, as the JAX
    package writes them.
    """
    ksize = _ksize(sigma)
    if ksize >= 13 and min(x.shape[-2:]) > (ksize - 1) // 2:
        return gaussian_blur_mxu(x, ksize, sigma, operand_dtype)
    taps = gaussian_kernel(ksize, sigma).tolist()
    r = (ksize - 1) // 2

    def corr(a, axis):
        size = a.shape[axis]
        ap = a.index_select(axis, _reflect101_index(size, r, a.device))
        out = None
        for i, k in enumerate(taps):
            sl = ap.narrow(axis, i, size) * k
            out = sl if out is None else out + sl
        return out

    return corr(corr(x, 1), 2)


def _orientation_cubes(img: torch.Tensor, operand_dtype=torch.float32) -> torch.Tensor:
    """(H, W) image -> (8, Q_RADIUS, H, W) smoothed rectified gradient
    layers, the ring blurs' products on ``operand_dtype`` operands."""
    f = _blur_chw(img.to(torch.float32)[None], 0.5)[0]
    h, w = f.shape
    fp = f.index_select(0, _reflect101_index(h, 1, f.device)).index_select(
        1, _reflect101_index(w, 1, f.device))
    gx = (fp[1:-1, 2:] - fp[1:-1, :-2]) * 0.5
    gy = (fp[2:, 1:-1] - fp[:-2, 1:-1]) * 0.5
    thetas = 2.0 * np.pi * np.arange(_Q_HIST) / _Q_HIST
    cos = torch.from_numpy(np.cos(thetas).astype(np.float32)).to(f.device).view(-1, 1, 1)
    sin = torch.from_numpy(np.sin(thetas).astype(np.float32)).to(f.device).view(-1, 1, 1)
    layers = torch.clamp_min(gx[None] * cos + gy[None] * sin, 0.0)  # (8, H, W)
    del fp, gx, gy
    cubes = []
    cur = layers
    for inc in _increments():
        cur = _blur_chw(cur, inc, operand_dtype)
        cubes.append(cur)
    # orientation-major (8, Q, H, W): the (8, Q*H*W) gather table without a copy
    return torch.stack(cubes, dim=1)


def _gather_descriptors(cubes: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """All 25 grid points of K keypoints as four flat takes (one a bilinear
    tap) over the (8, Q*H*W) cube table -> (K, 200).  Taps are clamped to
    the cube, as the reference's DAISY clamps them."""
    _, q, h, w = cubes.shape
    flat = cubes.reshape(_Q_HIST, q * h * w)
    offs = torch.from_numpy(_grid_offsets()).to(cubes.device)
    base = torch.from_numpy(_ring_of_point().astype(np.int64) * (h * w)).to(cubes.device)[None]
    outs = []
    for c0 in range(0, coords.shape[0], _GATHER_CHUNK):
        c = coords[c0 : c0 + _GATHER_CHUNK]
        xs = torch.clamp(c[:, 0:1] + offs[None, :, 0], 0.0, w - 1.000001)  # (K, 25)
        ys = torch.clamp(c[:, 1:2] + offs[None, :, 1], 0.0, h - 1.000001)
        fx0 = torch.floor(xs)
        fy0 = torch.floor(ys)
        tx = (xs - fx0)[None]
        ty = (ys - fy0)[None]
        x0 = fx0.to(torch.int64)
        y0 = fy0.to(torch.int64)
        x1 = torch.clamp_max(x0 + 1, w - 1)
        y1 = torch.clamp_max(y0 + 1, h - 1)
        k, p = xs.shape

        def take(yy, xx):
            return flat[:, (base + yy * w + xx).reshape(-1)].reshape(_Q_HIST, k, p)

        out = take(y0, x0) * (1 - tx) * (1 - ty)
        out = out + take(y0, x1) * tx * (1 - ty)
        out = out + take(y1, x0) * (1 - tx) * ty
        out = out + take(y1, x1) * tx * ty  # (8, K, 25)
        outs.append(out.permute(1, 2, 0).reshape(k, p * _Q_HIST))
    return torch.cat(outs) if len(outs) > 1 else outs[0]


def normalize_descriptors(desc: torch.Tensor) -> torch.Tensor:
    """Unit L2 norm per row (rows of norm below 1e-8 are divided by 1e-8)."""
    return desc / torch.clamp_min(torch.linalg.vector_norm(desc, dim=-1, keepdim=True), 1e-8)



_BIG = 3.4e38
_CHUNK_ELEMS = 1 << 27  # distance entries per query chunk
# the near-tie rule of each route (module docstring): TOL and kappa
# (a control keeps the rule of the route it stands below: FP8 bf16's, TF32 float32's)
_TIE_TOL = {torch.float32: 2.0**-14, torch.bfloat16: 2.0**-13, FP8: 2.0**-13, TF32: 2.0**-14}
_KAPPA = {torch.float32: 1.0, torch.bfloat16: 1.134, FP8: 1.134, TF32: 1.0}


def _top2(query: torch.Tensor, train: torch.Tensor, t_valid: torch.Tensor, chunk: int,
          operand_dtype=torch.float32):
    """``(d1, d2, idx1, |q|^2, |t|^2)`` in the inputs' dtype, ``chunk``
    query rows at a time, fewer when a chunk would pass 2**27 entries.  The
    cross term takes ``operand_dtype`` operands: bf16 rounds both sides and,
    for float32 inputs, sums in float32 (:func:`product_f32`), for float64
    inputs in float64; ``TF32`` rounds both sides to its significand and
    sums as float32 does; the norms are always the unrounded inputs'."""
    if operand_dtype not in _TIE_TOL:
        raise ValueError(f"knn: operand dtype {operand_dtype} is neither float32 nor bf16")
    qn = torch.sum(query * query, dim=1)
    tn = torch.sum(train * train, dim=1)
    tmask = torch.where(t_valid, 0.0, _BIG).to(query.dtype)
    step = max(1, min(chunk, _CHUNK_ELEMS // max(1, train.shape[0])))
    q_op, t_op = query, train
    if operand_dtype in (FP8, TF32):
        bits = 3 if operand_dtype == FP8 else 10
        q_op, t_op = round_mantissa(query, bits), round_mantissa(train, bits)
    if operand_dtype in (torch.bfloat16, FP8):
        q_op, t_op = q_op.to(torch.bfloat16), t_op.to(torch.bfloat16)
    if query.dtype != torch.float32:  # the float64 re-decision of the mixed formula
        q_op, t_op = q_op.to(query.dtype), t_op.to(query.dtype)
    d1s, d2s, i1s = [], [], []
    with ieee_float32():
        for s in range(0, query.shape[0], step):
            qs = q_op[s : s + step]
            cross = product_f32(qs, t_op.T) if qs.dtype == torch.bfloat16 else torch.matmul(qs, t_op.T)
            d = qn[s : s + step, None] + tn[None, :] - 2.0 * cross + tmask[None, :]
            del cross
            d.clamp_min_(0.0)
            d1, i1 = torch.min(d, dim=1)
            d.scatter_(1, i1[:, None], _BIG)  # the nearest out: the runner-up is the min
            d1s.append(d1)
            d2s.append(torch.amin(d, dim=1))
            i1s.append(i1)
            del d
    return torch.cat(d1s), torch.cat(d2s), torch.cat(i1s), qn, tn


def match_descriptors(des_ref: torch.Tensor, des_mov: torch.Tensor, ref_valid: torch.Tensor,
                      mov_valid: torch.Tensor, ratio: float = 0.5, operand_dtype=torch.bfloat16):
    """Ratio-filtered matches mov -> ref (query = mov, train = ref): keep
    ``d1 < ratio * d2`` on unsquared distances, near-ties decided in
    float64; ``operand_dtype`` is the cross term's
    (float32, bf16, ``FP8`` or ``TF32``).  Returns
    ``(good (Q,) bool, ref_idx (Q,) int64)`` aligned with the mov rows."""
    r2 = ratio * ratio
    query, train = des_mov.to(torch.float32), des_ref.to(torch.float32)
    d1, d2, i1, qn, _ = _top2(query, train, ref_valid, 4096, operand_dtype)
    good = (d1 < r2 * d2) & mov_valid
    scale = qn + torch.square(_KAPPA[operand_dtype] * torch.sqrt(qn) + torch.sqrt(d2))
    sel = torch.nonzero((torch.abs(d1 - r2 * d2) <= _TIE_TOL[operand_dtype] * scale) & mov_valid).squeeze(1)
    if sel.numel():
        e1, e2, ei, _, _ = _top2(query[sel].double(), train.double(), ref_valid, 4096, operand_dtype)
        good[sel] = e1 < r2 * e2
        i1[sel] = ei
    return good, i1


REPROJ_THR = 3.0  # OpenCV's default ransacReprojThreshold
NUM_HYPOTHESES = 2048
REFINE_ROUNDS = 3
_SCORE_ELEMS = 1 << 26  # residuals per scoring chunk (hypotheses x points)


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




HALO = 51  # the reference's overlap for the feature path
Features = collections.namedtuple("Features", "coords descriptors valid")
DENSE_MAX_PIXELS = 26e6  # the port's whole-level path takes padded canvases up to this


def features_per_tile(grid: TileGrid) -> int:
    return min(1_000_000 // grid.num_tiles, 5000)


def _canvases(img: torch.Tensor, grid: TileGrid):
    """The zero-padded interior canvas (FAST) and the halo-padded f32 canvas
    (DAISY), zeros outside the image."""
    ph, pw = grid.padded_h - grid.height, grid.padded_w - grid.width
    interior = zero_pad(img, 0, ph, 0, pw)
    halo = zero_pad(img.to(torch.float32), HALO, ph + HALO, HALO, pw + HALO)
    return interior, halo


def _tile_origins(grid: TileGrid, device) -> torch.Tensor:
    """(N, 2) float32 [x, y] tile origins, row-major."""
    tids = torch.arange(grid.num_tiles, device=device)
    return torch.stack([(tids % grid.nx) * grid.tile_w, (tids // grid.nx) * grid.tile_h],
                       dim=-1).to(torch.float32)


def _find_features_dense(img: torch.Tensor, grid: TileGrid, k: int, normalize: bool,
                         daisy_dtype: torch.dtype = torch.float32):
    """Whole-level FAST + DAISY.  Returns tile-local coords (N, k, 2),
    descriptors (N, k, 200), valid and responses (N, k)."""
    interior, halo = _canvases(img, grid)
    coords, resp, valid = fast_detect_topk_grid(interior, grid.tile_h, grid.tile_w, k, threshold=1)
    del interior
    # the reference samples the halo tile at interior coords, a consistent
    # (-halo, -halo) offset; in halo-canvas coordinates it cancels, so the
    # sampling happens at global coords
    cubes = _orientation_cubes(halo, daisy_dtype)
    del halo
    global_coords = (coords + _tile_origins(grid, img.device)[:, None, :]).reshape(-1, 2)
    desc = _gather_descriptors(cubes, global_coords)
    del cubes
    if normalize:
        desc = normalize_descriptors(desc)
    return coords, desc.reshape(grid.num_tiles, k, -1), valid, resp


def find_features_tiled(img: torch.Tensor, grid: TileGrid, k: int, daisy_dtype) -> tuple:
    """Whole-level FAST + DAISY -> flat global (coords (N*k, 2), unit-norm
    descriptors (N*k, 200), valid (N*k,), responses (N*k,))."""
    if grid.padded_h * grid.padded_w > DENSE_MAX_PIXELS:
        raise ValueError("the reference follows the whole-level feature path only")
    coords, desc, valid, resp = _find_features_dense(img, grid, k, True, daisy_dtype)
    coords = coords + _tile_origins(grid, img.device)[:, None, :]
    n = grid.num_tiles * k
    return coords.reshape(n, 2), desc.reshape(n, -1), valid.reshape(n), resp.reshape(n)


def _mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """3 x 3 product as elementwise multiply-adds in a fixed order, so a
    CPU run and a card run compose the same float32 matrices."""
    return a[:, 0:1] * b[0:1, :] + a[:, 1:2] * b[1:2, :] + a[:, 2:3] * b[2:3, :]


def _valid_transform_traced(est3: torch.Tensor, img_shape) -> torch.Tensor:
    """Device form of the host gates: scale in [0.3, 3] by the 2-D
    decomposition (feature_registrator.py:240-266) and the transformed image
    centre inside the borders (:268-278)."""
    aa, bb = est3[0, 0], est3[1, 0]
    cc, dd = est3[0, 1], est3[1, 1]
    det = aa * dd - bb * cc
    n1 = aa * aa + bb * bb
    n2 = cc * cc + dd * dd
    r = torch.sqrt(torch.clamp_min(n1, 1e-30))
    s = torch.sqrt(torch.clamp_min(n2, 1e-30))
    s1 = torch.where(n1 > 0, r, det / s)
    s2 = torch.where(n1 > 0, det / r, s)
    ok_scale = (((n1 > 0) | (n2 > 0)) & (torch.abs(s1) >= 0.3) & (torch.abs(s1) <= 3.0)
                & (torch.abs(s2) >= 0.3) & (torch.abs(s2) <= 3.0))
    cy, cx = img_shape[0] // 2, img_shape[1] // 2
    center = est3[:, 0] * float(cx) + est3[:, 1] * float(cy) + est3[:, 2]
    border = torch.tensor([img_shape[1], img_shape[0], 1.0], dtype=torch.float32, device=est3.device)
    return ok_scale & ~torch.any(border - torch.abs(center) < 0)


def _level_align_body(ref_img, ref_feats: Features, mov_img, grid: TileGrid, k: int, tile_size: int,
                      num_iterations: int, use_dog: bool, daisy_dtype, match_dtype):
    """One pyramid level's rounds of find -> match -> RANSAC -> warp -> NMI
    gate.  Returns the composed 2x3 float32 matrix."""
    dev = mov_img.device
    eye3 = torch.eye(3, dtype=torch.float32, device=dev)
    dtype = mov_img.dtype
    ref_gate_dog = dog_traced(ref_img, True)  # the MI gate always DoGs
    composed, aligned = eye3, mov_img
    for _ in range(num_iterations):
        coords, desc, valid, _resp = find_features_tiled(dog_traced(aligned, use_dog), grid, k, daisy_dtype)
        good, ref_idx = match_descriptors(ref_feats.descriptors, desc, ref_feats.valid, valid,
                                          operand_dtype=match_dtype)
        dst = ref_feats.coords[ref_idx]
        n_good = torch.sum(good)
        params, _count = _ransac_core(coords, dst, good, 0)
        a, b, tx, ty = params[0], params[1], params[2], params[3]
        zero, one = torch.zeros_like(a), torch.ones_like(a)
        est = torch.stack([torch.stack([a, -b, tx]), torch.stack([b, a, ty]), torch.stack([zero, zero, one])])
        est = torch.where(n_good >= 3, est, eye3)
        # the candidate warps the CURRENT aligned image; an accepted round
        # realigns from the ORIGINAL mov with the composed matrix
        cand = round_to_dtype(affine_warp_traced(aligned, est[:2]), dtype)
        after = mi_tiled(ref_gate_dog, dog_traced(cand, True), tile_size)
        before = mi_tiled(ref_gate_dog, dog_traced(aligned, True), tile_size)
        accept = (after > before) & _valid_transform_traced(est, tuple(mov_img.shape))
        composed = torch.where(accept, _mm3(composed, est), composed)
        realigned = round_to_dtype(affine_warp_traced(mov_img, composed[:2]), dtype)
        aligned = torch.where(accept, realigned, aligned)
    return composed[:2]


def _build_pyr_levels(img: torch.Tensor, factors) -> list:
    """Pyramid levels for descending ``factors`` ((8, 4, 2) or (8, 4, 2, 1)),
    smallest first; a trailing factor 1 is the image itself."""
    n_down = sum(1 for f in factors if f > 1)
    chain = []
    cur = img
    for _ in range(n_down):
        cur = pyr_down(cur)
        chain.append(cur)
    levels = list(reversed(chain))
    if factors and factors[-1] == 1:
        levels.append(img)
    return levels


def _level_grid(shape, tile_size: int):
    grid = TileGrid.for_image(tuple(int(s) for s in shape), tile_size, HALO)
    return grid, features_per_tile(grid)


def _calc_ref(img: torch.Tensor, factors, tile_size: int, use_dog: bool, daisy_dtype):
    """Reference side: pyramid, per-level DoG and tiled features."""
    pyr = _build_pyr_levels(img, factors)
    feats = []
    for lvl in pyr:
        grid, k = _level_grid(lvl.shape, tile_size)
        feats.append(Features(*find_features_tiled(dog_traced(lvl, use_dog), grid, k, daisy_dtype)[:3]))
    return pyr, feats


def _tscale(scale: float, device) -> torch.Tensor:
    """Elementwise mask that rescales a homogeneous matrix's translation."""
    return torch.tensor([[1.0, 1.0, scale], [1.0, 1.0, scale], [1.0, 1.0, 1.0]], dtype=torch.float32, device=device)


def _register_levels(ref_pyr, ref_feats, mov_img: torch.Tensor, factors, tile_size: int, num_iterations: int,
                     use_dog: bool, daisy_dtype, match_dtype) -> torch.Tensor:
    """The multi-level registration; returns the 2x3 float32 matrix."""
    dev = mov_img.device
    mov_pyr = _build_pyr_levels(mov_img, factors)
    fullscale = []  # homogeneous 3 x 3 at full resolution
    for i, factor in enumerate(factors):
        mov_lvl = mov_pyr[i]
        if i > 0:
            acc = torch.eye(3, dtype=torch.float32, device=dev)
            for m in fullscale:
                acc = _mm3(acc, m * _tscale(1.0 / factor, dev))
            mov_lvl = round_to_dtype(affine_warp_traced(mov_lvl, acc[:2]), mov_lvl.dtype)
        grid, k = _level_grid(mov_lvl.shape, tile_size)
        tmat2 = _level_align_body(ref_pyr[i], ref_feats[i], mov_lvl, grid, k, tile_size, num_iterations, use_dog,
                                  daisy_dtype, match_dtype)
        hom = torch.cat([tmat2, torch.tensor([[0.0, 0.0, 1.0]], device=dev)], dim=0)
        fullscale.append(hom * _tscale(float(factor), dev))
    final = fullscale[0]
    for m in fullscale[1:]:
        final = _mm3(final, m)
    return final[:2]


def pyr_factors(shape, num_pyr_lvl: int, use_full_res: bool) -> list:
    """Descending pyramid factors: a level exists while both sides stay
    >= 100 px."""
    n_lvl = 0
    for lvl in range(num_pyr_lvl):
        factor = 2 ** (lvl + 1)
        if shape[0] / factor < 100 or shape[1] / factor < 100:
            break
        n_lvl = lvl + 1
    factors = [2 ** (lvl + 1) for lvl in reversed(range(n_lvl))]
    if use_full_res:
        factors.append(1)
    return factors


def register(ref_img: torch.Tensor, mov_img: torch.Tensor, params: dict, daisy_dtype=torch.bfloat16,
             match_dtype=torch.bfloat16) -> np.ndarray:
    """The 2x3 matrix (float64) mapping the u8 ``mov_img``'s coordinates to
    ``ref_img``'s.  ``params``: ``NumberPyramidLevels``,
    ``NumberIterationsPerLevel``, ``TileSize``, ``UseFullResImage``,
    ``UseDOG``."""
    factors = tuple(pyr_factors(tuple(ref_img.shape), params["NumberPyramidLevels"], params["UseFullResImage"]))
    tile, iters, use_dog = params["TileSize"], params["NumberIterationsPerLevel"], params["UseDOG"]
    ref_pyr, ref_feats = _calc_ref(ref_img, factors, tile, use_dog, daisy_dtype)
    tmat = _register_levels(ref_pyr, ref_feats, mov_img, factors, tile, iters, use_dog, daisy_dtype, match_dtype)
    return tmat.to(torch.float64).cpu().numpy()
