"""OptFlowReg's register and warp, plain PyTorch.

Frozen copy of the port's default route (``optflow/registrator.py``'s carry
loop ``_register_whole``, the banded Farneback of ``optflow/flow_calc.py``
fused with its post-warp, ``optflow/farneback.py`` with K2's pairing on the
route ``prec`` names, ``ops/mutual_info.py``'s gate), with every kernel replaced by
its plain version (``kernels.py``, ``warps.py``).  It matches
``cv.calcOpticalFlowFarneback(prev=mov, next=ref, pyr_scale=0.5, levels=0,
winsize, iterations, poly_n=1, poly_sigma=1.7, OPTFLOW_FARNEBACK_GAUSSIAN)``
on full-width row bands with ``overlap`` rows and columns of zero halo.

``prec`` is Farneback's route (``kernels.FlowPrecision``), ``warp_bits``
the significand of the warps' taps and fractions (None: float32; 10: the
TF32 control).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from benchmark.reference import kernels
from benchmark.reference.filters import dog_traced, pyr_down, pyr_up, sep_filter2d
from benchmark.reference.tiles import TileGrid
from benchmark.reference.warps import band_rows_for, band_slab, compose_flows_tiled, sample_band, warp_tiled_dtype

_PRESMOOTH = np.array([0.25, 0.5, 0.25], dtype=np.float32)
_BINS = 256
_GROUP_ELEMS = 1 << 26  # elements histogrammed per bincount


@functools.lru_cache(maxsize=None)
def _poly_coeff_tuple(n: int, sigma: float):
    """(g0, g1, xg1, xxg1, ig11, ig03, ig33, ig55) of OpenCV's
    FarnebackPolyExp setup, in float64 then cast."""
    x = np.arange(-n, n + 1, dtype=np.float64)
    g = np.exp(-(x**2) / (2.0 * sigma * sigma))
    g /= g.sum()
    xg = x * g
    xxg = x * x * g
    xs, ys = np.meshgrid(x, x)
    wgt = np.outer(g, g)
    basis = np.stack([np.ones_like(xs), xs, ys, xs * xs, ys * ys, xs * ys], axis=-1)
    G = np.einsum("yx,yxi,yxj->ij", wgt, basis, basis)
    invG = np.linalg.inv(G)
    g, xg, xxg = g.astype(np.float32), xg.astype(np.float32), xxg.astype(np.float32)
    return (float(g[0]), float(g[1]), float(xg[2]), float(xxg[2]), float(invG[1, 1]), float(invG[0, 3]),
            float(invG[3, 3]), float(invG[5, 5]))


def _replicate_index(size: int, r: int, device) -> torch.Tensor:
    return torch.arange(-r, size + r, device=device).clamp(0, size - 1)


def _pad_replicate1(x: torch.Tensor) -> torch.Tensor:
    h, w = x.shape[-2:]
    x = x.index_select(-2, _replicate_index(h, 1, x.device))
    return x.index_select(-1, _replicate_index(w, 1, x.device)).contiguous()


def farneback_core(movs: torch.Tensor, refs: torch.Tensor, win_size: int, num_iter: int,
                   prec: kernels.FlowPrecision = kernels.FlowPrecision()):
    """Batched (N, H, W) Farneback (poly_n 1, sigma 1.7) -> (fx, fy)."""
    s0 = sep_filter2d(movs.to(torch.float32), _PRESMOOTH, _PRESMOOTH)
    s1 = sep_filter2d(refs.to(torch.float32), _PRESMOOTH, _PRESMOOTH)
    r0, r1, m = kernels.poly_pair_m(_pad_replicate1(s0), _pad_replicate1(s1), _poly_coeff_tuple(1, 1.7), prec)
    fx = fy = None
    for i in range(num_iter):
        fx, fy = kernels.smooth5_solve(m, win_size, prec)
        if i < num_iter - 1:
            m = kernels.update_matrices(r0, r1, fx, fy, prec)
    return fx, fy


def flow_and_warp_banded(ref_img, mov_img, warp_src, grid: TileGrid, win_size: int, num_iter: int,
                         out_dtype: torch.dtype, prec: kernels.FlowPrecision, warp_bits=None):
    """Per band: Farneback on the halo'd slab pair, interiors kept, and
    ``warp_src`` pulled by the band's flow into the band's rows.  Returns
    ((H, W, 2) flow, (H, W) warped in ``out_dtype``)."""
    h, w, o = grid.height, grid.width, grid.overlap
    rows = band_rows_for(grid)
    nb = -(-h // rows)
    warped = torch.empty((h, w), dtype=out_dtype, device=warp_src.device)
    src = warp_src.contiguous()[None]
    fxs, fys = [], []
    for i in range(nb):
        row0 = i * rows
        br = band_slab(ref_img, row0, rows, o)
        bm = band_slab(mov_img, row0, rows, o)
        fx, fy = farneback_core(bm[None], br[None], win_size, num_iter, prec)
        sample_band(src, (fx[0], fy[0]), warped[None], row0, rows, o, warp_bits)
        fxs.append(fx[0, o : o + rows, o : o + w])
        fys.append(fy[0, o : o + rows, o : o + w])
    flow = torch.stack([torch.cat(fxs)[:h], torch.cat(fys)[:h]], dim=-1)
    return flow, warped


def _hists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    n = a.shape[0]
    idx = a.to(torch.int64) * _BINS + b.to(torch.int64)
    idx += torch.arange(n, device=a.device).view(n, 1) * (_BINS * _BINS)
    counts = torch.bincount(idx.reshape(-1), minlength=n * _BINS * _BINS)
    return counts.view(n, _BINS, _BINS)


def _entropy(p: torch.Tensor, dims) -> torch.Tensor:
    return -torch.where(p > 0, p * torch.log(p.clamp_min(1e-300)), 0.0).sum(dims)


def _nmi_from_hists(hist: torch.Tensor) -> torch.Tensor:
    h = hist.to(torch.float64)
    pxy = h / h.sum((1, 2), keepdim=True)
    hx = _entropy(pxy.sum(2), 1)
    hy = _entropy(pxy.sum(1), 1)
    hxy = _entropy(pxy, (1, 2))
    mi = (hx + hy - hxy).clamp_min(0.0)
    denom = 0.5 * (hx + hy)
    return torch.where(denom > 0, mi / denom.clamp_min(1e-300), 1.0)


def _chunk_scores(a: torch.Tensor, b: torch.Tensor, nchunks: int, chunk: int) -> torch.Tensor:
    group = max(1, _GROUP_ELEMS // chunk)
    scores = []
    for c0 in range(0, nchunks, group):
        c1 = min(nchunks, c0 + group)
        sa = a[c0 * chunk : c1 * chunk].view(c1 - c0, chunk)
        sb = b[c0 * chunk : c1 * chunk].view(c1 - c0, chunk)
        scores.append(_nmi_from_hists(_hists(sa, sb)))
    return torch.cat(scores)


def mi_tiled(arr1: torch.Tensor, arr2: torch.Tensor, tile_size: int) -> torch.Tensor:
    """Chunked-mean NMI of two u8 tensors (the registration's gate)."""
    a = arr1.reshape(-1)
    b = arr2.reshape(-1)
    if max(arr1.shape) / tile_size < 2:
        return _chunk_scores(a, b, 1, a.numel())[0]
    chunk = tile_size * tile_size
    nfull = a.numel() // chunk
    scores = []
    if nfull > 0:
        scores.append(_chunk_scores(a, b, nfull, chunk))
    if a.numel() - nfull * chunk > 0:
        scores.append(_chunk_scores(a[nfull * chunk :], b[nfull * chunk :], 1, a.numel() - nfull * chunk))
    return torch.cat(scores).mean()


def _build_pyramid(arr: torch.Tensor, num_pyr_lvl: int, use_full_res: bool):
    """Smallest-first Gaussian pyramid; stops before a side drops below 100 px."""
    pyramid, factors = [], []
    lvl_img = arr
    for lvl in range(num_pyr_lvl):
        factor = 2 ** (lvl + 1)
        if arr.shape[0] / factor < 100 or arr.shape[1] / factor < 100:
            break
        lvl_img = pyr_down(lvl_img)
        pyramid.append(lvl_img)
        factors.append(factor)
    factors, pyramid = list(reversed(factors)), list(reversed(pyramid))
    if use_full_res:
        pyramid.append(arr)
        factors.append(1)
    return pyramid, factors


def register(ref_img: torch.Tensor, mov_img: torch.Tensor, params: dict,
             prec: kernels.FlowPrecision = kernels.FlowPrecision(), warp_bits=None) -> torch.Tensor:
    """The (H, W, 2) flow that aligns the u8 ``mov_img`` to ``ref_img``:
    the carry loop over the pyramid levels, coarsest first (pre-warp, DoG,
    Farneback, banded below two tiles, with its post-warp, the NMI gate,
    composition, pyrUp).
    ``params``: ``NumberPyramidLevels``, ``NumberIterationsPerLevel``,
    ``TileSize``, ``Overlap``, ``UseFullResImage``, ``UseDOG``."""
    num_pyr_lvl, num_iter = params["NumberPyramidLevels"], params["NumberIterationsPerLevel"]
    tile_size, overlap = params["TileSize"], params["Overlap"]
    use_full_res, use_dog = params["UseFullResImage"], params["UseDOG"]
    win_size = overlap - (1 - overlap % 2)
    ref_pyr, factors = _build_pyramid(ref_img, num_pyr_lvl, use_full_res)
    mov_pyr, _ = _build_pyramid(mov_img, num_pyr_lvl, use_full_res)
    dtype = mov_img.dtype
    num_lvl = len(factors)
    full_shape = tuple(int(s) for s in mov_img.shape)
    m_flow = None
    for lvl in range(num_lvl):
        shape = tuple(int(s) for s in mov_pyr[lvl].shape)
        grid = TileGrid.for_image(shape, tile_size, overlap)
        is_first, is_last = lvl == 0, lvl == num_lvl - 1
        next_shape = full_shape if is_last else tuple(int(s) for s in mov_pyr[lvl + 1].shape)
        mov_this = mov_pyr[lvl] if is_first else warp_tiled_dtype(mov_pyr[lvl], m_flow, grid, dtype, warp_bits)
        ref_dog, mov_dog = dog_traced(ref_pyr[lvl], use_dog), dog_traced(mov_this, use_dog)
        if max(shape) / tile_size < 2:  # under two tiles: one Farneback over the level, then the banded warp
            fx, fy = farneback_core(mov_dog.to(torch.float32)[None], ref_dog.to(torch.float32)[None], win_size,
                                    num_iter, prec)
            this_flow = torch.stack([fx[0], fy[0]], dim=-1)
            mov_warped = warp_tiled_dtype(mov_this, this_flow, grid, dtype, warp_bits)
        else:
            this_flow, mov_warped = flow_and_warp_banded(ref_dog, mov_dog, mov_this, grid, win_size, num_iter,
                                                         dtype, prec, warp_bits)
        gate_ref = dog_traced(ref_pyr[lvl], True)
        accept = (mi_tiled(gate_ref, dog_traced(mov_warped, True), tile_size)
                  > mi_tiled(gate_ref, dog_traced(mov_pyr[lvl], True), tile_size))
        if is_first:
            target = full_shape if is_last else next_shape
            if is_last and abs(this_flow.shape[0] - full_shape[0]) <= 1:
                m_flow = torch.where(accept, this_flow, 0.0)
                continue
            up = pyr_up(this_flow * (2.0 if not is_last else 1.0), (int(target[0]), int(target[1])))
            m_flow = torch.where(accept, up, 0.0)
            continue
        merged = compose_flows_tiled(m_flow, this_flow, grid)
        if is_last:
            if use_full_res or abs(merged.shape[0] - full_shape[0]) <= 1:
                m_flow = torch.where(accept, merged, m_flow)
            else:
                src = torch.where(accept, merged, m_flow * 2.0)
                m_flow = pyr_up(src, (int(full_shape[0]), int(full_shape[1])))
            continue
        src = torch.where(accept, merged * 2.0, m_flow * 2.0)
        m_flow = pyr_up(src, (int(next_shape[0]), int(next_shape[1])))
    return m_flow


def warp(image: torch.Tensor, flow: torch.Tensor, params: dict, warp_bits=None) -> torch.Tensor:
    """(H, W) ``image`` pulled by ``flow``, banded, in the image's dtype
    (the Warper and the apply of one plane)."""
    grid = TileGrid.for_image(tuple(image.shape), params["TileSize"], params["Overlap"])
    return warp_tiled_dtype(image, flow, grid, image.dtype, warp_bits)
