"""Normalized mutual information scoring, the registration quality gate.

PyTorch counterpart of ``microaligner_tpu/ops/mutual_info.py``: images are
flattened, split into ``tile_size**2``-element chunks, each chunk's NMI
(``sklearn.metrics.normalized_mutual_info_score``: arithmetic-mean
normalization, natural log) is computed from its 256x256 joint histogram,
and the chunk scores are averaged.  Whole-image NMI is used when
``max(shape)/tile_size < 2``.

The joint histogram of a group of chunks is one ``torch.bincount`` over
``chunk * 65536 + a * 256 + b``; counts are exact integers.  The entropies
are taken in float64 from those counts, so a score is exact to float64
rounding (the JAX package sums them in float32).
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from microaligner_tpu_torch.utils.logging import log

__all__ = [
    "nmi_u8",
    "mi_tiled",
    "mi_tiled_traced",
    "mutual_information_test",
    "check_if_higher_similarity",
]

_BINS = 256
_GROUP_ELEMS = 1 << 26  # elements histogrammed per bincount (bounds its int64 index)


def _hists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N, M) u8 chunk pairs -> (N, 256, 256) int64 joint histograms."""
    n = a.shape[0]
    idx = a.to(torch.int64) * _BINS + b.to(torch.int64)
    idx += torch.arange(n, device=a.device).view(n, 1) * (_BINS * _BINS)
    counts = torch.bincount(idx.reshape(-1), minlength=n * _BINS * _BINS)
    return counts.view(n, _BINS, _BINS)


def _entropy(p: torch.Tensor, dims) -> torch.Tensor:
    """Shannon entropy in nats over ``dims``; 0 log 0 := 0."""
    return -torch.where(p > 0, p * torch.log(p.clamp_min(1e-300)), 0.0).sum(dims)


def _nmi_from_hists(hist: torch.Tensor) -> torch.Tensor:
    """(N, 256, 256) counts -> (N,) float64 NMI scores."""
    h = hist.to(torch.float64)
    pxy = h / h.sum((1, 2), keepdim=True)
    hx = _entropy(pxy.sum(2), 1)
    hy = _entropy(pxy.sum(1), 1)
    hxy = _entropy(pxy, (1, 2))
    mi = (hx + hy - hxy).clamp_min(0.0)
    denom = 0.5 * (hx + hy)
    # sklearn: two single-cluster labelings (0/0) score 1
    return torch.where(denom > 0, mi / denom.clamp_min(1e-300), 1.0)


def _chunk_scores(a: torch.Tensor, b: torch.Tensor, nchunks: int, chunk: int) -> torch.Tensor:
    """NMI of each of ``nchunks`` equal leading chunks, histogrammed in groups."""
    group = max(1, _GROUP_ELEMS // chunk)
    scores = []
    for c0 in range(0, nchunks, group):
        c1 = min(nchunks, c0 + group)
        sa = a[c0 * chunk : c1 * chunk].view(c1 - c0, chunk)
        sb = b[c0 * chunk : c1 * chunk].view(c1 - c0, chunk)
        scores.append(_nmi_from_hists(_hists(sa, sb)))
    return torch.cat(scores)


def _nmi_flat(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _chunk_scores(a, b, 1, a.numel())[0]


def mi_tiled_traced(arr1: torch.Tensor, arr2: torch.Tensor, tile_size: int) -> torch.Tensor:
    """Chunked-mean NMI of two u8 tensors as a 0-d float64 device tensor
    (no host round trip): flatten row-major, split at multiples of
    ``tile_size**2``, score each non-empty chunk, average."""
    a = arr1.reshape(-1)
    b = arr2.reshape(-1)
    if max(arr1.shape) / tile_size < 2:
        return _nmi_flat(a, b)
    chunk = tile_size * tile_size
    nfull = a.numel() // chunk
    scores = []
    if nfull > 0:
        scores.append(_chunk_scores(a, b, nfull, chunk))
    if a.numel() - nfull * chunk > 0:
        scores.append(_nmi_flat(a[nfull * chunk :], b[nfull * chunk :]).view(1))
    return torch.cat(scores).mean()


def nmi_u8(a, b) -> float:
    """Normalized mutual information of two u8 arrays (flattened)."""
    a = torch.as_tensor(a).reshape(-1)
    b = torch.as_tensor(b, device=a.device).reshape(-1)
    return float(_nmi_flat(a, b))


def mi_tiled(arr1, arr2, tile_size: int) -> float:
    """Host-value form of :func:`mi_tiled_traced`; takes numpy arrays or
    tensors."""
    a = torch.as_tensor(arr1)
    return float(mi_tiled_traced(a, torch.as_tensor(arr2, device=a.device), tile_size))


def mutual_information_test(ref_arr, test_arr, init_arr, tile_size: int) -> Tuple[float, float]:
    after = mi_tiled(ref_arr, test_arr, tile_size)
    before = mi_tiled(ref_arr, init_arr, tile_size)
    return after, before


def check_if_higher_similarity(ref_arr, test_arr, init_arr, tile_size: int) -> List[bool]:
    """``[MI(ref, test) > MI(ref, init)]``, the accept/reject gate."""
    after, before = mutual_information_test(ref_arr, test_arr, init_arr, tile_size)
    log("    MI score after:", after, "| MI score before:", before)
    return [after > before]
