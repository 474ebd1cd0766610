"""Exact knn matching and the Lowe ratio filter.

PyTorch counterpart of ``microaligner_tpu/features/match.py``, which
replaces ``cv.FlannBasedMatcher.knnMatch(des_mov, des_ref, k=2)`` and the
0.5 ratio test with an exact top-2 over squared distances
|q|^2 + |t|^2 - 2 q.t, in float32 with TF32 off (the JAX package's bf16
cross term is TPU-only).  FLANN reports unsquared distances, so the ratio
0.5 compares ``d1 < 0.25 * d2`` on the squared ones.

The CPU's BLAS and cuBLAS sum the float32 cross term in different orders,
so a query whose ratio test lies within float32 rounding of its threshold
could pass on one device and fail on the other.  :func:`match_descriptors`
decides every such near-tie again with float64 distances over every train
row, and takes its float64 decision and nearest index.  The rounding bound
is each query's own: the rows that can be its nearest or runner-up lie
within sqrt(d2) of it, so their norms are bounded by its norm and d2,
whatever the norms of the other rows.  Raw DAISY descriptors
(``MICROALIGNER_TPU_DAISY_NRM=0``), whose norms spread widely, need that.
The nearest index of a match that passes is never a near-tie: it beats the
runner-up by more than 3/4 of d2.
"""

from __future__ import annotations

import torch

from microaligner_tpu_torch.ops.filters import ieee_float32

__all__ = ["knn_top2", "match_descriptors", "near_ties"]

_BIG = 3.4e38
_CHUNK_ELEMS = 1 << 27  # distance entries per query chunk
# bound on float32's error in d1 - ratio^2 * d2, relative to |q|^2 + (|q| + sqrt(d2))^2,
# which bounds |q|^2 + |t|^2 over the rows that can be the nearest or the runner-up: a
# distance is within 406 * 2^-24 (|q|^2 + |t|^2) of exact (three 200-term sums of products,
# three additions), the test within 1.25 times that, about 2^-15; twice it covers d2's rounding
_TIE_TOL = 2.0**-14
# queries decided again in float64: calls of match_descriptors, rows in all, most in one call
near_ties = {"calls": 0, "rows": 0, "max": 0}


def _top2(query: torch.Tensor, train: torch.Tensor, t_valid: torch.Tensor, chunk: int):
    """``(d1, d2, idx1, |q|^2, |t|^2)`` in the inputs' dtype, ``chunk``
    query rows at a time, fewer when a chunk would pass 2**27 entries."""
    qn = torch.sum(query * query, dim=1)
    tn = torch.sum(train * train, dim=1)
    tmask = torch.where(t_valid, 0.0, _BIG).to(query.dtype)
    step = max(1, min(chunk, _CHUNK_ELEMS // max(1, train.shape[0])))
    d1s, d2s, i1s = [], [], []
    with ieee_float32():
        for s in range(0, query.shape[0], step):
            cross = torch.matmul(query[s : s + step], train.T)
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


def knn_top2(query: torch.Tensor, train: torch.Tensor, q_valid: torch.Tensor,
             t_valid: torch.Tensor, chunk: int = 4096):
    """For each query row: the two smallest squared L2 distances over the
    valid train rows and the index of the nearest, in float32.  Returns
    ``(d1, d2, idx1)``, each (Q,)."""
    d1, d2, i1, _, _ = _top2(query.to(torch.float32), train.to(torch.float32), t_valid, chunk)
    return d1, d2, i1


def match_descriptors(des_ref: torch.Tensor, des_mov: torch.Tensor, ref_valid: torch.Tensor,
                      mov_valid: torch.Tensor, ratio: float = 0.5):
    """Ratio-filtered matches mov -> ref (query = mov, train = ref): keep
    ``d1 < ratio * d2`` on unsquared distances, near-ties decided in
    float64 (one host round trip for their count, kept in
    :data:`near_ties`).  Returns ``(good (Q,) bool, ref_idx (Q,) int64)``
    aligned with the mov rows."""
    r2 = ratio * ratio
    query, train = des_mov.to(torch.float32), des_ref.to(torch.float32)
    d1, d2, i1, qn, _ = _top2(query, train, ref_valid, 4096)
    good = (d1 < r2 * d2) & mov_valid
    scale = qn + torch.square(torch.sqrt(qn) + torch.sqrt(d2))
    sel = torch.nonzero((torch.abs(d1 - r2 * d2) <= _TIE_TOL * scale) & mov_valid).squeeze(1)
    n = sel.numel()
    near_ties.update(calls=near_ties["calls"] + 1, rows=near_ties["rows"] + n, max=max(near_ties["max"], n))
    if n:
        e1, e2, ei, _, _ = _top2(query[sel].double(), train.double(), ref_valid, 4096)
        good[sel] = e1 < r2 * e2
        i1[sel] = ei
    return good, i1
