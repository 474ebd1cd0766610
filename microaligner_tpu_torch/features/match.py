"""Exact knn matching and the Lowe ratio filter.

PyTorch counterpart of ``microaligner_tpu/features/match.py``, which
replaces ``cv.FlannBasedMatcher.knnMatch(des_mov, des_ref, k=2)`` and the
0.5 ratio test with an exact top-2 over squared distances
d = |q|^2 + |t|^2 - 2 q.t.  FLANN reports unsquared distances, so the
ratio 0.5 compares ``d1 < 0.25 * d2`` on the squared ones.

Two routes for the cross term, as the JAX package picks them
(``MICROALIGNER_TPU_MATCH_F32``, ``features/routes.py``):

* float32 (the CPU, or the variable ``1``): a float32 product, TF32 off;
* bf16 (the card, unless the variable is ``1``): q and t rounded to bf16
  (round to nearest even), their products summed in float32, while |q|^2
  and |t|^2 stay the float32 sums of the unrounded descriptors.  So
  d = |q|^2 + |t|^2 - 2 q~.t~ is a mixed formula, not a distance between
  rounded vectors.  On the card the whole top-2 is one launch of K8
  (``ops/kernel_knn.py``), which keeps the distances in registers; on the
  CPU the plain version sums through ``ops/filters.py::product_f32``.

Near-ties.  The CPU's BLAS and cuBLAS sum in different orders, so a query
whose ratio test lies within float32 rounding of its threshold could pass
on one device and fail on the other.  :func:`match_descriptors` decides
every such near-tie again in float64, over every train row and with the
route's own formula (on the bf16 route: float64 norms of the unrounded
descriptors and the float64 product of the rounded ones), and takes its
decision and nearest index.  A query is a near-tie when
|d1 - 0.25 d2| <= TOL * (|q|^2 + (kappa |q| + sqrt(d2))^2).  With
u = 2^-24 and E = |q|^2 + |t|^2:

* float32 (TOL 2^-14, kappa 1): a distance is within 406 u E of exact
  (three 200-term sums of products, three additions).  The rows that can
  be the nearest or the runner-up lie within sqrt(d2) of q, so
  |t| <= |q| + sqrt(d2) and E is bounded by the scale above, whatever the
  norms of the other rows (raw DAISY descriptors,
  ``MICROALIGNER_TPU_DAISY_NRM=0``, spread widely).  The test is within
  1.25 times that, about 2^-15 of the scale; twice it covers d2's own
  rounding in the scale.
* bf16 (TOL 2^-13, kappa 1.134): rounding each element to bf16 moves it by
  at most u_b = 2^-8 of itself, so |q.t - q~.t~| <= (2 u_b + u_b^2) |q||t|
  and d differs from |q - t|^2 by at most c |q||t|, c = 2^-6 + 2^-15.  A
  row that can be the nearest or the runner-up has d <= d2, so
  (|t| - |q|)^2 <= |q - t|^2 <= d2 + c |q||t|; solving that quadratic for
  |t| gives |t| <= (1 + c/2 + sqrt(c + c^2/4)) |q| + sqrt(d2), and
  1 + c/2 + sqrt(c + c^2/4) = 1.1332 < kappa.  In float32, |q|^2 and |t|^2
  are within 199 u of their sums as before; the cross term's 200 exact
  products sum to at most (1 + u_b)^2 |q||t| <= 0.504 E, and the tensor
  cores may truncate each addition (an error up to 2 u), so 2 q~.t~ is
  within 2 * 199 * 2u * 0.504 E = 402 u E; with the three additions a
  distance is within 605 u E, the test within 1.25 times that, under
  2^-14 of the scale; twice it is TOL.  The argument holds for any order
  of the float32 sums: cuBLAS's (a wgmma kernel), K8's wgmma k-steps
  and the CPU's.

The nearest index of a match that passes is never a near-tie on either
route: it beats the runner-up by more than 3/4 of d2, and d2 is then more
than 4 TOL times the scale.
"""

from __future__ import annotations

import torch

from microaligner_tpu_torch.features.routes import match_operand_dtype
from microaligner_tpu_torch.ops import kernel_knn
from microaligner_tpu_torch.utils.logging import counter, profiling_enabled, span

__all__ = ["knn_top2", "match_descriptors", "near_ties"]

# the near-tie rule of each route (module docstring): TOL and kappa
_TIE_TOL = {torch.float32: 2.0**-14, torch.bfloat16: 2.0**-13}
_KAPPA = {torch.float32: 1.0, torch.bfloat16: 1.134}
# queries decided again in float64: calls of match_descriptors, rows in all, most in one call
near_ties = {"calls": 0, "rows": 0, "max": 0}


def k8_route(query: torch.Tensor, operand_dtype: torch.dtype) -> bool:
    """Whether :func:`_top2` launches K8 (``ops/kernel_knn.py``): float32
    descriptors on the card with bf16 operands, the card's default route.
    The CPU, the float32 route and the float64 re-decision take the plain
    version."""
    return query.device.type == "cuda" and query.dtype == torch.float32 and operand_dtype == torch.bfloat16


def _top2(query: torch.Tensor, train: torch.Tensor, t_valid: torch.Tensor, chunk: int,
          operand_dtype: torch.dtype = torch.float32):
    """``(d1, d2, idx1, |q|^2, |t|^2)`` in the inputs' dtype.  The cross
    term takes ``operand_dtype`` operands: bf16 rounds both sides and, for
    float32 inputs, sums in float32, for float64 inputs in float64; the
    norms are always the unrounded inputs'.  On :func:`k8_route` one K8
    launch, otherwise the plain version, ``chunk`` query rows at a time."""
    if operand_dtype not in _TIE_TOL:
        raise ValueError(f"knn: operand dtype {operand_dtype} is neither float32 nor bf16")
    qn = torch.sum(query * query, dim=1)
    tn = torch.sum(train * train, dim=1)
    q_op, t_op = query, train
    if operand_dtype == torch.bfloat16:
        q_op, t_op = query.to(torch.bfloat16).contiguous(), train.to(torch.bfloat16).contiguous()
        if k8_route(query, operand_dtype):
            return (*kernel_knn.top2_bf16(q_op, t_op, qn, tn, t_valid), qn, tn)
        if query.dtype != torch.float32:  # the float64 re-decision of the mixed formula
            q_op, t_op = q_op.to(query.dtype), t_op.to(query.dtype)
    return (*kernel_knn.top2_plain(q_op, t_op, qn, tn, t_valid, chunk), qn, tn)


def knn_top2(query: torch.Tensor, train: torch.Tensor, q_valid: torch.Tensor,
             t_valid: torch.Tensor, chunk: int = 4096, operand_dtype: torch.dtype | None = None):
    """For each query row: the two smallest squared L2 distances over the
    valid train rows and the index of the nearest, in float32.  Returns
    ``(d1, d2, idx1)``, each (Q,).  ``operand_dtype`` is the cross term's
    (float32 or bf16); None reads :func:`match_operand_dtype` for the
    query's device."""
    if operand_dtype is None:
        operand_dtype = match_operand_dtype(query.device)
    d1, d2, i1, _, _ = _top2(query.to(torch.float32), train.to(torch.float32), t_valid, chunk, operand_dtype)
    return d1, d2, i1


def match_descriptors(des_ref: torch.Tensor, des_mov: torch.Tensor, ref_valid: torch.Tensor,
                      mov_valid: torch.Tensor, ratio: float = 0.5, operand_dtype: torch.dtype | None = None):
    """Ratio-filtered matches mov -> ref (query = mov, train = ref): keep
    ``d1 < ratio * d2`` on unsquared distances, near-ties decided in
    float64 (one host round trip for their count, kept in
    :data:`near_ties`).  ``operand_dtype`` as :func:`knn_top2`.  Returns
    ``(good (Q,) bool, ref_idx (Q,) int64)`` aligned with the mov rows.

    Under ``MICROALIGNER_TPU_PROFILE`` each call records a ``features.knn``
    counter (capacity and valid rows of both sides, the valid counts as
    device scalars, the descriptor width, the operand dtype, the near-tie
    rows and the ``path``, ``"k8"`` or ``"plain"``) and the re-decision is
    a ``features.near_ties`` span."""
    if operand_dtype is None:
        operand_dtype = match_operand_dtype(des_mov.device)
    r2 = ratio * ratio
    query, train = des_mov.to(torch.float32), des_ref.to(torch.float32)
    d1, d2, i1, qn, _ = _top2(query, train, ref_valid, 4096, operand_dtype)
    good = (d1 < r2 * d2) & mov_valid
    scale = qn + torch.square(_KAPPA[operand_dtype] * torch.sqrt(qn) + torch.sqrt(d2))
    sel = torch.nonzero((torch.abs(d1 - r2 * d2) <= _TIE_TOL[operand_dtype] * scale) & mov_valid).squeeze(1)
    n = sel.numel()
    near_ties.update(calls=near_ties["calls"] + 1, rows=near_ties["rows"] + n, max=max(near_ties["max"], n))
    if profiling_enabled():
        counter("features.knn", query_rows=query.shape[0], train_rows=train.shape[0],
                query_valid=mov_valid.sum(), train_valid=ref_valid.sum(), width=query.shape[1],
                dtype=str(operand_dtype).removeprefix("torch."), ties=n,
                path="k8" if k8_route(query, operand_dtype) else "plain")
    if n:
        with span("features.near_ties", query.device, rows=n):
            e1, e2, ei, _, _ = _top2(query[sel].double(), train.double(), ref_valid, 4096, operand_dtype)
            good[sel] = e1 < r2 * e2
            i1[sel] = ei
    return good, i1
