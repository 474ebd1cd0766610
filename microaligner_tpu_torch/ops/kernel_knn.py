"""K8: FeatureReg's exact knn top-2 on the bf16 operand route, one launch a call.

Replaces no TPU kernel: the JAX package leaves its knn to XLA
(``microaligner_tpu/features/match.py``).  On the card the plain version,
:func:`top2_plain`, writes every query-train distance to device memory: a
chunk of queries at a time (as many as ``CHUNK_ELEMS`` entries allow), one
cuBLAS product with a float32 output, then the distance formula, the clamp,
the min, the scatter and the amin, each a pass over the chunk's float32
entries, about 50 bytes of device memory an entry.

``csrc/knn.cu`` computes the same top-2 of the bf16 route in one launch and
keeps every distance in registers: the cross term of the bf16 operands
summed in float32 on the tensor cores (``wgmma``, the train rows streamed
by TMA), ``d = max(((qn + tn) - 2 cross) + tmask, 0)`` rounded where the
plain version rounds, and the running ``(d1, i1, d2)`` of each query row
(on equal ``d`` the smaller train index; a tie counts as the runner-up).
Its sums are taken in another order than cuBLAS's, which
``features/match.py``'s error argument covers.  It allocates nothing but
its three outputs.
"""

from __future__ import annotations

import torch

from microaligner_tpu_torch.ops import cuda_lib
from microaligner_tpu_torch.ops.filters import ieee_float32, product_f32

__all__ = ["BIG", "CHUNK_ELEMS", "MAX_WIDTH", "top2_plain", "top2_bf16"]

BIG = 3.4e38  # a masked train row's distance
CHUNK_ELEMS = 1 << 27  # distance entries per query chunk of the plain version
MAX_WIDTH = 256  # csrc/knn.cu's kMaxWidth


def top2_plain(q_op: torch.Tensor, t_op: torch.Tensor, qn: torch.Tensor, tn: torch.Tensor,
               t_valid: torch.Tensor, chunk: int = 4096):
    """Plain PyTorch version of K8, in the norms' dtype: ``(d1, d2, idx1)``
    over ``chunk`` query rows at a time, fewer when a chunk would pass
    ``CHUNK_ELEMS`` entries.  bf16 operands with float32 norms sum the cross
    term in float32 (:func:`product_f32`); otherwise the operands are in the
    norms' dtype and so is the product."""
    top2_plain.calls += 1
    tmask = torch.where(t_valid, 0.0, BIG).to(qn.dtype)
    step = max(1, min(chunk, CHUNK_ELEMS // max(1, t_op.shape[0])))
    d1s, d2s, i1s = [], [], []
    with ieee_float32():
        for s in range(0, q_op.shape[0], step):
            qs = q_op[s : s + step]
            cross = product_f32(qs, t_op.T) if qs.dtype == torch.bfloat16 else torch.matmul(qs, t_op.T)
            d = qn[s : s + step, None] + tn[None, :] - 2.0 * cross + tmask[None, :]
            del cross
            d.clamp_min_(0.0)
            d1, i1 = torch.min(d, dim=1)
            d.scatter_(1, i1[:, None], BIG)  # the nearest out: the runner-up is the min
            d1s.append(d1)
            d2s.append(torch.amin(d, dim=1))
            i1s.append(i1)
            del d
    return torch.cat(d1s), torch.cat(d2s), torch.cat(i1s)


top2_plain.calls = 0


def _check(q_op, t_op, qn, tn, t_valid) -> None:
    for name, x in (("query", q_op), ("train", t_op)):
        if x.dtype != torch.bfloat16 or x.dim() != 2:
            raise ValueError(f"knn_top2: {name} must be 2-D bfloat16, got {x.dtype} of shape {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"knn_top2: {name} rows must be contiguous, got strides {x.stride()}")
    (nq, w), nt = q_op.shape, t_op.shape[0]
    if t_op.shape[1] != w:
        raise ValueError(f"knn_top2: query width {w} and train width {t_op.shape[1]} differ")
    if w % 8 or not 8 <= w <= MAX_WIDTH:
        raise ValueError(f"knn_top2: width {w} is not a multiple of 8 in [8, {MAX_WIDTH}]")
    if nq < 1 or nt < 1:
        raise ValueError(f"knn_top2: {nq} query and {nt} train rows; both need at least one")
    for name, x, n in (("qn", qn, nq), ("tn", tn, nt)):
        if x.dtype != torch.float32 or tuple(x.shape) != (n,) or not x.is_contiguous():
            raise ValueError(f"knn_top2: {name} must be contiguous float32 of shape ({n},), got {x.dtype} "
                             f"{tuple(x.shape)}")
    if t_valid.dtype != torch.bool or tuple(t_valid.shape) != (nt,):
        raise ValueError(f"knn_top2: t_valid must be bool of shape ({nt},), got {t_valid.dtype} "
                         f"{tuple(t_valid.shape)}")


def top2_bf16(q_op: torch.Tensor, t_op: torch.Tensor, qn: torch.Tensor, tn: torch.Tensor,
              t_valid: torch.Tensor):
    """For each row of the bf16 queries ``q_op`` (Q, W): the least distance
    ``d1`` to the bf16 train rows ``t_op`` (T, W), its train index ``idx1``
    and the least of the rest ``d2``, with ``qn`` and ``tn`` the float32
    squared norms of the unrounded rows and ``t_valid`` (T,) the valid train
    rows.  Returns float32, float32 and int64 tensors, each (Q,).  W is a
    multiple of 8 up to ``MAX_WIDTH`` and the rows are contiguous.  CPU
    tensors take :func:`top2_plain`; CUDA tensors launch K8 or raise."""
    _check(q_op, t_op, qn, tn, t_valid)
    if q_op.device.type == "cpu":
        return top2_plain(q_op, t_op, qn, tn, t_valid)
    cuda_lib.require_cuda(q_op, t_op, qn, tn, t_valid)
    for x in (q_op, t_op):
        if x.data_ptr() % 16:
            raise ValueError("knn_top2: rows must start on 16 bytes")
    (nq, w), nt = q_op.shape, t_op.shape[0]
    valid = t_valid.contiguous().view(torch.uint8)
    d1 = torch.empty(nq, dtype=torch.float32, device=q_op.device)
    d2 = torch.empty(nq, dtype=torch.float32, device=q_op.device)
    i1 = torch.empty(nq, dtype=torch.int64, device=q_op.device)
    cuda_lib.call("ma_knn_top2", q_op.device, q_op, t_op, qn, tn, valid, nq, nt, w, d1, d2, i1)
    top2_bf16.launches += 1
    return d1, d2, i1


top2_bf16.launches = 0  # calls that launched K8
