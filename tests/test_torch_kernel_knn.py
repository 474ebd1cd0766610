"""K8's dispatch and contract, seen on the CPU.

``features/match.py::_top2`` launches K8 (``ops/kernel_knn.py``) only for
float32 descriptors on the card with bf16 operands; the CPU, the float32
route (``MICROALIGNER_TPU_MATCH_F32=1``) and the float64 re-decision of
near-ties take the plain version.  The wrapper refuses what the kernel does
not take before it looks at the device, so its refusals are seen here.  The
plain version's top-2 contract, which K8 keeps on the card
(``tests/test_torch_kernels_cuda.py::test_k8``), is held here against a
float64 run of the same formula: ties to the smaller index and counted as
the runner-up, ``_BIG`` where fewer than two train rows are valid.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from microaligner_tpu_torch.features import match
from microaligner_tpu_torch.ops import kernel_knn

torch.set_num_threads(1)
F32, F64, BF16 = torch.float32, torch.float64, torch.bfloat16


@pytest.mark.parametrize("device,dtype,operand,want", [
    ("cuda", F32, BF16, True), ("cuda", F32, F32, False), ("cuda", F64, BF16, False), ("cpu", F32, BF16, False),
    ("cpu", F32, F32, False), ("cpu", F64, BF16, False)],
    ids=["card-bf16", "card-f32-route", "card-f64-redecision", "cpu-bf16", "cpu-f32", "cpu-f64"])
def test_k8_route(device, dtype, operand, want):
    assert match.k8_route(SimpleNamespace(device=torch.device(device), dtype=dtype), operand) is want


def _descriptors(rng, n, w=200):
    x = rng.random((n, w)) ** 3
    return torch.from_numpy((x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32))


def _near_tie_inputs(rng, n=24, d=200):
    """Queries whose ratio test lies within float32 rounding of 0.5, as in
    the card's near-tie test: (train, query, train valid, query valid)."""
    basis = np.linalg.qr(rng.standard_normal((d, d)))[0]
    eps = rng.uniform(-3e-7, 3e-7, n)
    offset = 4.0 * basis[3::4][:n]
    query = (basis[0::4][:n] + offset).astype(np.float32)
    near = basis[1::4][:n] * np.sqrt(1.0 + 2.0 * eps)[:, None] + offset
    far = basis[2::4][:n] * np.sqrt(7.0) + offset
    noise = rng.random((200, d))
    train = np.concatenate([near, far, 10.0 * noise / np.linalg.norm(noise, axis=1, keepdims=True)])
    return (torch.from_numpy(train.astype(np.float32)), torch.from_numpy(query),
            torch.ones(len(train), dtype=torch.bool), torch.ones(n, dtype=torch.bool))


def test_cpu_takes_the_plain_version(monkeypatch):
    """On the CPU no route reaches K8's wrapper."""
    def refuse(*args):
        raise AssertionError("K8's wrapper called on the CPU")

    monkeypatch.setattr(kernel_knn, "top2_bf16", refuse)
    rng = np.random.default_rng(3)
    query, train = _descriptors(rng, 40), _descriptors(rng, 70)
    valid = torch.ones(70, dtype=torch.bool)
    calls = kernel_knn.top2_plain.calls
    for q, t, operand in ((query, train, BF16), (query, train, F32), (query.double(), train.double(), BF16)):
        d1, d2, i1, _, _ = match._top2(q, t, valid, 4096, operand)
        assert d1.dtype == q.dtype and i1.dtype == torch.int64
    assert kernel_knn.top2_plain.calls == calls + 3


def test_match_descriptors_launches_k8_once_and_redecides_plain(monkeypatch):
    """Where the route is K8's, ``match_descriptors`` launches it once, with
    the bf16 operands and the float32 norms, and decides its near-ties
    again through the plain version in float64; the float32 route never
    reaches it."""
    launched = []

    def fake_k8(q_op, t_op, qn, tn, t_valid):
        launched.append((q_op.dtype, t_op.dtype, qn.dtype, tn.dtype, q_op.is_contiguous(), t_op.is_contiguous()))
        return kernel_knn.top2_plain(q_op, t_op, qn, tn, t_valid)

    monkeypatch.setattr(match, "k8_route", lambda query, operand: query.dtype == F32 and operand == BF16)
    monkeypatch.setattr(kernel_knn, "top2_bf16", fake_k8)
    args = _near_tie_inputs(np.random.default_rng(4))
    plain_calls, rows = kernel_knn.top2_plain.calls, match.near_ties["rows"]
    good, idx = match.match_descriptors(*args, operand_dtype=BF16)
    assert launched == [(BF16, BF16, F32, F32, True, True)]
    assert match.near_ties["rows"] > rows  # the plain version ran again on the near-ties, in float64
    assert kernel_knn.top2_plain.calls == plain_calls + 2
    match.match_descriptors(*args, operand_dtype=F32)
    assert len(launched) == 1
    monkeypatch.undo()
    want_good, want_idx = match.match_descriptors(*args, operand_dtype=BF16)
    assert torch.equal(good, want_good) and torch.equal(idx, want_idx)


def _k8_args(nq=5, nt=7, w=200, dtype=BF16):
    return (torch.zeros((nq, w), dtype=dtype), torch.zeros((nt, w), dtype=dtype), torch.zeros(nq), torch.zeros(nt),
            torch.ones(nt, dtype=torch.bool))


@pytest.mark.parametrize("case", ["width-204", "width-264", "width-0", "float16", "float32", "rows-strided",
                                  "train-transposed", "widths-differ", "no-query", "no-train", "norms-float64",
                                  "valid-uint8"])
def test_k8_refuses(case):
    args = list(_k8_args())
    if case == "width-204":
        args[:2] = (torch.zeros((5, 204), dtype=BF16), torch.zeros((7, 204), dtype=BF16))
    elif case == "width-264":
        args[:2] = (torch.zeros((5, 264), dtype=BF16), torch.zeros((7, 264), dtype=BF16))
    elif case == "width-0":
        args[:2] = (torch.zeros((5, 0), dtype=BF16), torch.zeros((7, 0), dtype=BF16))
    elif case in ("float16", "float32"):
        args[:2] = _k8_args(dtype=torch.float16 if case == "float16" else F32)[:2]
    elif case == "rows-strided":
        args[0] = torch.zeros((5, 400), dtype=BF16)[:, ::2]
    elif case == "train-transposed":
        args[1] = torch.zeros((200, 7), dtype=BF16).T
    elif case == "widths-differ":
        args[1] = torch.zeros((7, 208), dtype=BF16)
    elif case == "no-query":
        args[0], args[2] = torch.zeros((0, 200), dtype=BF16), torch.zeros(0)
    elif case == "no-train":
        args[1], args[3], args[4] = torch.zeros((0, 200), dtype=BF16), torch.zeros(0), torch.ones(0, dtype=torch.bool)
    elif case == "norms-float64":
        args[2] = torch.zeros(5, dtype=F64)
    elif case == "valid-uint8":
        args[4] = torch.ones(7, dtype=torch.uint8)
    launches = kernel_knn.top2_bf16.launches
    with pytest.raises(ValueError, match="knn_top2"):
        kernel_knn.top2_bf16(*args)
    assert kernel_knn.top2_bf16.launches == launches


@pytest.mark.parametrize("mask", ["all", "interleaved", "one", "none", "duplicates"])
@pytest.mark.parametrize("nq,nt,w", [(33, 130, 200), (7, 2, 8), (1, 1, 16)], ids=["200", "8", "16"])
def test_top2_contract(mask, nq, nt, w):
    """The plain version, which K8 keeps: within float32 rounding of the
    float64 run of the bf16 route's formula, ties (exact duplicate train
    rows) to the smaller index with the tie as the runner-up, ``_BIG`` where
    masked; and K8's wrapper on the CPU gives the plain version's result
    without a launch."""
    rng = np.random.default_rng(nq * 1000 + nt)
    train = _descriptors(rng, nt, w)
    valid = torch.ones(nt, dtype=torch.bool)
    if mask == "duplicates":
        train[nt // 2 : 2 * (nt // 2)] = train[: nt // 2]
    elif mask == "interleaved":
        valid = torch.from_numpy(rng.random(nt) > 0.4)
    elif mask == "one":
        valid[:] = False
        valid[nt - 1] = True
    elif mask == "none":
        valid[:] = False
    query = train[torch.from_numpy(rng.integers(0, nt, nq))] + 0.05 * _descriptors(rng, nq, w)
    q_op, t_op = query.to(BF16), train.to(BF16)
    qn, tn = (query * query).sum(1), (train * train).sum(1)
    launches = kernel_knn.top2_bf16.launches
    d1, d2, i1 = kernel_knn.top2_bf16(q_op, t_op, qn, tn, valid)
    assert kernel_knn.top2_bf16.launches == launches
    for got, want in zip((d1, d2, i1), kernel_knn.top2_plain(q_op, t_op, qn, tn, valid)):
        assert torch.equal(got, want)

    exact = (qn.double()[:, None] + tn.double()[None, :] - 2 * q_op.double() @ t_op.double().T).clamp_min(0.0)
    exact = torch.where(valid[None, :], exact, kernel_knn.BIG)
    big = torch.tensor(kernel_knn.BIG, dtype=F32)
    bar = 2 * 605 * 2.0**-24 * (qn.double() + float(tn.max()))
    n_valid = int(valid.sum())
    if n_valid == 0:
        assert bool((d1 == big).all()) and bool((i1 == 0).all())
    else:
        assert bool(((d1.double() - exact.min(1).values).abs() <= bar).all())
        assert bool(valid[i1].all())
    if n_valid < 2:
        assert bool((d2 == big).all())
    if mask == "duplicates" and nt >= 2:
        half = nt // 2
        twin = (i1 < half) & (exact.gather(1, i1[:, None]).squeeze(1) == exact.gather(1, (i1 + half)[:, None]).squeeze(1))
        assert bool(twin.any())
        assert torch.equal(d2[twin], d1[twin])  # the duplicate is the runner-up at the same distance
