"""K3's bf16 entry on the tensor cores (``csrc/agg_tc.cu``): its factor
table and its tiling, checked on the CPU before any card runs them.

* ``kernel_agg.tc_factor_table`` lays the bf16 operator out as the B
  fragments of ``mma.m16n8k16``, one slot a 32-output group.  Decoded here
  from that layout, every 128-output block's slice equals the JAX package's
  ``_band_factors(length, winsize)`` cast to bf16, trimmed to the block's
  128 + 2 R8 sources (R8 = r rounded up to 8); the rows trimmed away are
  zero in ``_band_factors``, and so is every entry of a block's slice that
  lies outside the k-steps its warps make.  Bar: equal.
* A blocked emulation of both passes with the kernel's tiling and offsets
  (bf16 operands, float32 products of each 16-source k-step, summed step
  after step; sources outside the axis staged as zeros; the interior
  groups reading the shared slot) against the plain version on small M.
  Bars: pass 1, the row pass stored in bf16, within one bf16 unit (2^-7 of
  the value) of ``smooth_w_plain``, since a float32 sum taken in another
  order can round to the neighbouring bf16 value, plus 2 (2r+1) 2^-24
  sum_k |c_k x_k|, the most two float32 sums of the same 2r+1 products can
  differ (the larger term where a sum of the signed planes cancels to a
  small fraction of its terms; the card's bar too); the flow within 1e-4 px
  in mean and 1e-2 px at most of ``smooth5_solve_plain``, the port's bar
  for the card against the CPU on this route.
"""

import numpy as np
import pytest
import torch

from microaligner_tpu.ops.pallas_agg import _band_factors
from microaligner_tpu_torch.ops import kernel_agg, kernel_poly
from microaligner_tpu_torch.optflow import farneback as tfb

torch.set_num_threads(1)

BF16 = torch.bfloat16


def _slot(g, gl, gt):
    return g if g < gl else gl if g < gt else gl + 1 + (g - gt)


def _decode(bits: np.ndarray) -> np.ndarray:
    """(steps, 2, 32, 8) bf16 bits of one slot -> B (16 steps, 32): lane l's
    8 values are b01 and b23 of n-tile 2p, then of n-tile 2p + 1; b01 holds
    rows k, k + 1 and b23 rows k + 8, k + 9 (k = 16 s + 2 (l % 4)) of column
    8 t + l // 4."""
    vals = torch.from_numpy(np.ascontiguousarray(bits)).view(BF16).float().numpy()
    steps = vals.shape[0]
    s, p, lane, e = np.meshgrid(np.arange(steps), np.arange(2), np.arange(32), np.arange(8), indexing="ij")
    reg = e // 2
    k = 16 * s + 2 * (lane % 4) + e % 2 + 8 * (reg % 2)
    j = 8 * (2 * p + reg // 2) + lane // 4
    out = np.full((16 * steps, 32), np.nan, np.float32)
    out[k, j] = vals
    assert not np.isnan(out).any()  # every (k, j) once
    return out


def _group_factors(n, win):
    """B of every 32-output group of an axis of n pixels, through the slot map."""
    bits, gl, gt = kernel_agg.tc_factor_table(n, win)
    groups, gl2, gt2 = kernel_agg.tc_groups(n, win)
    assert (gl, gt) == (gl2, gt2)
    assert bits.shape[0] == (gl + 1 + groups - gt if gl < gt else groups)
    return [_decode(bits[_slot(g, gl, gt)]) for g in range(groups)]


@pytest.mark.parametrize("win", [11, 49, 99, 257])
@pytest.mark.parametrize("n", [1, 2, 3, 127, 128, 129, 300, 1001])
def test_factor_table_is_the_tpu_band_factors(n, win):
    r = win // 2
    r8, kc, steps = kernel_agg.tc_halo(r), kernel_agg.tc_sources(r), kernel_agg.tc_steps(r)
    assert r8 % 8 == 0 and 0 <= r8 - r < 8 and kc == 128 + 2 * r8 and kc % 16 == 0
    assert kc == -(-(128 + 2 * r) // 16) * 16 and steps == (32 + 2 * r8) // 16
    want = torch.from_numpy(_band_factors(n, win)).to(BF16).float().numpy()  # (nb, 384, 128)
    groups = _group_factors(n, win)
    assert len(groups) == 4 * len(want)
    for c, block in enumerate(want):
        # block row jj is source 128 c - 128 + jj; the kernel stages 128 c - R8 + j, j < kc
        assert not block[: 128 - r8].any() and not block[128 - r8 + kc :].any()
        got = np.zeros((kc, 128), np.float32)
        for q in range(4):
            # group 4c + q reads sources from 128 c + 32 q - R8: rows 32 q .. 32 q + 16 steps
            got[32 * q : 32 * q + 16 * steps, 32 * q : 32 * q + 32] = groups[4 * c + q]
        np.testing.assert_array_equal(got, block[128 - r8 : 128 - r8 + kc])


def _tc_pass(x: torch.Tensor, win: int) -> torch.Tensor:
    """The kernel's sums along the last axis of float32 ``x`` (bf16 values):
    each 32-output group multiplies its 32 + 2 R8 staged sources by its B,
    one float32 product a k-step of 16 sources, summed step after step."""
    n = x.shape[-1]
    r = win // 2
    r8, steps = kernel_agg.tc_halo(r), kernel_agg.tc_steps(r)
    out = torch.zeros(x.shape[:-1] + (n,), dtype=torch.float32)
    for g, b in enumerate(_group_factors(n, win)):
        if 32 * g >= n:
            continue
        src = torch.arange(32 * g - r8, 32 * g - r8 + 16 * steps)
        staged = torch.where((src >= 0) & (src < n), x[..., src.clamp(0, n - 1)], torch.zeros(()))
        b = torch.from_numpy(b)
        acc = torch.zeros(x.shape[:-1] + (32,), dtype=torch.float32)
        for s in range(steps):
            acc = acc + staged[..., 16 * s : 16 * s + 16] @ b[16 * s : 16 * s + 16]
        out[..., 32 * g : min(32 * g + 32, n)] = acc[..., : min(32, n - 32 * g)]
    return out


def _real_m(rng, n, h, w):
    """bf16 normal equations of a smooth texture and a copy moved by (1, -1) px."""
    from scipy.ndimage import gaussian_filter

    base = gaussian_filter(rng.random((h + 8, w + 8)).astype(np.float32), 2.0) * 255
    scale = np.linspace(1.0, 0.6, n, dtype=np.float32).reshape(n, 1, 1)
    mov = torch.from_numpy((base[4 : 4 + h, 4 : 4 + w][None] * scale).astype(np.float32))
    ref = torch.from_numpy((base[3 : 3 + h, 5 : 5 + w][None] * scale).astype(np.float32))
    sp0, sp1 = (tfb._pad_replicate1(tfb._pre_smooth(t)) for t in (mov, ref))
    return kernel_poly.poly_pair_m_plain(sp0, sp1, tfb._poly_coeff_tuple(1, 1.7), BF16, BF16)[2]


@pytest.mark.parametrize("n,h,w,win", [
    pytest.param(1, 70, 300, 99, id="win99-w300"),
    pytest.param(2, 40, 30, 99, id="win99-n2-h-and-w-below-r"),
    pytest.param(1, 150, 133, 49, id="win49-w-not-on-8"),
    pytest.param(1, 129, 64, 11, id="win11-h129"),
    pytest.param(1, 3, 260, 257, id="win257-h3"),
    pytest.param(3, 1, 5, 11, id="win11-h1"),
    pytest.param(2, 6, 1, 11, id="win11-w1"),
])
def test_blocked_emulation_agrees_with_the_plain_version(rng, n, h, w, win):
    M = _real_m(rng, n, h, w)
    row = _tc_pass(M.float(), win).to(BF16)
    want_row = kernel_agg.smooth_w_plain(M, win)
    err = (row.float() - want_row.float()).abs()
    sums = kernel_agg.smooth_axis_plain(M.abs(), kernel_agg.agg_kernel(win), -1)
    assert bool((err <= 2.0**-7 * want_row.float().abs() + 2 * (2 * (win // 2) + 1) * 2.0**-24 * sums).all())
    s = _tc_pass(row.float().transpose(-1, -2), win).transpose(-1, -2)
    g11, g12, g22, h1, h2 = s.unbind(1)
    idet = 1.0 / (g11 * g22 - g12 * g12 + 1e-3)
    got = ((g11 * h2 - g12 * h1) * idet, (g22 * h1 - g12 * h2) * idet)
    for a, b in zip(got, kernel_agg.smooth5_solve_plain(M, win)):
        d = (a - b).abs()
        assert float(d.mean()) <= 1e-4 and float(d.max()) <= 1e-2, (float(d.mean()), float(d.max()))


def test_interior_groups_share_one_slot():
    """At the main path's window, a 4296-pixel axis needs 2 slots before its
    interior, one for it and 4 after (the last block's 32 outputs past the
    axis among them): 7 slots for 136 groups, 9 KB each."""
    groups, gl, gt = kernel_agg.tc_groups(4296, 99)
    assert (groups, gl, gt) == (136, 2, 132)
    bits = kernel_agg.tc_factor_table(4296, 99)[0]
    assert bits.shape == (7, 9, 2, 32, 8) and bits.nbytes == 7 * 9 * 1024
