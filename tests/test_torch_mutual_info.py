"""The port's NMI gate against the JAX package and sklearn.

The port takes the entropies in float64 from exact integer histograms, so it
matches sklearn, the reference's own scorer, to float64 rounding (1e-12).
The JAX package takes its logs and sums its 65,536-cell entropies in
float32: measured here it strays up to 1.6e-6 from sklearn on a 64 x 70
pair and 2.3e-6 on 420 x 440, so the bar against it is 5e-6.
"""

import numpy as np
import pytest
import torch
from sklearn.metrics import normalized_mutual_info_score

from microaligner_tpu.ops import mutual_info as jmi
from microaligner_tpu_torch.ops import mutual_info as tmi

torch.set_num_threads(1)

ATOL_JAX = 5e-6  # the JAX side's float32 entropy error, see above


def _pair(rng, shape, noise):
    a = rng.integers(0, 256, size=shape).astype(np.uint8)
    b = np.clip(a.astype(int) + rng.integers(-noise, noise + 1, size=shape), 0, 255).astype(np.uint8)
    return a, b


@pytest.mark.parametrize("shape,noise", [((64, 70), 20), ((100, 90), 60), ((48, 50), 0)])
def test_nmi_u8(rng, shape, noise):
    a, b = _pair(rng, shape, noise)
    got = tmi.nmi_u8(a, b)
    assert abs(got - jmi.nmi_u8(a, b)) <= ATOL_JAX
    assert abs(got - normalized_mutual_info_score(a.ravel(), b.ravel())) <= 1e-12


def test_nmi_constant_images():
    a = np.full((20, 20), 3, np.uint8)
    b = np.full((20, 20), 9, np.uint8)
    assert tmi.nmi_u8(a, b) == jmi.nmi_u8(a, b) == 1.0
    c = np.arange(400, dtype=np.uint8).reshape(20, 20)
    assert abs(tmi.nmi_u8(a, c) - jmi.nmi_u8(a, c)) <= ATOL_JAX


@pytest.mark.parametrize("shape,tile", [((90, 110), 30), ((100, 100), 50), ((70, 80), 50)])
def test_mi_tiled(rng, shape, tile):
    """Chunked mean over tile**2-element chunks with a partial last chunk,
    and the whole-image gate when max(shape) / tile < 2."""
    a, b = _pair(rng, shape, 40)
    got = tmi.mi_tiled(a, b, tile)
    assert abs(got - jmi.mi_tiled(a, b, tile)) <= ATOL_JAX
    traced = tmi.mi_tiled_traced(torch.from_numpy(a), torch.from_numpy(b), tile)
    assert traced.dim() == 0 and float(traced) == got


def test_chunk_groups_cover_every_chunk(rng, monkeypatch):
    """Histogramming in groups of chunks gives the same scores."""
    a, b = _pair(rng, (90, 110), 40)
    whole = tmi.mi_tiled(a, b, 30)
    monkeypatch.setattr(tmi, "_GROUP_ELEMS", 900 * 2)
    assert tmi.mi_tiled(a, b, 30) == pytest.approx(whole, abs=1e-15)


def test_gate(rng):
    a, b = _pair(rng, (64, 64), 30)
    noisy = rng.integers(0, 256, size=(64, 64)).astype(np.uint8)
    assert tmi.check_if_higher_similarity(a, b, noisy, 32) == jmi.check_if_higher_similarity(a, b, noisy, 32) == [True]
    assert tmi.check_if_higher_similarity(a, noisy, b, 32) == [False]
    after, before = tmi.mutual_information_test(a, b, noisy, 32)
    jafter, jbefore = jmi.mutual_information_test(a, b, noisy, 32)
    assert abs(after - jafter) <= ATOL_JAX and abs(before - jbefore) <= ATOL_JAX
