"""K3's accuracy bar, seen on the CPU: the float32 plain version of the window
aggregation + solve against the same function run in float64.

On the card K3 sums each tap with one fused multiply-add, so it is no longer
bit-equal to its plain version; it is held to 1e-4 px of it and must be no
further from the float64 run than the float32 plain version is
(``tests/test_torch_kernels_cuda.py::test_k3``).  The cases here hold the
float32 plain version itself to that float64 run, at the windows the card
test uses, so the bars of the card test are numbers a CPU run has seen:
max <= 2e-5 px and mean <= 1e-6 px of flow (measured: max up to 7e-6 at
window 11, mean up to 3.3e-7 at window 257).  A float32 sum of 2r+1 rounded
products carries about sqrt(2r+1) * 6e-8 of relative error a pass; the
solve divides by det >= 1e-3 and amplifies it where det is small.

Also here: the launch shape the wrapper hands ``chip_smoke.py`` and its
up-front checks, which are plain Python.
"""

import numpy as np
import pytest
import torch

from microaligner_tpu_torch.ops import kernel_agg, kernel_poly
from microaligner_tpu_torch.ops.filters import gaussian_blur
from microaligner_tpu_torch.optflow import farneback as tfb

torch.set_num_threads(1)

F64_MAX_PX, F64_MEAN_PX = 2e-5, 1e-6  # the card test's bars on K3 against float64


def pipeline_matrices(rng, n, h, w):
    """Normal equations M0 of a smooth texture and a copy shifted by
    (1, -1) px, from the port's own expansion: (n, 5, h, w) float32."""
    big = torch.from_numpy(rng.random((n, 140, 180), dtype=np.float32))
    big = gaussian_blur(big, 9, 2.0) * 255
    mov, ref = big[:, 4:134, 4:174].contiguous(), big[:, 3:133, 5:175].contiguous()
    coeffs = tfb._poly_coeff_tuple(1, 1.7)
    m0 = kernel_poly.poly_pair_m_plain(tfb._pad_replicate1(tfb._pre_smooth(mov)),
                                       tfb._pad_replicate1(tfb._pre_smooth(ref)), coeffs)[2]
    return m0[:, :, :h, :w].contiguous()


@pytest.mark.parametrize("n,h,w,win", [
    pytest.param(2, 12, 45, 11, id="win11-n2-h12"),
    pytest.param(1, 130, 170, 11, id="win11"),
    pytest.param(1, 130, 170, 99, id="win99"),
    pytest.param(2, 40, 30, 99, id="win99-n2-h-and-w-below-r"),
    pytest.param(1, 3, 2, 99, id="win99-h3-w2"),
    pytest.param(1, 70, 170, 257, id="win257-h-below-r"),
    pytest.param(1, 130, 100, 257, id="win257-w-below-r"),
])
def test_plain_float32_against_float64(rng, n, h, w, win):
    m = pipeline_matrices(rng, n, h, w)
    got = kernel_agg.smooth5_solve_plain(m, win)
    exact = kernel_agg.smooth5_solve_plain(m.double(), win)
    for g, e in zip(got, exact):
        assert g.dtype == torch.float32 and e.dtype == torch.float64 and g.shape == (n, h, w)
        err = (g.double() - e).abs()
        assert float(err.max()) <= F64_MAX_PX
        assert float(err.mean()) <= F64_MEAN_PX


@pytest.mark.parametrize("win", [11, 99, 257])
def test_row_pass_float32_against_float64(rng, win):
    """The row pass alone on unit-range data: within 1e-6 of its float64 run
    (the card holds the kernel to 1e-5 of the float32 plain version)."""
    x = torch.from_numpy(rng.random((2, 3, 20, 150), dtype=np.float32))
    got = kernel_agg.smooth_w_plain(x, win)
    exact = kernel_agg.smooth_w_plain(x.double(), win)
    assert float((got.double() - exact).abs().max()) <= 1e-6


@pytest.mark.parametrize("kernel", ["smooth_rows_kernel", "smooth_cols_solve_kernel"])
def test_block_shared_memory_fits_at_the_window_limit(kernel):
    """Two staged tiles at the largest window fit the 227 KB a block can
    have on the H100, and two blocks of the main path's window fit an SM."""
    assert kernel_agg.block_shared_bytes(kernel, kernel_agg.MAX_HALF_WINDOW) <= 232448
    assert 2 * (kernel_agg.block_shared_bytes(kernel, 99 // 2) + 1024) <= 233472
    assert kernel_agg.block_shared_bytes(kernel, 0) > 4 * 2 * 32 * 256


def test_window_check_names_the_limit():
    assert kernel_agg._check_cuda_window("k3", 2 * kernel_agg.MAX_HALF_WINDOW + 1, 5, 64, 64) == 128
    with pytest.raises(ValueError, match="exceeds the kernel's limit 128"):
        kernel_agg._check_cuda_window("k3", 2 * kernel_agg.MAX_HALF_WINDOW + 3, 5, 64, 64)
    with pytest.raises(ValueError, match="more tiles than an int counts"):
        kernel_agg._check_cuda_window("k3", 99, 5 * 70000, 32 * 1000, 256 * 1000)


def test_taps_for_the_kernel_are_the_plain_versions(rng):
    """The CPU tensor whose pointer the C entry points read holds the taps
    the plain version sums, 2r+1 contiguous float32."""
    for win in (11, 99, 257):
        t = kernel_agg._taps_host(win)
        assert t.device.type == "cpu" and t.dtype == torch.float32 and t.is_contiguous()
        np.testing.assert_array_equal(t.numpy(), kernel_agg.agg_kernel(win))
        assert t.numel() == 2 * (win // 2) + 1
