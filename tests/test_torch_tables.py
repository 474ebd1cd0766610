"""The port computes its own constant tables; they equal the JAX package's
bit for bit in float32."""

import importlib

import numpy as np
import pytest
import torch

from microaligner_tpu.features import daisy as jd
from microaligner_tpu.features import fast as jfast
from microaligner_tpu.ops import filters as jf
from microaligner_tpu_torch.utils.parity import port_tables, tables_from_numpy

jfb = importlib.import_module("microaligner_tpu.optflow.farneback")

torch.set_num_threads(1)

WINSIZES = (11, 31, 51, 99, 255)
DAISY_SIZES = (20, 96, 700)


def _jax_tables():
    tables = {
        "poly_exp_coeffs": jfb._poly_exp_coeffs(1, 1.7),
        "poly_coeff_tuple": jfb._poly_coeff_tuple(1, 1.7),
        "border_scale": jfb._BORDER_SCALE,
        "presmooth": jfb._PRESMOOTH,
        "pyr_kernel": jf._PYR_KERNEL,
    }
    tables.update({f"agg_kernel_{ws}": jfb._agg_kernel(ws) for ws in WINSIZES})
    tables.update({f"dog_kernel_{s}": jf.gaussian_kernel(41, s) for s in (5, 9)})
    # the feature engine's, computed as features/daisy.py::_orientation_cubes does
    tables.update(fast_ring=jfast._RING, daisy_grid_offsets=jd._grid_offsets(),
                  daisy_ring_of_point=jd._ring_of_point(), daisy_sigmas=jd._sigmas())
    prev = 0.0
    for s in jd._sigmas():
        inc = float(np.sqrt(s * s - prev * prev))
        prev = float(s)
        ksize = int(round(inc * 4)) * 2 + 1
        tables[f"daisy_toeplitz_{ksize}"] = jf._toeplitz_band(jf._BANDED_BLOCK, ksize, inc)
        for size in DAISY_SIZES:
            tables[f"daisy_operator_{ksize}_{size}"] = jf._blur_operator(size, ksize, inc)
    return tables


def test_tables_bitwise_equal():
    jax_t = tables_from_numpy(_jax_tables())
    port_t = tables_from_numpy(port_tables(WINSIZES, daisy_sizes=DAISY_SIZES))
    assert {"daisy_toeplitz_29", "daisy_toeplitz_49", "daisy_toeplitz_63", "fast_ring"} <= set(port_t)
    assert jax_t.keys() == port_t.keys()
    for key in jax_t:
        assert port_t[key].dtype == torch.float32
        np.testing.assert_array_equal(port_t[key].view(torch.int32).numpy(),
                                      jax_t[key].view(torch.int32).numpy(), err_msg=key)


@pytest.mark.parametrize("n,sigma", [(1, 1.7), (2, 1.5), (3, 1.2)])
def test_poly_coefficients_any_order(n, sigma):
    from microaligner_tpu_torch.optflow import farneback as tfb

    for got, want in zip(tfb._poly_exp_coeffs(n, sigma), jfb._poly_exp_coeffs(n, sigma)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
