"""The constant tables of the registration path, for parity checks.

The JAX package has no learned weights: its state is a handful of constant
tables plus the images.  The port computes its own tables; this module names
them in one place so a test can hold them against the JAX package's, bit for
bit in float32.

Keys: ``poly_exp_coeffs`` (g, xg, xxg and the four inverse-matrix entries of
``_poly_exp_coeffs(1, 1.7)``), ``poly_coeff_tuple`` (K2's and K6's eight
scalars), ``agg_kernel_<winsize>``, ``border_scale``, ``presmooth``,
``pyr_kernel``, ``dog_kernel_<sigma>`` (the DoG blur, ``low_sigma * 8 + 1``
taps), and the feature engine's: ``fast_ring``, ``daisy_grid_offsets``,
``daisy_ring_of_point``, ``daisy_sigmas``, and at each DAISY ring blur
(ksize 29, 49, 63) ``daisy_toeplitz_<ksize>`` (the 512-row band) and
``daisy_operator_<ksize>_<size>`` (the dense operator of a ``size`` axis).
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping

import numpy as np
import torch

__all__ = ["port_tables", "tables_from_numpy"]


def _flat_f32(value) -> np.ndarray:
    """A table or tuple of tables and scalars as one flat float32 array."""
    if isinstance(value, (tuple, list)):
        return np.concatenate([np.asarray(v, np.float32).reshape(-1) for v in value])
    return np.asarray(value, np.float32).reshape(-1)


def port_tables(winsizes: Iterable[int] = (99,), dog_sigmas: Iterable[int] = (5, 9),
                low_sigma: int = 5, daisy_sizes: Iterable[int] = (96,)) -> Dict[str, np.ndarray]:
    """The port's own tables as flat float32 numpy arrays."""
    from microaligner_tpu_torch.features import daisy
    from microaligner_tpu_torch.features.fast import RING
    from microaligner_tpu_torch.ops import filters
    from microaligner_tpu_torch.ops.filters import PYR_KERNEL, gaussian_kernel
    from microaligner_tpu_torch.optflow import farneback as fb

    tables = {
        "poly_exp_coeffs": fb._poly_exp_coeffs(1, 1.7),
        "poly_coeff_tuple": fb._poly_coeff_tuple(1, 1.7),
        "border_scale": fb._BORDER_SCALE,
        "presmooth": fb._PRESMOOTH,
        "pyr_kernel": PYR_KERNEL,
    }
    for ws in winsizes:
        tables[f"agg_kernel_{ws}"] = fb._agg_kernel(ws)
    for sigma in dog_sigmas:
        tables[f"dog_kernel_{sigma}"] = gaussian_kernel(low_sigma * 8 + 1, sigma)
    tables.update(fast_ring=RING, daisy_grid_offsets=daisy._grid_offsets(),
                  daisy_ring_of_point=daisy._ring_of_point(), daisy_sigmas=daisy._sigmas())
    for sigma in daisy._increments():
        ksize = daisy._ksize(sigma)
        tables[f"daisy_toeplitz_{ksize}"] = filters._toeplitz_band(filters.BANDED_BLOCK, ksize, sigma)
        for size in daisy_sizes:
            tables[f"daisy_operator_{ksize}_{size}"] = filters._blur_operator(size, ksize, sigma)
    return {k: _flat_f32(v) for k, v in tables.items()}


def tables_from_numpy(tables: Mapping[str, object], device="cpu") -> Dict[str, torch.Tensor]:
    """Tables given as numpy arrays, scalars or tuples of them (the JAX
    package's, or :func:`port_tables`) -> flat float32 tensors on ``device``
    under the same keys, the form the port's kernels take them in."""
    return {k: torch.from_numpy(_flat_f32(v)).to(device) for k, v in tables.items()}
