"""Worker-count configuration — reference API compat.

PyTorch counterpart of ``microaligner_tpu/utils/workers.py``.  The
reference's ``set_number_of_dask_workers`` (shared_modules/utils.py:117-123)
sized a local process pool; the JAX package maps the knob onto its device
mesh.  The port runs on one card, so every valid count means that one device:
the knob is validated and kept so pipeline configs and library callers keep
working.
"""

from __future__ import annotations

__all__ = ["set_number_of_workers", "set_number_of_dask_workers"]


def set_number_of_workers(n_workers: int = 0) -> int:
    """0 -> every local device, n -> at most n; on one card both mean one.
    Returns the number of devices the port uses (1)."""
    if n_workers < 0:
        raise ValueError("Number of workers cannot be negative")
    return 1


# reference-named alias
set_number_of_dask_workers = set_number_of_workers
