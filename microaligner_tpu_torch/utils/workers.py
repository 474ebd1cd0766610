"""Worker-count configuration — reference API compat.

PyTorch counterpart of ``microaligner_tpu/utils/workers.py``.  The
reference's ``set_number_of_dask_workers`` (shared_modules/utils.py:117-123)
sized a local process pool; here, as in the JAX package, tile parallelism
maps onto a device mesh (``parallel/``), and the knob bounds how many
devices the mesh uses.  A pipeline config's ``NumberOfWorkers`` sets it.
"""

from __future__ import annotations

import torch

from microaligner_tpu_torch.utils.device import resolve_device

__all__ = ["set_number_of_workers", "set_number_of_dask_workers", "get_worker_devices"]

_max_devices: int = 0  # 0 = every visible card (one entry on the CPU)


def set_number_of_workers(n_workers: int = 0) -> None:
    """0 -> every visible card; n -> cap the mesh at n devices."""
    global _max_devices
    if n_workers < 0:
        raise ValueError("Number of workers cannot be negative")
    _max_devices = int(n_workers)


# reference-named alias
set_number_of_dask_workers = set_number_of_workers


def get_worker_devices(device=None) -> list:
    """The tile mesh's devices for a home ``device`` (the first CUDA device
    when None; raises without a card, as ``resolve_device``): the first
    ``n`` visible cards, or all of them when the cap is 0; on the CPU, ``n``
    entries of the CPU device, or one when the cap is 0."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        return cards[:_max_devices] if _max_devices > 0 else cards
    if dev.type == "cpu":
        return [dev] * max(_max_devices, 1)
    raise ValueError(f"no tile mesh for device type {dev.type!r}: the port runs on CUDA or the CPU")
