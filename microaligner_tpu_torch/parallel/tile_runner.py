"""Bounded map over a tile or band axis on one device.

PyTorch counterpart of ``microaligner_tpu/parallel/tile_runner.py::tile_map``
on a single GPU: there is no mesh, so the map is a Python loop over chunks of
``batch`` items.  Each chunk's outputs are copied into tensors allocated once,
so the live working set is one chunk's intermediates plus the outputs.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

__all__ = ["tile_map"]


def tile_map(fn_batch: Callable, inputs: Sequence[torch.Tensor], batch: int):
    """Apply ``fn_batch(*chunks)`` over the leading axis of every tensor in
    ``inputs``, ``batch`` items at a time.

    ``fn_batch`` returns a tensor or a tuple of tensors whose leading axis is
    the chunk's length; the chunks' results are written in order into
    tensors allocated once, of the whole axis's length.
    """
    if batch < 1:
        raise ValueError(f"tile_map: batch must be >= 1, got {batch}")
    n = len(inputs[0])
    if n == 0:
        raise ValueError("tile_map: empty tile axis")
    outs = None
    single = False
    for s in range(0, n, batch):
        res = fn_batch(*(x[s : s + batch] for x in inputs))
        if isinstance(res, torch.Tensor):
            res, single = (res,), True
        if outs is None:
            outs = tuple(r.new_empty((n,) + tuple(r.shape[1:])) for r in res)
        for o, r in zip(outs, res):
            o[s : s + r.shape[0]] = r
    return outs[0] if single else outs
