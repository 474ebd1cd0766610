"""Per-plane apply of a cycle's flow.

PyTorch counterpart of ``_apply_flow_plane`` in
``microaligner_tpu/pipeline/runner.py``.  The CLI loop around it (config,
TIFF reading and writing) is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from microaligner_tpu_torch.ops.filters import round_to_dtype
from microaligner_tpu_torch.optflow.warper import warp_tiled
from microaligner_tpu_torch.tiles import TileGrid

__all__ = ["_apply_flow_plane"]


def _apply_flow_plane(img: torch.Tensor, flow: torch.Tensor, grid: TileGrid,
                      dtype: torch.dtype, band_rows: Optional[int] = None) -> torch.Tensor:
    """Banded warp of one (H, W) plane by the (H, W, 2) flow on the flow's
    device, rounded half to even and clipped back to ``dtype`` (``cv.remap``
    on integer images rounds)."""
    return round_to_dtype(warp_tiled(img, flow, grid, band_rows), dtype)
