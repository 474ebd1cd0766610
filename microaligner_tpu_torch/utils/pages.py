"""Z-maximum projection of a stack of planes, min-max normalized to u8.

PyTorch counterpart of the projection in
``microaligner_tpu/utils/pages.py::read_and_max_project_pages``; reading the
pages from TIFF comes with the port's CLI layer, so this takes planes that
are already in memory.  Registration always runs on these u8 projections;
the final warp is applied to the original-dtype planes.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from microaligner_tpu_torch.ops.filters import minmax_normalize_u8

__all__ = ["max_project_u8"]


def max_project_u8(planes: Sequence, device) -> torch.Tensor:
    """Z-max of ``planes`` (numpy arrays or tensors of one shape and integer
    or float dtype) on ``device``, min-max normalized to a u8 tensor."""
    if len(planes) == 0:
        raise ValueError("max_project_u8 needs at least one plane")
    proj = None
    for p in planes:
        t = torch.as_tensor(np.asarray(p) if not isinstance(p, torch.Tensor) else p)
        # copy in the plane's own dtype, then widen on the device; float32
        # holds every u8/u16 value exactly (torch has no max for uint16)
        t = t.to(device).to(torch.float32)
        proj = t if proj is None else torch.maximum(proj, t)
    return minmax_normalize_u8(proj)
