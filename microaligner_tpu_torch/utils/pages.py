"""Z-maximum projection of a stack of planes, min-max normalized to u8.

PyTorch counterpart of ``microaligner_tpu/utils/pages.py``:
:func:`read_and_max_project_pages` reads the pages with the port's TIFF
reader and projects them with :func:`max_project_u8` on the pipeline's
device.  Registration always runs on these u8 projections; the final warp is
applied to the original-dtype planes.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Iterable

import numpy as np
import torch

from microaligner_tpu_torch.io.tiff import read_tiff_page
from microaligner_tpu_torch.ops.filters import minmax_normalize_u8
from microaligner_tpu_torch.utils.logging import span

__all__ = ["max_project_u8", "read_and_max_project_pages"]


def max_project_u8(planes: Iterable, device) -> torch.Tensor:
    """Z-max of ``planes`` (numpy arrays or tensors of one shape and integer
    or float dtype, any iterable: a generator keeps one plane on the host)
    on ``device``, min-max normalized to a u8 tensor.  Under
    ``MICROALIGNER_TPU_PROFILE`` the call is the span ``pages.project``
    (``planes``), and each plane's host-to-device copy a child span
    ``pages.copy`` (``bytes``) with no timing events: a copy from pageable
    memory already holds the host."""
    proj = None
    with span("pages.project", device) as s:
        for n, p in enumerate(planes, 1):
            t = torch.as_tensor(np.asarray(p) if not isinstance(p, torch.Tensor) else p)
            # copy in the plane's own dtype, then widen on the device; float32
            # holds every u8/u16 value exactly (torch has no max for uint16)
            with span("pages.copy", bytes=t.nbytes):
                t = t.to(device)
            t = t.to(torch.float32)
            proj = t if proj is None else torch.maximum(proj, t)
        if proj is None:
            raise ValueError("max_project_u8 needs at least one plane")
        s.set(planes=n)
        return minmax_normalize_u8(proj)


def read_and_max_project_pages(img_paths: Dict[int, Path], tiff_pages: Dict[int, int],
                               device) -> torch.Tensor:
    """Z-max of the pages ``tiff_pages[z]`` of ``img_paths[z]``, min-max
    normalized to a u8 tensor on ``device`` (reference
    shared_modules/utils.py:75-95).  Pages are read one at a time."""
    return max_project_u8((read_tiff_page(img_paths[z], tiff_pages[z]) for z in img_paths), device)
