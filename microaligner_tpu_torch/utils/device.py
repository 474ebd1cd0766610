"""Where the port's entry points run.

The registrators, the Warper, ``transform_img_with_tmat`` and the CLI run
on the first CUDA device unless the caller names another device (the tests
name ``"cpu"``).  A CUDA device with no card visible raises: nothing falls
back to the CPU.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``, ``cuda`` when it is None; raises
    when that device is CUDA and ``torch.cuda.is_available()`` is False."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "microaligner_tpu_torch: no CUDA device (torch.cuda.is_available() is False); "
            "the port runs on an NVIDIA GPU and does not fall back to the CPU "
            "unless it is given device='cpu'"
        )
    return dev
