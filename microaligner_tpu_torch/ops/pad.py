"""Centered constant padding to a target shape.

PyTorch counterpart of ``microaligner_tpu/ops/pad.py``: the odd remainder goes
to the right/bottom, and a difference of exactly 1 goes there too.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

__all__ = ["calculate_padding_size", "pad_to_shape", "zero_pad"]


def calculate_padding_size(bigger: int, smaller: int) -> Tuple[int, int]:
    diff = bigger - smaller
    if diff == 1:
        return 0, 1
    if diff % 2 != 0:
        return diff // 2, diff // 2 + 1
    return diff // 2, diff // 2


def zero_pad(img: torch.Tensor, top: int, bottom: int, left: int, right: int) -> torch.Tensor:
    """Constant-zero pad of the last two axes, for any dtype (``uint16``
    included, which ``F.pad`` does not take)."""
    h, w = img.shape[-2:]
    out = img.new_zeros(img.shape[:-2] + (top + h + bottom, left + w + right))
    out[..., top : top + h, left : left + w] = img
    return out


def pad_to_shape(img, target_shape: Tuple[int, int]):
    """Pad a 2-D image with zeros to ``target_shape``.

    Returns ``(padded_img, (left, right, top, bottom))``.  Takes a numpy
    array (padded on the host) or a tensor (padded on its device).
    """
    if tuple(img.shape) == tuple(target_shape):
        return img, (0, 0, 0, 0)
    left, right = calculate_padding_size(target_shape[1], img.shape[1])
    top, bottom = calculate_padding_size(target_shape[0], img.shape[0])
    if isinstance(img, np.ndarray):
        padded = np.pad(img, ((top, bottom), (left, right)), mode="constant")
    else:
        padded = zero_pad(img, top, bottom, left, right)
    return padded, (left, right, top, bottom)
