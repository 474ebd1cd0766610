"""The JAX package's FeatureReg route variables, read as it reads them.

* ``MICROALIGNER_TPU_DAISY_NRM``: ``0`` keeps the reference's raw DAISY
  descriptors (cv2 ``NRM_NONE``); anything else normalizes them.
* ``MICROALIGNER_TPU_MATCH_F32``: the knn cross term's operands
  (``features/match.py``).
* ``MICROALIGNER_TPU_DAISY_EXACT``: the operands of DAISY's blur products
  (``ops/filters.py::gaussian_blur_mxu``).

The last two have the JAX package's rule, by device: float32 on the CPU
(as the JAX package computes on its CPU), and on any other device bf16
operands with float32 sums unless the variable is exactly ``1``.  Unset on
the card is the bf16 route, the one the JAX package runs on its TPU.

``FeatureRegistrator.register`` reads each once and passes the result down,
so the reference and moving sides of one registration take one route.
"""

from __future__ import annotations

import os

import torch

__all__ = ["daisy_normalize", "daisy_operand_dtype", "match_operand_dtype"]


def daisy_normalize() -> bool:
    """``MICROALIGNER_TPU_DAISY_NRM``: ``0`` keeps the reference's raw
    descriptors (the reference's feature_detection.py:96-104); anything
    else, and the default, normalizes them to unit length."""
    return os.environ.get("MICROALIGNER_TPU_DAISY_NRM", "1") != "0"


def _operand_dtype(variable: str, device) -> torch.dtype:
    if torch.device(device).type == "cpu" or os.environ.get(variable, "0") == "1":
        return torch.float32
    return torch.bfloat16


def match_operand_dtype(device) -> torch.dtype:
    """The knn cross term's operand dtype on ``device``
    (``MICROALIGNER_TPU_MATCH_F32``)."""
    return _operand_dtype("MICROALIGNER_TPU_MATCH_F32", device)


def daisy_operand_dtype(device) -> torch.dtype:
    """The operand dtype of DAISY's blur products on ``device``
    (``MICROALIGNER_TPU_DAISY_EXACT``)."""
    return _operand_dtype("MICROALIGNER_TPU_DAISY_EXACT", device)
