"""Input validation guards for the registration engines.

Behavioral parity with the reference's pre-flight checks (see
shared_modules/img_checks.py for which conditions are enforced), written
independently: a registration pair must be two same-shaped 2-D grayscale
planes.

PyTorch-port copy of the registration checks of
``microaligner_tpu/utils/img_checks.py``; the pipeline's checks (input paths,
TIFF dimensions) come with the port's CLI layer.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "check_img_is_2d_grey",
    "check_img_is_provided",
    "check_img_dims_match",
]


def check_img_is_2d_grey(img, img_type: str):
    """Registration operates on single 2-D planes; reject anything else."""
    if len(img.shape) > 2:
        raise ValueError(
            f"The {img_type} image must be a single 2-D grayscale plane; "
            f"got an array of shape {img.shape}"
        )


def check_img_is_provided(img, img_type: str):
    """Both engine inputs are property-set; catch a missing/empty one early."""
    if img is None or (img.numel() if hasattr(img, "numel") else np.size(img)) == 0:
        raise ValueError(f"The {img_type} image has not been set (empty or None)")


def check_img_dims_match(ref, mov):
    if tuple(ref.shape) != tuple(mov.shape):
        raise ValueError(
            f"Shape mismatch between the registration pair: "
            f"ref {tuple(ref.shape)} vs mov {tuple(mov.shape)} — pad or crop first"
        )
