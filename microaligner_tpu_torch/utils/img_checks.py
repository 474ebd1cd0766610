"""Input validation guards for the registration engines and pipeline.

Behavioral parity with the reference's pre-flight checks (see
shared_modules/img_checks.py for which conditions are enforced), written
independently: a registration pair must be two same-shaped 2-D grayscale
planes, pipeline inputs must be 4-D CZYX stacks, and the cycle-stack flag
constrains how many input files are legal.

PyTorch-port copy of ``microaligner_tpu/utils/img_checks.py``; the TIFF
check reads with the port's own ``io/tiff.py``.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "check_img_is_2d_grey",
    "check_img_is_provided",
    "check_img_dims_match",
    "check_input_has_proper_dimensions",
    "check_number_of_input_img_paths",
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


def check_input_has_proper_dimensions(img_path):
    """Pipeline inputs must be 4-D CZYX stacks (same contract as the
    reference's dimension pre-flight check)."""
    from microaligner_tpu_torch.io.tiff import TiffFile

    with TiffFile(img_path) as tf:
        shape = tf.series[0].shape
    if len(shape) != 4:
        raise ValueError(
            f"{img_path}: pipeline inputs must be 4-D (CZYX); "
            f"this file is {len(shape)}-D with shape {shape}"
        )


def check_number_of_input_img_paths(img_paths, is_stack: bool):
    """A cycle stack is one file; per-cycle inputs need two or more."""
    n = len(img_paths)
    if is_stack and n > 1:
        raise ValueError(
            f"InputIsCycleStack=true takes a single stack file, got {n} paths"
        )
    if n == 0 or (not is_stack and n < 2):
        raise ValueError(
            "Registration needs at least two input images (one per cycle)"
        )
