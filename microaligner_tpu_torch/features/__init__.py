"""Linear (affine) registration: FAST -> DAISY -> exact knn -> RANSAC.

PyTorch counterpart of ``microaligner_tpu/features``: fixed-capacity masked
keypoint arrays, an exact top-2 knn over a float32 distance matrix (its
cross term on bf16 operands on the card, as the JAX package's on its TPU;
``features/routes.py``), and a batch of RANSAC hypotheses, all on the
registrator's device.
"""

from microaligner_tpu_torch.features.registrator import FeatureRegistrator
from microaligner_tpu_torch.features.tile_features import (
    Features,
    find_features,
    match_features,
    register_img_pair,
)

__all__ = [
    "FeatureRegistrator",
    "Features",
    "find_features",
    "register_img_pair",
    "match_features",
]
