"""microaligner_tpu_torch: the PyTorch + CUDA port of microaligner_tpu.

Runs both registration engines on an NVIDIA Hopper GPU: the affine
FeatureReg (FAST, DAISY, knn, RANSAC) and the non-linear optical-flow
OptFlowReg, chained by the YAML CLI.  The hot loops are six hand-written
CUDA kernels (``csrc/``), built with ``nvcc`` at first use; on CPU tensors
every kernel takes its plain PyTorch version.  This package imports
``torch`` and never ``jax``.
"""

from microaligner_tpu_torch.ops.pad import pad_to_shape

__version__ = "0.1.0"


def __getattr__(name):  # lazy, as microaligner_tpu/__init__.py does
    if name == "FeatureRegistrator":
        from microaligner_tpu_torch.features.registrator import FeatureRegistrator

        return FeatureRegistrator
    if name == "OptFlowRegistrator":
        from microaligner_tpu_torch.optflow.registrator import OptFlowRegistrator

        return OptFlowRegistrator
    if name == "Warper":
        from microaligner_tpu_torch.optflow.warper import Warper

        return Warper
    if name == "transform_img_with_tmat":
        from microaligner_tpu_torch.ops.warp import transform_img_with_tmat

        return transform_img_with_tmat
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "FeatureRegistrator",
    "OptFlowRegistrator",
    "Warper",
    "pad_to_shape",
    "transform_img_with_tmat",
]
