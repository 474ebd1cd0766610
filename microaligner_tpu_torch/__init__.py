"""microaligner_tpu_torch: the PyTorch + CUDA port of microaligner_tpu.

Runs the non-linear (optical-flow) registration path on an NVIDIA Hopper
GPU.  Its hot loops are four hand-written CUDA kernels (``csrc/``), built
with ``nvcc`` at first use; on CPU tensors every kernel takes its plain
PyTorch version.  This package imports ``torch`` and never ``jax``.
"""

from microaligner_tpu_torch.ops.pad import pad_to_shape

__version__ = "0.1.0"


def __getattr__(name):  # lazy, as microaligner_tpu/__init__.py does
    if name == "OptFlowRegistrator":
        from microaligner_tpu_torch.optflow.registrator import OptFlowRegistrator

        return OptFlowRegistrator
    if name == "Warper":
        from microaligner_tpu_torch.optflow.warper import Warper

        return Warper
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["OptFlowRegistrator", "Warper", "pad_to_shape"]
