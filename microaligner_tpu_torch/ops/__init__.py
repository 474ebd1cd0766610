"""Image operations and the hand-written CUDA kernels K1-K4 with their plain
PyTorch versions (counterpart of ``microaligner_tpu.ops``)."""
