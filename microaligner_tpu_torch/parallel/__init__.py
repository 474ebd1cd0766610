"""Bounded tile and band maps on one device (counterpart of ``microaligner_tpu.parallel``)."""

from microaligner_tpu_torch.parallel.tile_runner import tile_map

__all__ = ["tile_map"]
