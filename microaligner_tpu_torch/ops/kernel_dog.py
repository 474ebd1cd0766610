"""K7: the Difference-of-Gaussians of the NMI gate, one kernel chain a call.

Replaces no TPU kernel: the JAX package leaves its DoG
(``microaligner_tpu/ops/filters.py::dog``) to XLA.  On the card the plain
version, :func:`dog_plain`, is about 350 elementwise launches a call (one
multiply and one add a tap, each a float32 plane pass), and OptFlowReg's
gate, FeatureReg's gate and its find run it on every level of every cycle.

``csrc/dog.cu`` computes the same arithmetic in three launches (the input's
min and max; the four passes, the difference and its min and max, tile by
tile in shared memory; the u8 min-max), rounding every product and sum
where the plain version does, so its output is bit-equal to
:func:`dog_plain` on the card.  It is bound by float32 operations: 324 a
pixel at ``ksize`` 41, none of which may fuse into an FMA.

The wrapper hands the kernel the taps of both sigmas
(``filters._taps(filters.gaussian_kernel(ksize, sigma))``) and the
REFLECT_101 fold tables of both axes (``filters._reflect101_index``), so the
borders fold as the plain version's padding does, short axes included.  The
tables are kept on the host, pinned, and copied to the device with each
call: nothing of K7 stays allocated there.  The scratch is one float32
plane (the difference) and a small head (partials, order keys, tables).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from microaligner_tpu_torch.ops import cuda_lib
from microaligner_tpu_torch.ops.filters import (
    _reflect101_index,
    _taps,
    gaussian_blur,
    gaussian_kernel,
    minmax_normalize_f32,
    minmax_normalize_u8,
)

__all__ = ["MAX_KSIZE", "DTYPES", "KernelArgs", "kernel_args", "dog_plain", "dog_u8"]

MAX_KSIZE = 81  # csrc/dog.cu's kMaxTaps
DTYPES = {torch.uint8: 0, torch.uint16: 1, torch.float32: 2}  # the kernel's dtype codes
_TILE_H = 152  # csrc/dog.cu's kTileH: output rows a block
_HEAD = 2 * 512 + 2  # csrc/dog.cu's head before the tables: 2 * kMinmaxBlocks partials, two order keys


class KernelArgs(NamedTuple):
    """What the wrapper hands the kernel, on the host: the taps of the low
    and the high sigma, (2, ksize) float32; the radius r; the int32 fold
    tables of the rows (H + 2r entries) and then of the columns (W + 2r),
    in one tensor."""

    taps: torch.Tensor
    radius: int
    folds: torch.Tensor


@functools.lru_cache(maxsize=16)
def _tap_table(ksize: int, low_sigma: float, high_sigma: float) -> torch.Tensor:
    return torch.tensor([_taps(gaussian_kernel(ksize, low_sigma)), _taps(gaussian_kernel(ksize, high_sigma))],
                        dtype=torch.float32)


@functools.lru_cache(maxsize=64)
def _fold_tables(h: int, w: int, pad: int, pinned: bool) -> torch.Tensor:
    folds = torch.cat([_reflect101_index(h, pad, "cpu"), _reflect101_index(w, pad, "cpu")]).to(torch.int32)
    return folds.pin_memory() if pinned else folds


def kernel_args(h: int, w: int, ksize: int, low_sigma: float, high_sigma: float, pinned: bool = False) -> KernelArgs:
    """The taps, radius and fold tables of an (h, w) DoG, cached by shape;
    ``pinned`` puts the tables in page-locked memory (it needs a card)."""
    r = (ksize - 1) // 2
    return KernelArgs(_tap_table(ksize, float(low_sigma), float(high_sigma)), r, _fold_tables(h, w, r, pinned))


def dog_plain(img: torch.Tensor, ksize: int, low_sigma: float, high_sigma: float) -> torch.Tensor:
    """Plain PyTorch version of K7: min-max to [0, 1] float, blur at both
    sigmas with a ``ksize`` kernel, subtract (high less low), min-max to u8."""
    dog_plain.calls += 1
    fimg = minmax_normalize_f32(img)
    ls = gaussian_blur(fimg, ksize, low_sigma)
    hs = gaussian_blur(fimg, ksize, high_sigma)
    return minmax_normalize_u8(hs - ls)


dog_plain.calls = 0


def dog_u8(img: torch.Tensor, ksize: int, low_sigma: float, high_sigma: float) -> torch.Tensor:
    """The u8 Difference-of-Gaussians of a 2-D u8, u16 or float32 image
    (``ksize`` odd, at most ``MAX_KSIZE``).  A CPU tensor takes
    :func:`dog_plain`; a CUDA tensor launches K7 or raises."""
    if img.dim() != 2:
        raise ValueError(f"dog_u8: a 2-D image expected, got shape {tuple(img.shape)}")
    if img.dtype not in DTYPES:
        raise ValueError(f"dog_u8: dtype {img.dtype} is none of {list(DTYPES)}")
    if ksize % 2 == 0 or not 1 <= ksize <= MAX_KSIZE:
        raise ValueError(f"dog_u8: kernel size {ksize} is not odd in [1, {MAX_KSIZE}]")
    if img.device.type == "cpu":
        return dog_plain(img, ksize, low_sigma, high_sigma)
    cuda_lib.require_cuda(img)
    h, w = img.shape
    if h * w == 0:
        raise ValueError(f"dog_u8: an empty image, shape {(h, w)}")
    cuda_lib.check_grid("dog_u8", 1, -(-h // _TILE_H))
    img = img.contiguous()
    args = kernel_args(h, w, ksize, low_sigma, high_sigma, pinned=True)
    head = torch.empty(_HEAD + args.folds.numel(), dtype=torch.float32, device=img.device)
    folds = head[_HEAD:].view(torch.int32)
    folds.copy_(args.folds, non_blocking=True)
    diff = torch.empty((h, w), dtype=torch.float32, device=img.device)
    out = torch.empty((h, w), dtype=torch.uint8, device=img.device)
    cuda_lib.call("ma_dog_u8", img.device, img, DTYPES[img.dtype], h, w, folds, args.taps, ksize, head, diff, out)
    dog_u8.launches += 1
    return out


dog_u8.launches = 0  # calls that launched the kernel chain
