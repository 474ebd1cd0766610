"""Separable filters, image pyramids and min-max normalization.

PyTorch counterpart of ``microaligner_tpu/ops/filters.py``: ``cv.GaussianBlur``
/ ``cv.pyrDown`` / ``cv.pyrUp`` / ``cv.normalize(NORM_MINMAX)`` on tensors.
Borders are BORDER_REFLECT_101 (OpenCV's default for filters); u8 outputs
round half to even, like OpenCV's cvRound.

Correlations are written as shifted slices, one multiply and one add per tap
in ascending tap order, as the JAX package writes them, so results agree
with it to the last bit where the arithmetic is the same.

DAISY's long blurs (ksize 29..63) are products with blur operators instead
(:func:`gaussian_blur_mxu`): a dense (size, size) operator for short axes
and one shared Toeplitz band over 512-row blocks for long ones, with the
REFLECT_101 fold inside the operators.  The JAX package leaves these to XLA
outside any Pallas kernel (bf16 operands on a TPU, float32 elsewhere).
Here they are float32 products with TF32 off (:func:`ieee_float32`); the
CPU's BLAS and cuBLAS sum them in different orders, so the two devices'
blurs differ in their last bits.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

__all__ = [
    "gaussian_kernel",
    "gaussian_blur",
    "gaussian_blur_mxu",
    "ieee_float32",
    "sep_filter2d",
    "dog",
    "dog_traced",
    "pyr_down",
    "pyr_up",
    "minmax_normalize_f32",
    "minmax_normalize_u8",
    "round_to_dtype",
]

PYR_KERNEL = np.array([1.0, 4.0, 6.0, 4.0, 1.0], dtype=np.float32) / 16.0


def gaussian_kernel(ksize: int, sigma: float) -> np.ndarray:
    """1-D Gaussian kernel identical to ``cv.getGaussianKernel(ksize, sigma)``.

    For sigma <= 0 OpenCV derives sigma from the kernel size, and uses fixed
    binomial kernels for sizes up to 7.  Computed in float64 and cast.
    """
    if sigma <= 0:
        fixed = {
            1: [1.0],
            3: [0.25, 0.5, 0.25],
            5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
            7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125],
        }
        if ksize in fixed:
            return np.asarray(fixed[ksize], dtype=np.float32)
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    k = np.exp(-(x**2) / (2.0 * sigma * sigma))
    k /= k.sum()
    return k.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _blur_operator(size: int, ksize: int, sigma: float) -> np.ndarray:
    """(size, size) matrix B with ``B @ x`` == the REFLECT_101-padded
    Gaussian correlation along a length-``size`` axis (float64, cast)."""
    k = gaussian_kernel(ksize, sigma).astype(np.float64)
    r = (ksize - 1) // 2
    B = np.zeros((size, size), np.float64)
    for t in range(ksize):
        j = np.arange(size) + (t - r)
        # REFLECT_101 fold, iterated for axes shorter than the kernel
        for _ in range(max(1, (r + size - 1) // max(size - 1, 1) + 1)):
            j = np.where(j < 0, -j, j)
            j = np.where(j >= size, 2 * size - 2 - j, j)
        B[np.arange(size), j] += k[t]
    return B.astype(np.float32)


BANDED_BLOCK = 512  # output rows per block of the banded blur


@functools.lru_cache(maxsize=None)
def _toeplitz_band(block: int, ksize: int, sigma: float) -> np.ndarray:
    """(block, block + ksize - 1) correlation band: row i holds the kernel
    at offset i; one operator for every block of a long axis."""
    k = gaussian_kernel(ksize, sigma).astype(np.float64)
    T = np.zeros((block, block + ksize - 1), np.float64)
    for i in range(block):
        T[i, i : i + ksize] = k
    return T.astype(np.float32)


@contextlib.contextmanager
def ieee_float32():
    """Float32 matrix products in the block run in full float32: no TF32
    on the card, whatever the caller's setting."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def _operator(table: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A float32 table as a tensor on ``like``'s device."""
    return torch.from_numpy(table).to(like.device)


def _blur_axis_banded(x: torch.Tensor, axis: int, ksize: int, sigma: float) -> torch.Tensor:
    """Banded blur along ``axis`` (-2 or -1): REFLECT_101-pad by r, zero the
    tail to whole blocks, contract every block's window with the shared band,
    crop.  The zero tail only feeds cropped rows."""
    size = x.shape[axis]
    r = (ksize - 1) // 2
    block = BANDED_BLOCK
    nb = -(-size // block)
    xp = x.index_select(axis, _reflect101_index(size, r, x.device))
    tail = nb * block - size
    if tail:
        shape = list(xp.shape)
        shape[axis] = tail
        xp = torch.cat([xp, xp.new_zeros(shape)], dim=axis)
    T = _operator(_toeplitz_band(block, ksize, float(sigma)), x)
    win = block + 2 * r
    # (..., nb, win) windows of the axis, stride `block`
    if axis in (-1, x.dim() - 1):
        wins = xp.unfold(-1, win, block)  # (..., nb, win)
        out = torch.matmul(wins, T.T)  # (..., nb, block)
        return out.reshape(*x.shape[:-1], nb * block)[..., :size]
    wins = xp.unfold(-2, win, block)  # (..., nb, W, win)
    out = torch.matmul(T, wins.transpose(-1, -2))  # (..., nb, block, W)
    return out.reshape(*x.shape[:-2], nb * block, x.shape[-1])[..., :size, :]


def gaussian_blur_mxu(x: torch.Tensor, ksize: int, sigma: float) -> torch.Tensor:
    """Gaussian blur of a (..., H, W) float32 stack along the last two axes
    as blur-operator products (REFLECT_101, same size): the JAX package's
    ``gaussian_blur_mxu`` with its float32 operators, in float32 with TF32
    off.  Axes longer than ``BANDED_BLOCK + ksize - 1`` take the banded
    operator."""
    h, w = x.shape[-2], x.shape[-1]
    y = x.to(torch.float32)
    with ieee_float32():
        if h > BANDED_BLOCK + ksize - 1:
            y = _blur_axis_banded(y, -2, ksize, sigma)
        else:
            y = torch.matmul(_operator(_blur_operator(h, ksize, float(sigma)), y), y)
        if w > BANDED_BLOCK + ksize - 1:
            y = _blur_axis_banded(y, -1, ksize, sigma)
        else:
            y = torch.matmul(y, _operator(_blur_operator(w, ksize, float(sigma)), y).T)
    return y


def _taps(kernel) -> list[float]:
    return np.asarray(kernel, dtype=np.float32).tolist()


def _reflect101_index(size: int, pad: int, device) -> torch.Tensor:
    """Indices of a REFLECT_101 pad (gfedcb|abcdefgh|gfedcba), folded as often
    as a short axis needs."""
    j = torch.arange(-pad, size + pad, device=device)
    if size == 1:
        return torch.zeros_like(j)
    for _ in range(pad // max(size - 1, 1) + 1):
        j = torch.where(j < 0, -j, j)
        j = torch.where(j >= size, 2 * size - 2 - j, j)
    return j


def _corr1d_axis(x: torch.Tensor, kernel, axis: int) -> torch.Tensor:
    """VALID correlation with a 1-D kernel along ``axis`` via shifted slices."""
    taps = _taps(kernel)
    out_len = x.shape[axis] - len(taps) + 1
    acc = None
    for i, k in enumerate(taps):
        t = x.narrow(axis, i, out_len) * k
        if acc is None:
            acc = t
        else:
            acc += t  # in place: one live temporary, same rounding as acc + t
    return acc


def sep_filter2d(img: torch.Tensor, kx, ky) -> torch.Tensor:
    """Separable 2-D correlation of (..., H, W) float ``img`` with
    REFLECT_101 borders, same-size output (``cv.sepFilter2D``)."""
    rh = (len(ky) - 1) // 2
    rw = (len(kx) - 1) // 2
    h, w = img.shape[-2:]
    p = img
    if rh:
        p = p.index_select(-2, _reflect101_index(h, rh, img.device))
    if rw:
        p = p.index_select(-1, _reflect101_index(w, rw, img.device))
    p = _corr1d_axis(p, kx, -1)
    return _corr1d_axis(p, ky, -2)


def gaussian_blur(img: torch.Tensor, ksize: int, sigma: float) -> torch.Tensor:
    """``cv.GaussianBlur(img, (ksize, ksize), sigma)`` on float32 images."""
    k = gaussian_kernel(ksize, sigma)
    return sep_filter2d(img, k, k)


def minmax_normalize_f32(img: torch.Tensor) -> torch.Tensor:
    """``cv.normalize(img, None, 0, 1, NORM_MINMAX, CV_32F)``."""
    img = img.to(torch.float32)
    lo = img.min()
    hi = img.max()
    span = hi - lo
    scale = torch.where(hi > lo, span.new_tensor(1.0) / span, 0.0)
    return (img - lo) * scale


def minmax_normalize_u8(img: torch.Tensor) -> torch.Tensor:
    """``cv.normalize(img, None, 0, 255, NORM_MINMAX, CV_8U)``, round half to
    even before the saturating cast."""
    img = img.to(torch.float32)
    lo = img.min()
    hi = img.max()
    span = hi - lo
    # a true division, as the reference computes it (``255.0 / span`` would
    # round twice, through reciprocal and multiply)
    scale = torch.where(hi > lo, span.new_tensor(255.0) / span, 0.0)
    scaled = (img - lo) * scale
    return torch.clamp(torch.round(scaled), 0, 255).to(torch.uint8)


def round_to_dtype(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Round half to even and saturate to an integer ``dtype`` (cv.remap on
    integer images); float dtypes are a plain cast.

    The 32-bit types round and clamp in float64: as a float32 bound their
    maximum is 2**31 or 2**32, out of range, and the cast would wrap it.  In
    float64 the bound is exact, so a value at or above the maximum gives the
    maximum (and ±inf the maximum or minimum), as the kernels' stores do."""
    if dtype.is_floating_point:
        return x.to(dtype)
    info = torch.iinfo(dtype)
    if info.bits >= 32:
        x = x.to(torch.float64)
    return torch.clamp(torch.round(x), info.min, info.max).to(dtype)


def _dog_core(img: torch.Tensor, low_sigma: int, high_sigma: int) -> torch.Tensor:
    fimg = minmax_normalize_f32(img)
    ksize = low_sigma * 4 * 2 + 1  # the reference's "as in opencv" kernel size
    ls = gaussian_blur(fimg, ksize, low_sigma)
    hs = gaussian_blur(fimg, ksize, high_sigma)
    return minmax_normalize_u8(hs - ls)


def dog_traced(img: torch.Tensor, use_it: bool = True, low_sigma: int = 5,
               high_sigma: int = 9) -> torch.Tensor:
    """``dog`` without a host round trip: a u8 image keeps the zero-image
    passthrough on the device; other dtypes always take the processed path."""
    if not use_it:
        return img
    if img.dtype == torch.uint8:
        return torch.where(img.max() == 0, img, _dog_core(img, low_sigma, high_sigma))
    return _dog_core(img, low_sigma, high_sigma)


def dog(img: torch.Tensor, use_it: bool = True, low_sigma: int = 5,
        high_sigma: int = 9) -> torch.Tensor:
    """Difference-of-Gaussians preprocessing: min-max to [0, 1] float, blur
    with a fixed ``low_sigma*8+1`` kernel at both sigmas, subtract, min-max
    to u8.  Returns the input unchanged when ``use_it`` is False or the image
    is all zero."""
    if not use_it:
        return img
    if img.dtype == torch.uint8:
        return dog_traced(img, True, low_sigma, high_sigma)
    if float(img.to(torch.float32).max()) == 0:
        return img
    return _dog_core(img, low_sigma, high_sigma)


def pyr_down(img: torch.Tensor) -> torch.Tensor:
    """``cv.pyrDown``: 5-tap [1,4,6,4,1]/16 blur (REFLECT_101) and 2x
    decimation to ((H+1)//2, (W+1)//2); integer images are rounded back."""
    y = sep_filter2d(img.to(torch.float32), PYR_KERNEL, PYR_KERNEL)
    y = y[..., ::2, ::2]
    return round_to_dtype(y, img.dtype)


def pyr_up(img: torch.Tensor, dstsize: tuple[int, int]) -> torch.Tensor:
    """``cv.pyrUp(img, dstsize=(W, H))`` of (H, W) or (H, W, C) ``img`` (a
    flow field upscales channel by channel); ``dstsize`` is (H, W).
    Zero-stuffs 2x and blurs with 2 * [1,4,6,4,1]/16 per axis.

    OpenCV's borders differ per edge: REFLECT_101 at the top and left,
    REFLECT at the bottom and REPLICATE at the right.  Only the second
    out-of-range tap tells them apart, which odd ``dstsize`` exposes.
    Raises ``ValueError`` where ``cv.pyrUp`` fails its assertion: each side
    of ``dstsize`` must be twice the input's, or one more or less when odd.
    """
    dh, dw = dstsize
    h, w = img.shape[:2]
    if abs(dh - 2 * h) != dh % 2 or abs(dw - 2 * w) != dw % 2:
        raise ValueError(f"pyr_up: dstsize {(dh, dw)} is not twice {(h, w)} (+-1 when odd)")
    x = img.to(torch.float32)
    squeeze = x.dim() == 2
    x = x.unsqueeze(0) if squeeze else x.permute(2, 0, 1)
    dev = x.device
    rows = torch.cat([torch.tensor([2, 1], device=dev).clamp(max=h - 1),
                      torch.arange(h, device=dev),
                      torch.tensor([h - 1, h - 2], device=dev).clamp(min=0)])
    cols = torch.cat([torch.tensor([2, 1], device=dev).clamp(max=w - 1),
                      torch.arange(w, device=dev),
                      torch.tensor([w - 1, w - 1], device=dev)])
    xp = x.index_select(1, rows).index_select(2, cols)
    up = x.new_zeros((x.shape[0], (h + 4) * 2, (w + 4) * 2))
    up[:, ::2, ::2] = xp
    k = PYR_KERNEL * 2.0
    y = _corr1d_axis(up, k, -1)
    y = _corr1d_axis(y, k, -2)
    # source pixel i sits at index 2i + 2 after the VALID passes
    y = y[:, 2 : 2 + dh, 2 : 2 + dw]
    y = round_to_dtype(y, img.dtype)
    return y[0] if squeeze else y.permute(1, 2, 0)
