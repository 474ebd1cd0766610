"""OptFlowRegistrator: multi-scale tiled Farneback registration.

PyTorch counterpart of ``microaligner_tpu/optflow/registrator.py`` on its
default path (``_register_whole``): both Gaussian pyramids, then per level,
coarsest first, the pre-warp by the accumulated flow, optional DoG, the
banded (or whole-image) Farneback fused with the post-warp, the NMI gate,
the tile-wise flow composition and the pyrUp to the next level.

The accept/reject decision of each level is a 0-d device tensor that selects
the next flow with ``torch.where``, so nothing is read back to the host until
the end, where all gate scores are fetched at once for the log.  The JAX
package's quirks are kept: the last level is upscaled without scaling its
values, ``replicate_reject_upscale_bug`` doubles a rejected mid level's flow
twice, and a single level at (almost) full size keeps its raw flow.

The stepwise and host-carry variants (``MICROALIGNER_TPU_CARRY_LEVEL=0``,
``MICROALIGNER_TPU_WHOLE_REGISTER=0``) are not ported.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from microaligner_tpu_torch.ops.filters import dog_traced, pyr_down, pyr_up
from microaligner_tpu_torch.ops.mutual_info import mi_tiled_traced
from microaligner_tpu_torch.ops.warp import compose_flows
from microaligner_tpu_torch.optflow.farneback import _farneback_core_parts
from microaligner_tpu_torch.optflow.flow_calc import calc_flow_and_warp_dense_banded
from microaligner_tpu_torch.optflow.warper import (
    compose_flows_tiled,
    torch_dtype_of,
    warp_tiled_dtype,
)
from microaligner_tpu_torch.tiles import TileGrid
from microaligner_tpu_torch.utils.img_checks import (
    check_img_dims_match,
    check_img_is_2d_grey,
    check_img_is_provided,
)
from microaligner_tpu_torch.utils.logging import log, stage_timer

__all__ = ["OptFlowRegistrator", "merge_two_flows"]


def merge_two_flows(flow1, flow2) -> np.ndarray:
    """Compose two (H, W, 2) flows (``optflow_registrator.py::merge_two_flows``);
    numpy in, numpy out, computed on the device of ``flow1`` if a tensor."""
    f1 = torch.as_tensor(flow1, dtype=torch.float32)
    f2 = torch.as_tensor(flow2, dtype=torch.float32).to(f1.device)
    return compose_flows(f1, f2).cpu().numpy()


def _fused_level(ref_lvl, mov_lvl, m_flow, grid: TileGrid, win_size: int, num_iter: int,
                 use_dog: bool, tile_size: int, pre_warp: bool, whole_image: bool,
                 dtype: torch.dtype, band_rows: Optional[int]):
    """One pyramid level: pre-warp, DoG, Farneback + post-warp, and both NMI
    gate scores.  Returns ``(this_flow (H, W, 2), mi_after, mi_before)``
    with the scores as 0-d device tensors."""
    mov_this = mov_lvl
    if pre_warp:
        mov_this = warp_tiled_dtype(mov_lvl, m_flow, grid, dtype, band_rows)
    ref_dog = dog_traced(ref_lvl, use_dog)
    mov_dog = dog_traced(mov_this, use_dog)
    if whole_image:
        fx, fy = _farneback_core_parts(
            mov_dog.to(torch.float32)[None], ref_dog.to(torch.float32)[None],
            win_size, num_iter, 1, 1.7,
        )
        this_flow = torch.stack([fx[0], fy[0]], dim=-1)
        mov_warped = warp_tiled_dtype(mov_this, this_flow, grid, dtype, band_rows)
    else:
        this_flow, mov_warped = calc_flow_and_warp_dense_banded(
            ref_dog, mov_dog, mov_this, grid, win_size, num_iter, dtype, band_rows
        )
    gate_ref = dog_traced(ref_lvl, True)
    mi_after = mi_tiled_traced(gate_ref, dog_traced(mov_warped, True), tile_size)
    mi_before = mi_tiled_traced(gate_ref, dog_traced(mov_lvl, True), tile_size)
    return this_flow, mi_after, mi_before


def _fused_level_carry(ref_lvl, mov_lvl, m_flow, grid: TileGrid, win_size: int,
                       num_iter: int, use_dog: bool, tile_size: int, pre_warp: bool,
                       whole_image: bool, dtype: torch.dtype, band_rows: Optional[int],
                       is_first: bool, is_last: bool, next_shape, full_shape,
                       use_full_res: bool, reject_mult: int):
    """One level including the accept/reject carry: the composition and one
    pyrUp run unconditionally and ``torch.where`` picks the accepted or the
    rejected input.  Returns ``(m_flow_next, mi_after, mi_before)``."""
    this_flow, mi_after, mi_before = _fused_level(
        ref_lvl, mov_lvl, m_flow, grid, win_size, num_iter, use_dog, tile_size,
        pre_warp, whole_image, dtype, band_rows,
    )
    accept = mi_after > mi_before

    if is_first:
        target = full_shape if is_last else next_shape
        if is_last and abs(this_flow.shape[0] - full_shape[0]) <= 1:
            # single level at (almost) full size: accept keeps the raw flow
            return torch.where(accept, this_flow, 0.0), mi_after, mi_before
        mult = 2.0 if not is_last else 1.0
        up = pyr_up(this_flow * mult, (int(target[0]), int(target[1])))
        return torch.where(accept, up, 0.0), mi_after, mi_before

    merged = compose_flows_tiled(m_flow, this_flow, grid)
    if is_last:
        if use_full_res or abs(merged.shape[0] - full_shape[0]) <= 1:
            return torch.where(accept, merged, m_flow), mi_after, mi_before
        # accept: one pyrUp of the merged flow, values unscaled (the
        # reference's _upscale_flow_to_full_res quirk); reject: the doubled
        # accumulated flow upscaled
        src = torch.where(accept, merged, m_flow * 2.0)
        return pyr_up(src, (int(full_shape[0]), int(full_shape[1]))), mi_after, mi_before
    src = torch.where(accept, merged * 2.0, m_flow * float(reject_mult))
    return pyr_up(src, (int(next_shape[0]), int(next_shape[1]))), mi_after, mi_before


def _build_pyramid(arr: torch.Tensor, num_pyr_lvl: int, use_full_res: bool):
    """Smallest-first Gaussian pyramid; stops before a side drops below 100 px."""
    pyramid: List[torch.Tensor] = []
    factors: List[int] = []
    lvl_img = arr
    for lvl in range(num_pyr_lvl):
        factor = 2 ** (lvl + 1)
        if arr.shape[0] / factor < 100 or arr.shape[1] / factor < 100:
            break
        lvl_img = pyr_down(lvl_img)
        pyramid.append(lvl_img)
        factors.append(factor)
    factors = list(reversed(factors))
    pyramid = list(reversed(pyramid))
    if use_full_res:
        pyramid.append(arr)
        factors.append(1)
    return pyramid, factors


def _register_whole(ref_img: torch.Tensor, mov_img: torch.Tensor, num_pyr_lvl: int,
                    use_full_res: bool, tile_size: int, overlap: int, win_size: int,
                    num_iter: int, use_dog: bool, reject_mult: int,
                    band_rows: Optional[int] = None):
    """The whole multi-level registration.  Returns ``(flow (H, W, 2),
    [(mi_after, mi_before) per level as 0-d device tensors], factors)``."""
    ref_pyr, factors = _build_pyramid(ref_img, num_pyr_lvl, use_full_res)
    mov_pyr, _ = _build_pyramid(mov_img, num_pyr_lvl, use_full_res)
    dtype = mov_img.dtype
    num_lvl = len(factors)
    full_shape = tuple(int(s) for s in mov_img.shape)
    m_flow = None
    scores = []
    for lvl in range(num_lvl):
        shape = tuple(int(s) for s in mov_pyr[lvl].shape)
        grid = TileGrid.for_image(shape, tile_size, overlap)
        is_first = lvl == 0
        is_last = lvl == num_lvl - 1
        next_shape = full_shape if is_last else tuple(int(s) for s in mov_pyr[lvl + 1].shape)
        with stage_timer(f"lvl{factors[lvl]} fused level+carry", ref_img.device):
            m_flow, mi_after, mi_before = _fused_level_carry(
                ref_pyr[lvl], mov_pyr[lvl], m_flow, grid, win_size, num_iter, use_dog,
                tile_size, not is_first, max(shape) / tile_size < 2, dtype, band_rows,
                is_first, is_last, next_shape, full_shape, use_full_res, reject_mult,
            )
        scores.append((mi_after, mi_before))
    return m_flow, scores, factors


class OptFlowRegistrator:
    """Property-style API of the JAX package's ``OptFlowRegistrator``.

    ``device`` is where the registration runs; numpy inputs are copied
    there.  ``band_rows`` overrides the interior rows per band (the JAX
    package's ``MICROALIGNER_TPU_FLOW_BAND_ROWS``).
    """

    def __init__(self, device="cpu"):
        self._ref_img = np.array([])
        self._mov_img = np.array([])
        self.num_pyr_lvl = 4
        self.num_iterations = 3
        self.tile_size = 1000
        self.overlap = 100
        self.use_full_res_img = False
        self.use_dog = False
        self.replicate_reject_upscale_bug = False
        self.band_rows: Optional[int] = None
        self.device = device
        self.last_scores: List[Tuple[int, float, float]] = []

    @property
    def ref_img(self):
        return self._ref_img

    @ref_img.setter
    def ref_img(self, img):
        check_img_is_2d_grey(img, "ref")
        self._ref_img = img

    @property
    def mov_img(self):
        return self._mov_img

    @mov_img.setter
    def mov_img(self, img):
        check_img_is_2d_grey(img, "mov")
        self._mov_img = img

    def register(self) -> np.ndarray:
        """The full-resolution (H, W, 2) flow aligning mov to ref, on the host."""
        return self.register_device().cpu().numpy()

    def register_device(self) -> torch.Tensor:
        """:meth:`register` but the flow stays on ``device``.  The per-level
        gate scores are read back once, at the end, into ``last_scores`` as
        ``(factor, mi_after, mi_before)``."""
        check_img_is_provided(self._ref_img, "ref")
        check_img_is_provided(self._mov_img, "mov")
        check_img_dims_match(self._ref_img, self._mov_img)
        if self.num_pyr_lvl < 0:
            raise ValueError("Number of pyramid levels cannot be less than 0")
        if self.num_pyr_lvl == 0 and not self.use_full_res_img:
            raise ValueError(
                "Number of pyramid levels is 0 and use_full_res_img is False. "
                "Please change one of the parameters"
            )
        shape = tuple(int(s) for s in self._ref_img.shape)
        if not self.use_full_res_img and not any(
            shape[0] / 2 ** (lvl + 1) >= 100 and shape[1] / 2 ** (lvl + 1) >= 100
            for lvl in range(self.num_pyr_lvl)
        ):
            raise ValueError(
                f"Image {shape} is too small for any pyramid level "
                "(min dim 100 px after downscale) and use_full_res_img is "
                "False; enable use_full_res_img or reduce num_pyr_lvl"
            )
        torch_dtype_of(self._mov_img)  # raises for dtypes the warp cannot keep
        ref = torch.as_tensor(self._ref_img).to(self.device)
        mov = torch.as_tensor(self._mov_img).to(self.device)
        win_size = self.overlap - (1 - self.overlap % 2)
        with stage_timer("whole register", ref.device):
            m_flow, scores, factors = _register_whole(
                ref, mov, self.num_pyr_lvl, self.use_full_res_img, self.tile_size,
                self.overlap, win_size, self.num_iterations, self.use_dog,
                4 if self.replicate_reject_upscale_bug else 2, self.band_rows,
            )
        fetched = torch.stack([torch.stack(s) for s in scores]).cpu().tolist()
        self.last_scores = [(f, a, b) for f, (a, b) in zip(factors, fetched)]
        for factor, mi_after, mi_before in self.last_scores:
            log("Pyramid factor", factor)
            log("    MI score after:", mi_after, "| MI score before:", mi_before)
            log("    Better alignment than before" if mi_after > mi_before
                else "    Worse alignment than before")
        return m_flow
