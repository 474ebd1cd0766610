"""OptFlowRegistrator: multi-scale tiled Farneback registration.

PyTorch counterpart of ``microaligner_tpu/optflow/registrator.py``: both
Gaussian pyramids, then per level, coarsest first, the pre-warp by the
accumulated flow, optional DoG, the banded or per-tile (or whole-image)
Farneback fused with the post-warp, the NMI gate, the tile-wise flow
composition and the pyrUp to the next level.

``register_device`` takes one of the JAX package's drivers, chosen by its
variables on each call:

* ``MICROALIGNER_TPU_CARRY_LEVEL=0``: the stepwise host loop
  (``_register_stepwise``): each level's gate scores are read back and the
  host picks the next flow (accept: compose and upscale; reject: keep,
  upscale or zero);
* else the carry loop (``_register_whole``), one ``_fused_level_carry`` a
  level.  The JAX package's ``MICROALIGNER_TPU_WHOLE_REGISTER`` chooses
  between one compiled program for the whole registration (``1``, its
  default) and one a level; eager PyTorch launches level by level either
  way, so both of its values run this same loop.

In the carry loop the accept/reject decision of each level is a 0-d device
tensor that selects the next flow with ``torch.where``, so nothing is read
back to the host until the end, where all gate scores are fetched at once
for the log.  Every level goes through ``MICROALIGNER_TPU_FLOW_DENSE``'s
route for its flow, its pre-warp and its post-warp, under both drivers.
The JAX package's quirks are kept: the last level is upscaled without scaling its values
(one pyrUp from the original flow, ``_upscale_flow_to_full_res``),
``replicate_reject_upscale_bug`` doubles a rejected mid level's flow
twice, and a single level at (almost) full size keeps its raw flow.
"""

from __future__ import annotations

import math
import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from microaligner_tpu_torch.ops.filters import dog_traced, pyr_down, pyr_up
from microaligner_tpu_torch.ops.mutual_info import mi_tiled_traced
from microaligner_tpu_torch.ops.warp import compose_flows
from microaligner_tpu_torch.optflow.farneback import _farneback_core_parts
from microaligner_tpu_torch.optflow.flow_calc import calc_flow_and_warp_tiled
from microaligner_tpu_torch.optflow.warper import (
    compose_flows_tiled,
    torch_dtype_of,
    warp_tiled_dtype,
)
from microaligner_tpu_torch.tiles import TileGrid
from microaligner_tpu_torch.utils.device import resolve_device
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
    gate scores, each warp and the flow on ``MICROALIGNER_TPU_FLOW_DENSE``'s
    route.  Returns ``(this_flow (H, W, 2), mi_after, mi_before)`` with the
    scores as 0-d device tensors."""
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
        this_flow, mov_warped = calc_flow_and_warp_tiled(
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
    """The whole multi-level registration: ``_fused_level_carry`` over the
    levels, coarsest first.  Returns ``(flow (H, W, 2), [(mi_after,
    mi_before) per level as 0-d device tensors], factors)``."""
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
    there.  It is the first CUDA device unless another is named, and the
    constructor raises when there is no card.  ``band_rows`` sets the
    interior rows per band; when it is None, the JAX package's
    ``MICROALIGNER_TPU_FLOW_BAND_ROWS`` does, when set.
    """

    def __init__(self, device=None):
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
        self.device = resolve_device(device)
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

    def _win_size(self) -> int:
        return self.overlap - (1 - self.overlap % 2)  # tied to the halo width

    def _reject_mult(self) -> int:
        return 4 if self.replicate_reject_upscale_bug else 2

    def _log_scores(self) -> None:
        for factor, mi_after, mi_before in self.last_scores:
            log("Pyramid factor", factor)
            log("    MI score after:", mi_after, "| MI score before:", mi_before)
            log("    Better alignment than before" if mi_after > mi_before
                else "    Worse alignment than before")

    def _fetch_scores(self, factors, scores) -> None:
        """Read every level's gate scores back at once into ``last_scores``."""
        fetched = torch.stack([torch.stack(s) for s in scores]).cpu().tolist()
        self.last_scores = [(f, a, b) for f, (a, b) in zip(factors, fetched)]

    def register_device(self) -> torch.Tensor:
        """:meth:`register` but the flow stays on ``device``.  The per-level
        gate scores land in ``last_scores`` as ``(factor, mi_after,
        mi_before)``: read back once, at the end, on the carry loop, level
        by level on the stepwise one."""
        check_img_is_provided(self._ref_img, "ref")
        check_img_is_provided(self._mov_img, "mov")
        check_img_dims_match(self._ref_img, self._mov_img)
        self._check_levels()
        torch_dtype_of(self._mov_img)  # raises for dtypes the warp cannot keep
        if os.environ.get("MICROALIGNER_TPU_CARRY_LEVEL", "1") == "0":
            return self._register_stepwise()
        ref, mov = self._on_device(self._ref_img), self._on_device(self._mov_img)
        with stage_timer("whole register", ref.device):
            m_flow, scores, factors = _register_whole(
                ref, mov, self.num_pyr_lvl, self.use_full_res_img, self.tile_size,
                self.overlap, self._win_size(), self.num_iterations, self.use_dog,
                self._reject_mult(), self.band_rows,
            )
        self._fetch_scores(factors, scores)
        self._log_scores()
        return m_flow

    def _on_device(self, img) -> torch.Tensor:
        return torch.as_tensor(img).to(self.device)

    def _check_levels(self) -> None:
        """The pyramid's errors, raised before any device work."""
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

    def _register_stepwise(self) -> torch.Tensor:
        """The host-driven accept/reject loop (``MICROALIGNER_TPU_CARRY_LEVEL=0``):
        each level's two gate scores are read back, and the host picks the
        next flow (reference optflow_registrator.py:134-169)."""
        ref_pyr, factors = self._generate_img_pyr(self._on_device(self._ref_img))
        mov_pyr, _ = self._generate_img_pyr(self._on_device(self._mov_img))
        dtype = mov_pyr[-1].dtype
        full_shape = tuple(int(s) for s in self._mov_img.shape)
        num_lvl = len(factors)
        m_flow = None
        self.last_scores = []
        for lvl, factor in enumerate(factors):
            log("Pyramid factor", factor)
            shape = tuple(int(s) for s in mov_pyr[lvl].shape)
            grid = TileGrid.for_image(shape, self.tile_size, self.overlap)
            with stage_timer(f"lvl{factor} fused level", mov_pyr[lvl].device):
                this_flow, mi_after, mi_before = _fused_level(
                    ref_pyr[lvl], mov_pyr[lvl], m_flow, grid, self._win_size(), self.num_iterations,
                    self.use_dog, self.tile_size, lvl != 0, max(shape) / self.tile_size < 2, dtype,
                    self.band_rows,
                )
                mi_after, mi_before = torch.stack([mi_after, mi_before]).cpu().tolist()
            self.last_scores.append((factor, mi_after, mi_before))
            log("    MI score after:", mi_after, "| MI score before:", mi_before)
            is_last = lvl == num_lvl - 1
            next_shape = full_shape if is_last else tuple(int(s) for s in mov_pyr[lvl + 1].shape)
            if mi_after > mi_before:
                log("    Better alignment than before")
                if lvl == 0:
                    if num_lvl > 1:
                        m_flow = self._pyr_up_dev(this_flow * 2, next_shape)
                    else:
                        m_flow = self._upscale_flow_to_full_res(this_flow, factor)
                elif is_last:
                    m_flow = self._merge_list_of_flows([m_flow, this_flow])
                    if not self.use_full_res_img:
                        m_flow = self._upscale_flow_to_full_res(m_flow, factor)
                else:
                    m_flow = self._merge_list_of_flows([m_flow, this_flow])
                    m_flow = self._pyr_up_dev(m_flow * 2, next_shape)
            else:
                log("    Worse alignment than before")
                if lvl == 0:
                    m_flow = torch.zeros(next_shape + (2,), dtype=torch.float32, device=this_flow.device)
                elif is_last:
                    if not self.use_full_res_img:
                        m_flow = self._pyr_up_dev(m_flow * 2, full_shape)
                else:
                    m_flow = self._pyr_up_dev(m_flow * self._reject_mult(), next_shape)
        return m_flow

    # -- helpers -----------------------------------------------------------

    @staticmethod
    def _pyr_up_dev(flow: torch.Tensor, dst_shape) -> torch.Tensor:
        return pyr_up(flow, (int(dst_shape[0]), int(dst_shape[1])))

    def _generate_img_pyr(self, arr: torch.Tensor) -> Tuple[List[torch.Tensor], List[int]]:
        """Smallest-first pyramid on ``arr``'s device; stops before a side
        would drop below 100 px (optflow_registrator.py:175-202)."""
        self._check_levels()
        return _build_pyramid(arr, self.num_pyr_lvl, self.use_full_res_img)

    def _upscale_flow_to_full_res(self, flow: torch.Tensor, pyramid_factor: int) -> torch.Tensor:
        """The reference's chain of pyrUps to full resolution
        (optflow_registrator.py:204-215), quirk kept: its last step
        upscales the ORIGINAL flow, so the result is one pyrUp from ``flow``
        to the full size, values not doubled (the caller's job)."""
        if abs(flow.shape[0] - self._ref_img.shape[0]) <= 1:
            return flow
        num_lvls = int(math.log2(pyramid_factor))
        upscaled = flow
        for i in range(num_lvls):
            if i == num_lvls - 1:
                upscaled = self._pyr_up_dev(flow, self._ref_img.shape)
            else:
                h, w = upscaled.shape[:2]
                upscaled = self._pyr_up_dev(upscaled, (h * 2, w * 2))
        return upscaled

    def _merge_flow_in_tiles(self, flow1: torch.Tensor, flow2: torch.Tensor) -> torch.Tensor:
        """Tile-wise flow composition (optflow_registrator.py:217-233)."""
        grid = TileGrid.for_image(tuple(flow1.shape[:2]), self.tile_size, self.overlap)
        return compose_flows_tiled(flow1, flow2, grid)

    def _merge_list_of_flows(self, flow_list: List[torch.Tensor]) -> torch.Tensor:
        m_flow = flow_list[0]
        for nxt in flow_list[1:]:
            m_flow = self._merge_flow_in_tiles(m_flow, nxt)
        return m_flow
