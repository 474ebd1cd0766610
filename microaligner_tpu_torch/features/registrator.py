"""FeatureRegistrator: multi-scale iterative affine registration.

PyTorch counterpart of ``microaligner_tpu/features/registrator.py`` on its
default route (``_calc_ref_fused`` + ``_register_fused``): a Gaussian
pyramid (factors like [8, 4, 2], coarsest first) with the reference
pyramid's features cached, then per level the pre-warp by the composed
matrices of the coarser levels (translations rescaled by 1 / factor) and
``num_iterations`` rounds of find -> match -> RANSAC -> warp -> NMI gate.

Each round's accept/reject stays on the device: the candidate is the
current aligned image warped by the estimate, the gate compares its NMI
with the current one and checks the estimate's scale and centre
(``_valid_transform_traced``), and an accepted round composes the matrix
and realigns from the original mov.  Matrices compose in float32 on the
device.  ``register`` reads back once, at the end: the 2x3 matrix and the
per-round diagnostics for the log.

The JAX package's host-driven drivers are taken by its variables, read on
every ``register``:

* ``MICROALIGNER_TPU_FUSED_REGISTER=0`` (or ``FUSED_LEVEL=0``): the
  per-level driver.  The reference pyramid's features come from
  ``find_features`` a level, and per level the host rescales the coarser
  levels' matrices (``_rescale_t_mat``) and multiplies them in float64
  (``_multiply_transform_matrices``), pre-warps the level through K1
  (``_transform_img_dev``) and aligns it (``_iterative_alignment``: the
  device loop above once, with a logged identity when the reference level
  has fewer than 3 features);
* ``MICROALIGNER_TPU_FUSED_LEVEL=0`` also: each level's rounds are the host
  loop ``_iterative_alignment_steps``: find and match (``_align_imgs``),
  both NMI scores at once (``_mi_gate_pair``) read back, the host's validity
  check (``_check_if_valid_transform``), and an accepted round realigns the
  original mov by the float64 product of the accepted matrices.

Every route reads ``MICROALIGNER_TPU_DAISY_NRM`` once a ``register``
(``0``: the reference's raw DAISY descriptors; unit-norm ones otherwise):
the reference pyramid's features and every round of the moving side are
found in that one mode, and cached reference features found in the other
mode are found again.
"""

from __future__ import annotations

import os
from typing import List, Tuple, Union

import numpy as np
import torch

from microaligner_tpu_torch.features.match import match_descriptors
from microaligner_tpu_torch.features.ransac import _ransac_core
from microaligner_tpu_torch.features.tile_features import (
    HALO,
    Features,
    daisy_normalize,
    features_per_tile,
    find_features,
    find_features_tiled,
    register_img_pair,
)
from microaligner_tpu_torch.ops.affine_tiled import affine_warp_traced
from microaligner_tpu_torch.ops.filters import dog, dog_traced, pyr_down, round_to_dtype
from microaligner_tpu_torch.ops.mutual_info import mi_tiled_traced
from microaligner_tpu_torch.ops.warp import affine_warp
from microaligner_tpu_torch.tiles import TileGrid
from microaligner_tpu_torch.utils.device import resolve_device
from microaligner_tpu_torch.utils.img_checks import (
    check_img_dims_match,
    check_img_is_2d_grey,
    check_img_is_provided,
)
from microaligner_tpu_torch.utils.logging import log, stage_timer

__all__ = ["FeatureRegistrator"]


def _mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """3 x 3 product as elementwise multiply-adds in a fixed order, so a
    CPU run and a card run compose the same float32 matrices."""
    return a[:, 0:1] * b[0:1, :] + a[:, 1:2] * b[1:2, :] + a[:, 2:3] * b[2:3, :]


def _mi_gate_pair(ref_img: torch.Tensor, new_img: torch.Tensor, prev_img: torch.Tensor,
                  tile_size: int) -> Tuple[float, float]:
    """Both NMI gate scores (after, before) of a round, read back at once."""
    rd = dog_traced(ref_img, True)
    after = mi_tiled_traced(rd, dog_traced(new_img, True), tile_size)
    before = mi_tiled_traced(rd, dog_traced(prev_img, True), tile_size)
    return tuple(torch.stack([after, before]).cpu().tolist())


def _valid_transform_traced(est3: torch.Tensor, img_shape) -> torch.Tensor:
    """Device form of the host gates: scale in [0.3, 3] by the 2-D
    decomposition (feature_registrator.py:240-266) and the transformed image
    centre inside the borders (:268-278)."""
    aa, bb = est3[0, 0], est3[1, 0]
    cc, dd = est3[0, 1], est3[1, 1]
    det = aa * dd - bb * cc
    n1 = aa * aa + bb * bb
    n2 = cc * cc + dd * dd
    r = torch.sqrt(torch.clamp_min(n1, 1e-30))
    s = torch.sqrt(torch.clamp_min(n2, 1e-30))
    s1 = torch.where(n1 > 0, r, det / s)
    s2 = torch.where(n1 > 0, det / r, s)
    ok_scale = (((n1 > 0) | (n2 > 0)) & (torch.abs(s1) >= 0.3) & (torch.abs(s1) <= 3.0)
                & (torch.abs(s2) >= 0.3) & (torch.abs(s2) <= 3.0))
    cy, cx = img_shape[0] // 2, img_shape[1] // 2
    center = est3[:, 0] * float(cx) + est3[:, 1] * float(cy) + est3[:, 2]
    border = torch.tensor([img_shape[1], img_shape[0], 1.0], dtype=torch.float32, device=est3.device)
    return ok_scale & ~torch.any(border - torch.abs(center) < 0)


def _level_align_body(ref_img, ref_feats: Features, mov_img, grid: TileGrid, k: int,
                      tile_size: int, num_iterations: int, use_dog: bool, normalize: bool,
                      label: str = "feature"):
    """One pyramid level's whole iterative alignment on the device.

    Returns (composed 2x3 float32, aligned image, diagnostics
    (num_iterations, 5) rows [n_good, n_total, mi_after, mi_before,
    accepted]); ``normalize`` is the DAISY mode of ``ref_feats``.  Under
    ``MICROALIGNER_TPU_PROFILE`` each round's four
    steps are timed as ``{label} find`` (DoG, FAST, DAISY), ``match`` (knn
    and the ratio test), ``ransac`` and ``gate`` (the candidate warp, both
    NMI scores and the realign)."""
    dev = mov_img.device
    eye3 = torch.eye(3, dtype=torch.float32, device=dev)
    dtype = mov_img.dtype
    ref_gate_dog = dog_traced(ref_img, True)  # the MI gate always DoGs
    composed, aligned = eye3, mov_img
    rows = []
    for _ in range(num_iterations):
        with stage_timer(f"{label} find", dev):
            coords, desc, valid, _resp = find_features_tiled(dog_traced(aligned, use_dog), grid, k, normalize)
        with stage_timer(f"{label} match", dev):
            good, ref_idx = match_descriptors(ref_feats.descriptors, desc, ref_feats.valid, valid)
        with stage_timer(f"{label} ransac", dev):
            dst = ref_feats.coords[ref_idx]
            n_good = torch.sum(good)
            params, _count = _ransac_core(coords, dst, good, 0)
        with stage_timer(f"{label} gate", dev):
            a, b, tx, ty = params[0], params[1], params[2], params[3]
            zero, one = torch.zeros_like(a), torch.ones_like(a)
            est = torch.stack([torch.stack([a, -b, tx]), torch.stack([b, a, ty]),
                               torch.stack([zero, zero, one])])
            est = torch.where(n_good >= 3, est, eye3)
            # the candidate warps the CURRENT aligned image; an accepted round
            # realigns from the ORIGINAL mov with the composed matrix
            cand = round_to_dtype(affine_warp_traced(aligned, est[:2]), dtype)
            after = mi_tiled_traced(ref_gate_dog, dog_traced(cand, True), tile_size)
            before = mi_tiled_traced(ref_gate_dog, dog_traced(aligned, True), tile_size)
            accept = (after > before) & _valid_transform_traced(est, tuple(mov_img.shape))
            composed = torch.where(accept, _mm3(composed, est), composed)
            realigned = round_to_dtype(affine_warp_traced(mov_img, composed[:2]), dtype)
            aligned = torch.where(accept, realigned, aligned)
        rows.append(torch.stack([n_good.to(torch.float64), valid.sum().to(torch.float64),
                                 after.to(torch.float64), before.to(torch.float64),
                                 accept.to(torch.float64)]))
    return composed[:2], aligned, torch.stack(rows)


def _build_pyr_levels(img: torch.Tensor, factors) -> list:
    """Pyramid levels for descending ``factors`` ((8, 4, 2) or (8, 4, 2, 1)),
    smallest first; a trailing factor 1 is the image itself."""
    n_down = sum(1 for f in factors if f > 1)
    chain = []
    cur = img
    for _ in range(n_down):
        cur = pyr_down(cur)
        chain.append(cur)
    levels = list(reversed(chain))
    if factors and factors[-1] == 1:
        levels.append(img)
    return levels


def _level_grid(shape, tile_size: int):
    grid = TileGrid.for_image(tuple(int(s) for s in shape), tile_size, HALO)
    return grid, features_per_tile(grid)


def _calc_ref_fused(img: torch.Tensor, factors, tile_size: int, use_dog: bool, normalize: bool):
    """Reference side: pyramid, per-level DoG and tiled features."""
    pyr = _build_pyr_levels(img, factors)
    feats = []
    for lvl in pyr:
        grid, k = _level_grid(lvl.shape, tile_size)
        feats.append(Features(*find_features_tiled(dog_traced(lvl, use_dog), grid, k, normalize)))
    return pyr, feats


def _tscale(scale: float, device) -> torch.Tensor:
    """Elementwise mask that rescales a homogeneous matrix's translation."""
    return torch.tensor([[1.0, 1.0, scale], [1.0, 1.0, scale], [1.0, 1.0, 1.0]],
                        dtype=torch.float32, device=device)


def _register_fused(ref_pyr, ref_feats, mov_img: torch.Tensor, factors, tile_size: int,
                    num_iterations: int, use_dog: bool, normalize: bool):
    """The whole multi-level registration on the device (reference
    feature_registrator.py:75-116).  Returns (2x3 float32, diagnostics
    (n_lvl, num_iterations, 5)), both on the device."""
    dev = mov_img.device
    mov_pyr = _build_pyr_levels(mov_img, factors)
    fullscale = []  # homogeneous 3 x 3 at full resolution
    diags = []
    for i, factor in enumerate(factors):
        mov_lvl = mov_pyr[i]
        with stage_timer(f"feature lvl{factor}", dev):
            if i > 0:
                acc = torch.eye(3, dtype=torch.float32, device=dev)
                for m in fullscale:
                    acc = _mm3(acc, m * _tscale(1.0 / factor, dev))
                mov_lvl = round_to_dtype(affine_warp_traced(mov_lvl, acc[:2]), mov_lvl.dtype)
            grid, k = _level_grid(mov_lvl.shape, tile_size)
            tmat2, _aligned, diag = _level_align_body(
                ref_pyr[i], ref_feats[i], mov_lvl, grid, k, tile_size, num_iterations, use_dog,
                normalize, f"feature lvl{factor}")
        hom = torch.cat([tmat2, torch.tensor([[0.0, 0.0, 1.0]], device=dev)], dim=0)
        fullscale.append(hom * _tscale(float(factor), dev))
        diags.append(diag)
    final = fullscale[0]
    for m in fullscale[1:]:
        final = _mm3(final, m)
    return final[:2], torch.stack(diags)


class FeatureRegistrator:
    """Property-style API of the JAX package's ``FeatureRegistrator``;
    ``device`` is where it runs (numpy inputs are copied there): the first
    CUDA device unless another is named, raising when there is no card."""

    def __init__(self, device=None):
        self._ref_img = np.array([])
        self._mov_img = np.array([])
        self.num_pyr_lvl = 3
        self.num_iterations = 3
        self.tile_size = 1000
        self.use_full_res_img = False
        self.use_dog = True
        self.device = resolve_device(device)
        self._ref_pyr_features: List[Features] = []
        self._ref_img_pyr: List[torch.Tensor] = []
        self._factors = [8, 4, 2]
        self._normalize = True  # the DAISY mode of the cached reference features

    @property
    def ref_img(self):
        return self._ref_img

    @ref_img.setter
    def ref_img(self, img):
        check_img_is_2d_grey(img, "ref")
        self._ref_img = img
        self._ref_pyr_features = []  # invalidate the cache

    @property
    def mov_img(self):
        return self._mov_img

    @mov_img.setter
    def mov_img(self, img):
        check_img_is_2d_grey(img, "mov")
        self._mov_img = img

    def _pyr_factors(self) -> List[int]:
        """Descending pyramid factors for the reference's shape."""
        return self._pyr_factors_of(tuple(self._ref_img.shape))

    def _pyr_factors_of(self, shape) -> List[int]:
        """Descending pyramid factors for ``shape``: a level exists while
        both sides stay >= 100 px."""
        if self.num_pyr_lvl < 0:
            raise ValueError("Number of pyramid levels cannot be less than 0")
        if self.num_pyr_lvl == 0 and not self.use_full_res_img:
            raise ValueError(
                "Number of pyramid levels is 0 and use_full_res_img is False. "
                "Please change one of the parameters"
            )
        n_lvl = 0
        for lvl in range(self.num_pyr_lvl):
            factor = 2 ** (lvl + 1)
            if shape[0] / factor < 100 or shape[1] / factor < 100:
                break
            n_lvl = lvl + 1
        factors = [2 ** (lvl + 1) for lvl in reversed(range(n_lvl))]
        if self.use_full_res_img:
            factors.append(1)
        if not factors:
            raise ValueError(
                f"Image {tuple(shape)} is too small for any pyramid level (min dim "
                "100 px after downscale) and use_full_res_img is False; "
                "enable use_full_res_img or reduce num_pyr_lvl"
            )
        return factors

    def _on_device(self, img) -> torch.Tensor:
        return torch.as_tensor(img).to(self.device)

    @staticmethod
    def _fused_register_enabled() -> bool:
        return (os.environ.get("MICROALIGNER_TPU_FUSED_REGISTER", "1") != "0"
                and os.environ.get("MICROALIGNER_TPU_FUSED_LEVEL", "1") != "0")

    def calc_ref_img_features(self):
        self._normalize = daisy_normalize()
        if not self._fused_register_enabled():
            self._ref_img_pyr, self._factors = self._generate_img_pyr(self._on_device(self._ref_img))
            self._ref_pyr_features = [find_features(dog(lvl, self.use_dog), self.tile_size,
                                                    normalize=self._normalize)
                                      for lvl in self._ref_img_pyr]
            return
        self._factors = self._pyr_factors()
        with stage_timer("feature reference pyramid", self.device):
            pyr, feats = _calc_ref_fused(self._on_device(self._ref_img), tuple(self._factors),
                                         self.tile_size, self.use_dog, self._normalize)
        self._ref_img_pyr = pyr
        self._ref_pyr_features = feats

    def register(self, reuse_ref_img: bool = False) -> np.ndarray:
        """One mov/ref pair -> the 2x3 affine matrix mapping mov coords to
        ref coords (float64 numpy)."""
        check_img_is_provided(self._ref_img, "ref")
        check_img_is_provided(self._mov_img, "mov")
        check_img_dims_match(self._ref_img, self._mov_img)
        if self.num_iterations < 1:
            raise ValueError("Number of iterations cannot be less than 1")
        if not (reuse_ref_img and self._ref_pyr_features and self._normalize == daisy_normalize()):
            self.calc_ref_img_features()
        if not self._fused_register_enabled():
            return self._register_per_level()
        tmat, diags = _register_fused(
            self._ref_img_pyr, self._ref_pyr_features, self._on_device(self._mov_img),
            tuple(self._factors), self.tile_size, self.num_iterations, self.use_dog, self._normalize)
        fetched = torch.cat([tmat.to(torch.float64).reshape(-1), diags.reshape(-1)]).cpu().numpy()
        tmat = fetched[:6].reshape(2, 3)
        diags = fetched[6:].reshape(len(self._factors), self.num_iterations, 5)
        for lvl, factor in enumerate(self._factors):
            log("Pyramid factor", factor)
            self._log_diag(diags[lvl])
        return tmat

    def _log_diag(self, diag) -> None:
        for i, (n_good, n_total, after, before, accepted) in enumerate(diag):
            log("    Iteration", i + 1, "/", self.num_iterations)
            log("    Good matches", int(n_good), "/", int(n_total))
            log("    MI score after:", float(after), "| MI score before:", float(before))
            log("    Better alignment than before" if accepted > 0
                else "    Worse alignment than before")

    def _register_per_level(self) -> np.ndarray:
        """The per-level driver (reference feature_registrator.py:75-116):
        the host composes the levels' matrices in float64."""
        mov_img_pyrs, _ = self._generate_img_pyr(self._on_device(self._mov_img))
        fullscale_t_mat_list: List[np.ndarray] = []
        for i, factor in enumerate(self._factors):
            log("Pyramid factor", factor)
            mov_lvl = mov_img_pyrs[i]
            if i > 0:
                rescaled = [self._rescale_t_mat(m, 1 / factor) for m in fullscale_t_mat_list]
                mov_lvl = self._transform_img_dev(mov_lvl, self._multiply_transform_matrices(rescaled))
            with stage_timer(f"feature lvl{factor}", self.device):
                _, t_mat = self._iterative_alignment(self._ref_img_pyr[i], self._ref_pyr_features[i],
                                                     mov_lvl)
            fullscale_t_mat_list.append(self._rescale_t_mat(t_mat, factor))
        return self._multiply_transform_matrices(fullscale_t_mat_list)

    def _generate_img_pyr(self, arr: torch.Tensor) -> Tuple[List[torch.Tensor], List[int]]:
        """The Gaussian pyramid on ``arr``'s device, smallest level first
        (reference feature_registrator.py:134-160), and its factors."""
        factors = self._pyr_factors_of(tuple(arr.shape))
        return _build_pyr_levels(arr, factors), factors

    def _transform_img_dev(self, img: torch.Tensor, t_mat: np.ndarray) -> torch.Tensor:
        """:meth:`transform_img` on the device: the affine warp through K1,
        rounded back to the image's dtype.  The matrix goes to the device in
        float32 and is inverted there (``affine_warp_traced``), so the host
        drivers warp as the device loop does: the JAX package's host and
        traced warps give the same image too."""
        fwd = torch.as_tensor(np.asarray(t_mat, np.float64), dtype=torch.float32, device=img.device)
        return round_to_dtype(affine_warp_traced(img, fwd), img.dtype)

    def _iterative_alignment(self, ref_img, ref_features: Features, mov_img):
        """One level's rounds: (aligned image, 2x3 float64 matrix).  The
        device loop (``_level_align_body``) once, read back at its end, or,
        under ``MICROALIGNER_TPU_FUSED_LEVEL=0``, the host loop."""
        if os.environ.get("MICROALIGNER_TPU_FUSED_LEVEL", "1") == "0":
            return self._iterative_alignment_steps(ref_img, ref_features, mov_img)
        if not ref_features.is_valid():
            # matching gives the identity and the gate rejects every round; the
            # device loop would say nothing of why, so the log says it here
            log("    No usable reference features (< 3 valid) — identity transform")
            for i in range(self.num_iterations):
                log("    Iteration", i + 1, "/", self.num_iterations)
                log("    Worse alignment than before")
            return mov_img, np.eye(2, 3)
        grid, k = _level_grid(mov_img.shape, self.tile_size)
        tmat, aligned, diag = _level_align_body(ref_img, ref_features, mov_img, grid, k, self.tile_size,
                                                self.num_iterations, self.use_dog, self._normalize)
        fetched = torch.cat([tmat.to(torch.float64).reshape(-1), diag.reshape(-1)]).cpu().numpy()
        self._log_diag(fetched[6:].reshape(self.num_iterations, 5))
        return aligned, fetched[:6].reshape(2, 3)

    def _iterative_alignment_steps(self, ref_img, ref_features: Features, mov_img):
        """The host-driven loop of a level's rounds (reference
        feature_registrator.py:162-192)."""
        t_matrices: List[np.ndarray] = []
        aligned_img = mov_img
        for i in range(self.num_iterations):
            log("    Iteration", i + 1, "/", self.num_iterations)
            mov_img_aligned, est_t_mat = self._align_imgs(ref_features, aligned_img)
            mi_after, mi_before = _mi_gate_pair(ref_img, mov_img_aligned, aligned_img, self.tile_size)
            log("    MI score after:", mi_after, "| MI score before:", mi_before)
            if mi_after > mi_before and self._check_if_valid_transform(est_t_mat, tuple(mov_img.shape)):
                log("    Better alignment than before")
                t_matrices.append(est_t_mat)
                # realign the ORIGINAL mov by the composed matrix (reference :186)
                aligned_img = self._transform_img_dev(mov_img, self._multiply_transform_matrices(t_matrices))
            else:
                log("    Worse alignment than before")
                t_matrices.append(np.eye(2, 3))
        return aligned_img, self._multiply_transform_matrices(t_matrices)

    def _align_imgs(self, ref: Union[torch.Tensor, Features], mov_img: torch.Tensor):
        """(mov warped by the estimate, estimate): find and match the
        features, fit the matrix; the identity leaves mov as it is."""
        ref_features = ref if isinstance(ref, Features) else find_features(
            dog(ref, self.use_dog), self.tile_size, normalize=self._normalize)
        mov_features = find_features(dog_traced(mov_img, self.use_dog), self.tile_size, normalize=self._normalize)
        transform_mat = register_img_pair(ref_features, mov_features)
        if np.array_equal(transform_mat, np.eye(2, 3)):
            return mov_img, np.eye(2, 3)
        return self._transform_img_dev(mov_img, transform_mat), transform_mat

    @staticmethod
    def _multiply_transform_matrices(mat_list: List[np.ndarray]) -> np.ndarray:
        if len(mat_list) == 1:
            return mat_list[0]
        res = np.vstack([mat_list[0], [0, 0, 1]])
        for m in mat_list[1:]:
            res = res @ np.vstack([m, [0, 0, 1]])
        return res[:2, :]

    @staticmethod
    def _rescale_t_mat(t_mat: np.ndarray, scale: float) -> np.ndarray:
        out = np.array(t_mat, dtype=np.float64)
        out[0, 2] *= scale
        out[1, 2] *= scale
        return out

    def transform_img(self, img, t_mat: np.ndarray) -> np.ndarray:
        """Affine warp keeping the dtype (integers round half to even and
        clip); one bilinear path for every size (the reference splits at
        32k between warpAffine and skimage)."""
        img = np.asarray(img)
        out = affine_warp(torch.from_numpy(np.ascontiguousarray(img)).to(torch.float32), t_mat,
                          device=self.device)
        if np.issubdtype(img.dtype, np.integer):
            info = np.iinfo(img.dtype)
            return np.clip(np.round(out.cpu().numpy()), info.min, info.max).astype(img.dtype)
        return out.cpu().numpy().astype(img.dtype)

    def transform_big_img(self, img, t_mat: np.ndarray) -> np.ndarray:
        """The reference's API (feature_registrator.py:118-126): the same
        path as :meth:`transform_img`."""
        return self.transform_img(img, t_mat)

    def _check_if_valid_transform(self, t_mat, img_shape) -> bool:
        return self._check_if_inside_borders(t_mat, img_shape) and self._check_if_proper_scale(t_mat)

    @staticmethod
    def _check_if_proper_scale(t_mat) -> bool:
        """Scale within [0.3, 3] by the 2-D decomposition
        (feature_registrator.py:240-266)."""
        a, b, c, d = t_mat[0, 0], t_mat[1, 0], t_mat[0, 1], t_mat[1, 1]
        det = a * d - b * c
        if a != 0 or b != 0:
            r = np.sqrt(a * a + b * b)
            scale = (r, det / r)
        elif c != 0 or d != 0:
            s = np.sqrt(c * c + d * d)
            scale = (det / s, s)
        else:
            return False
        return 0.3 <= abs(scale[0]) <= 3 and 0.3 <= abs(scale[1]) <= 3

    @staticmethod
    def _check_if_inside_borders(t_mat, img_shape) -> bool:
        """The transformed image centre stays inside the image
        (feature_registrator.py:268-278)."""
        cy, cx = img_shape[0] // 2, img_shape[1] // 2
        center = np.vstack([t_mat, [0, 0, 1]]) @ np.array([cx, cy, 1.0])
        border = np.array([img_shape[1], img_shape[0], 1.0])
        return not np.any(border - np.abs(center) < 0)
