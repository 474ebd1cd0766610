"""Tiled feature extraction and image-pair matching.

PyTorch counterpart of ``microaligner_tpu/features/tile_features.py``: the
image is cut into tiles with a 51 px halo, FAST corners are found on each
tile's interior, DAISY descriptors are sampled on the halo tile at the
interior coords (the reference's consistent (-51, -51) offset quirk,
feature_detection.py:106-108), keypoints move to global coords, and a
partial affine is fitted on ratio-filtered exact-knn matches.  The per-tile
budget is ``min(1_000_000 // n_tiles, 5000)`` keypoints.

Three executions, chosen as the JAX package chooses them
(``_dense_level_enabled``, read on every call), because they give
different descriptors near tile seams:

* whole level, while ``MICROALIGNER_TPU_FEATURE_DENSE`` is ``1``, or
  ``auto`` (the default) and the padded canvas is at most
  ``MICROALIGNER_TPU_FEATURE_DENSE_MAX_MPIX`` Mpix (default 26): FAST
  over the zero-padded interior canvas with per-tile frames and top-k,
  DAISY cubes over the halo-padded canvas, one gather;
* per tile, when ``MICROALIGNER_TPU_FEATURE_DENSE=0`` forces it: the
  tiles with their 51 px halo (``split_into_tiles``), one at a time, FAST
  top-k on the interior and DAISY on the halo tile at the interior coords;
* banded otherwise: the whole-level path a grid row at a time, cubes over
  the band with ``halo`` rows of context.

The banded and per-tile maps are sharded over the tile mesh of the image's
device (``parallel.current_tile_mesh``), one grid row or one tile a call,
as the JAX package's ``unbatched`` maps are; the whole level is one call.

FAST is bit-exact across the three: coords, validity and responses agree.

Each path L2-normalizes its descriptors unless
``MICROALIGNER_TPU_DAISY_NRM=0`` asks for the reference's raw ones (cv2's
``NRM_NONE``, :func:`daisy_normalize`), and runs DAISY's blur products on
the operands that ``MICROALIGNER_TPU_DAISY_EXACT`` picks for the device
(:func:`daisy_operand_dtype`: bf16 on the card unless it is ``1``);
:func:`match_features` takes the knn's operands from
``MICROALIGNER_TPU_MATCH_F32`` (:func:`match_operand_dtype`).  Each
function reads a variable it is not given on each call; the JAX package
reads them once a trace, so its tests clear JAX's caches between the
modes, and the port needs no such step.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from microaligner_tpu_torch.features.daisy import (
    _gather_descriptors,
    _orientation_cubes,
    daisy_at_points,
    normalize_descriptors,
)
from microaligner_tpu_torch.features.fast import fast_detect_topk, fast_detect_topk_grid
from microaligner_tpu_torch.features.match import match_descriptors
from microaligner_tpu_torch.features.ransac import estimate_affine_partial_2d
from microaligner_tpu_torch.features.routes import daisy_normalize, daisy_operand_dtype, match_operand_dtype
from microaligner_tpu_torch.ops.pad import zero_pad
from microaligner_tpu_torch.parallel.tile_runner import current_tile_mesh, tile_map
from microaligner_tpu_torch.tiles import TileGrid, split_into_tiles
from microaligner_tpu_torch.utils.device import resolve_device
from microaligner_tpu_torch.utils.logging import log

__all__ = ["Features", "find_features", "register_img_pair", "match_features", "daisy_normalize",
           "daisy_operand_dtype", "match_operand_dtype"]

HALO = 51  # the reference's overlap for the feature path (tile_registration.py:33)


class Features:
    """Fixed-capacity keypoint set: global coords (N, 2) [x, y], descriptors
    (N, D) and a validity mask (N,), all on one device."""

    def __init__(self, coords=None, descriptors=None, valid=None, responses=None):
        self.coords = coords
        self.descriptors = descriptors
        self.valid = valid
        self.responses = responses
        self._num_valid = None  # cached: one device round trip per Features

    def is_valid(self) -> bool:
        if self.coords is None or self.descriptors is None:
            return False
        return self.num_valid >= 3

    @property
    def num_valid(self) -> int:
        if self.valid is None:
            return 0
        if self._num_valid is None:
            self._num_valid = int(torch.as_tensor(self.valid).sum())
        return self._num_valid


def features_per_tile(grid: TileGrid) -> int:
    return min(1_000_000 // grid.num_tiles, 5000)


def _canvases(img: torch.Tensor, grid: TileGrid):
    """The zero-padded interior canvas (FAST) and the halo-padded f32 canvas
    (DAISY), zeros outside the image."""
    ph, pw = grid.padded_h - grid.height, grid.padded_w - grid.width
    interior = zero_pad(img, 0, ph, 0, pw)
    halo = zero_pad(img.to(torch.float32), HALO, ph + HALO, HALO, pw + HALO)
    return interior, halo


def _tile_origins(grid: TileGrid, device) -> torch.Tensor:
    """(N, 2) float32 [x, y] tile origins, row-major."""
    tids = torch.arange(grid.num_tiles, device=device)
    return torch.stack([(tids % grid.nx) * grid.tile_w, (tids // grid.nx) * grid.tile_h],
                       dim=-1).to(torch.float32)


def _find_features_dense(img: torch.Tensor, grid: TileGrid, k: int, normalize: bool,
                         daisy_dtype: torch.dtype = torch.float32):
    """Whole-level FAST + DAISY.  Returns tile-local coords (N, k, 2),
    descriptors (N, k, 200), valid and responses (N, k)."""
    interior, halo = _canvases(img, grid)
    coords, resp, valid = fast_detect_topk_grid(interior, grid.tile_h, grid.tile_w, k, threshold=1)
    del interior
    # the reference samples the halo tile at interior coords, a consistent
    # (-halo, -halo) offset; in halo-canvas coordinates it cancels, so the
    # sampling happens at global coords
    cubes = _orientation_cubes(halo, daisy_dtype)
    del halo
    global_coords = (coords + _tile_origins(grid, img.device)[:, None, :]).reshape(-1, 2)
    desc = _gather_descriptors(cubes, global_coords)
    del cubes
    if normalize:
        desc = normalize_descriptors(desc)
    return coords, desc.reshape(grid.num_tiles, k, -1), valid, resp


def _find_features_banded(img: torch.Tensor, grid: TileGrid, k: int, normalize: bool,
                          daisy_dtype: torch.dtype = torch.float32):
    """Grid row by grid row: FAST on the band (bit-exact with the whole-level
    path: the band edges are tile edges), DAISY cubes over the band with
    full-width context and ``HALO`` rows above and below."""
    interior, halo = _canvases(img, grid)
    th, tw = grid.tile_h, grid.tile_w
    ox = (torch.arange(grid.nx, device=img.device) * tw).to(torch.float32)
    shift = torch.stack([ox, torch.zeros_like(ox)], dim=-1)[:, None, :]

    def band(i, interior, halo, shift):
        i = int(i)
        coords, resp, valid = fast_detect_topk_grid(interior[i * th : (i + 1) * th], th, tw, k,
                                                    threshold=1)
        cubes = _orientation_cubes(halo[i * th : (i + 1) * th + 2 * HALO], daisy_dtype)
        # band-halo frame: x = global x (halo offset and quirk cancel), y =
        # tile-local y (the band row is the tile row)
        desc = _gather_descriptors(cubes, (coords + shift).reshape(-1, 2))
        del cubes
        if normalize:
            desc = normalize_descriptors(desc)
        return coords, desc.reshape(grid.nx, k, -1), valid, resp

    outs = tile_map(band, (torch.arange(grid.ny),), batch=1, mesh=current_tile_mesh(img.device),
                    broadcast=(interior, halo, shift), unbatched=True)
    return tuple(o.reshape((grid.num_tiles,) + tuple(o.shape[2:])) for o in outs)


def _find_features_per_tile(img: torch.Tensor, grid: TileGrid, k: int, normalize: bool,
                            daisy_dtype: torch.dtype = torch.float32):
    """One halo tile at a time: FAST top-k on its interior, DAISY on the
    whole halo tile at the interior coords (the reference's consistent
    (-51, -51) offset, which cancels between ref and mov)."""
    tiles = split_into_tiles(img, grid)  # (N, tile + 102, tile + 102)

    def per_tile(tile):
        coords, resp, valid = fast_detect_topk(tile[HALO:-HALO, HALO:-HALO], k, threshold=1)
        desc = daisy_at_points(tile.to(torch.float32), coords, normalize=normalize, operand_dtype=daisy_dtype)
        return coords, desc, valid, resp

    return tile_map(per_tile, (tiles,), batch=1, mesh=current_tile_mesh(img.device), unbatched=True)


def _dense_level_enabled(grid: TileGrid) -> bool:
    """The JAX package's gate of the whole-level path:
    ``MICROALIGNER_TPU_FEATURE_DENSE`` ``1`` forces it, ``0`` forbids it,
    ``auto`` (the default) takes it while the padded canvas is at most
    ``MICROALIGNER_TPU_FEATURE_DENSE_MAX_MPIX`` Mpix (default 26)."""
    mode = os.environ.get("MICROALIGNER_TPU_FEATURE_DENSE", "auto")
    if mode == "0":
        return False
    if mode == "1":
        return True
    max_mpix = float(os.environ.get("MICROALIGNER_TPU_FEATURE_DENSE_MAX_MPIX", "26"))
    return grid.padded_h * grid.padded_w <= max_mpix * 1e6


def _per_tile_forced() -> bool:
    return os.environ.get("MICROALIGNER_TPU_FEATURE_DENSE", "auto") == "0"


def find_features_tiled(img: torch.Tensor, grid: TileGrid, k: int, normalize: bool | None = None,
                        daisy_dtype: torch.dtype | None = None):
    """Tiled FAST + DAISY -> flat global (coords (N*k, 2), descriptors
    (N*k, 200), valid (N*k,), responses (N*k,)): the whole level, per tile
    or banded, as the JAX package's ``_find_features_tiled_jit`` picks.
    ``normalize`` None reads :func:`daisy_normalize` and ``daisy_dtype``
    (the operands of DAISY's blur products) None reads
    :func:`daisy_operand_dtype` for ``img``'s device, on this call."""
    if normalize is None:
        normalize = daisy_normalize()
    if daisy_dtype is None:
        daisy_dtype = daisy_operand_dtype(img.device)
    if _dense_level_enabled(grid):
        coords, desc, valid, resp = _find_features_dense(img, grid, k, normalize, daisy_dtype)
    elif _per_tile_forced():
        coords, desc, valid, resp = _find_features_per_tile(img, grid, k, normalize, daisy_dtype)
    else:
        coords, desc, valid, resp = _find_features_banded(img, grid, k, normalize, daisy_dtype)
    coords = coords + _tile_origins(grid, img.device)[:, None, :]
    n = grid.num_tiles * k
    return coords.reshape(n, 2), desc.reshape(n, -1), valid.reshape(n), resp.reshape(n)


def find_features(img, tile_size: int, device=None, normalize: bool | None = None,
                  daisy_dtype: torch.dtype | None = None) -> Features:
    """Global feature set of a 2-D image (reference tile_registration.py:78-92).
    A constant image has no FAST corners, so its set comes back all invalid
    without a host check.  It runs on ``device``; by default a tensor stays
    where it is and a numpy array goes to the first CUDA device (raising
    when there is no card).  ``normalize`` and ``daisy_dtype`` as
    :func:`find_features_tiled`."""
    if device is not None or not isinstance(img, torch.Tensor):
        img = torch.as_tensor(img).to(resolve_device(device))
    grid = TileGrid.for_image(tuple(img.shape), tile_size, HALO)
    return Features(*find_features_tiled(img, grid, features_per_tile(grid), normalize, daisy_dtype))


def match_features(ref_features: Features, mov_features: Features, seed: int = 0,
                   match_dtype: torch.dtype | None = None) -> np.ndarray:
    """The 2x3 matrix mov -> ref from matched features (reference
    feature_detection.py:121-158); identity with fewer than 3 matches.
    ``match_dtype`` is the knn cross term's operand dtype; None reads
    :func:`match_operand_dtype` for the descriptors' device."""
    if not ref_features.is_valid() or not mov_features.is_valid():
        return np.eye(2, 3)
    good, ref_idx = match_descriptors(ref_features.descriptors, mov_features.descriptors,
                                      ref_features.valid, mov_features.valid, operand_dtype=match_dtype)
    counts = torch.stack([torch.sum(good), torch.sum(mov_features.valid)]).cpu().tolist()
    log("    Good matches", counts[0], "/", counts[1])
    if counts[0] < 3:
        return np.eye(2, 3)
    tmat, _ = estimate_affine_partial_2d(mov_features.coords, ref_features.coords[ref_idx], valid=good, seed=seed,
                                         nvalid_hint=counts[0])
    return tmat


def register_img_pair(ref_features: Features, mov_features: Features,
                      match_dtype: torch.dtype | None = None) -> np.ndarray:
    return match_features(ref_features, mov_features, match_dtype=match_dtype)
