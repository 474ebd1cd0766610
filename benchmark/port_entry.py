"""Every binding of the benchmark to the port, ``microaligner_tpu_torch``.

The benchmark drives the per-cycle path of the port's CLI
(``pipeline/runner.py``): the z-max projection of the reference channel;
FeatureReg's register against the reference cycle and the streamed affine
apply of every plane (``do_feature_reg``, ``transform_and_save_freg_imgs``);
OptFlowReg's register against the previous cycle's warped reference
channel, the Warper on that channel and the streamed flow apply of every
plane (``register_and_save_ofreg_imgs``).  It does so with the runner's own
per-plane functions.  The planes come from host arrays instead of TIFF
pages, and the applied planes land in host arrays instead of memmaps, so no
disk is read or written.

The program names used here are the surface the benchmark needs; a change
to the port keeps them:

* ``microaligner_tpu_torch.FeatureRegistrator``, ``OptFlowRegistrator``,
  ``Warper`` and their attributes and methods named in :class:`Cycles`;
* ``microaligner_tpu_torch.pipeline.apply.stream_apply``;
* ``microaligner_tpu_torch.pipeline.runner._apply_affine_plane`` and
  ``_apply_flow_plane``;
* ``microaligner_tpu_torch.ops.warp.inverse_of``;
* ``microaligner_tpu_torch.utils.pages.max_project_u8``;
* ``microaligner_tpu_torch.tiles.TileGrid``;
* ``microaligner_tpu_torch.ops.cuda_lib.build`` (builds or finds the
  kernels under ``microaligner_tpu_torch/_build/``);
* ``microaligner_tpu_torch.utils.logging``'s ``[profile] <stage>: <s>s``
  lines under ``MICROALIGNER_TPU_PROFILE=1``.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

import microaligner_tpu_torch as port
from microaligner_tpu_torch.ops import cuda_lib
from microaligner_tpu_torch.ops.warp import inverse_of
from microaligner_tpu_torch.pipeline import runner
from microaligner_tpu_torch.pipeline.apply import stream_apply
from microaligner_tpu_torch.tiles import TileGrid
from microaligner_tpu_torch.utils.pages import max_project_u8

PROFILE_VARIABLE = "MICROALIGNER_TPU_PROFILE"
WORK_DTYPE = torch.uint16  # the runner's work dtype of u16 planes


def build_kernels() -> None:
    """Build the port's CUDA kernels, or find them built."""
    cuda_lib.build()


def _no_span(_name: str):
    return contextlib.nullcontext()


class Cycles:
    """The port set up for one configuration: the reference cycle's state
    and the chain of OptFlowReg's warped reference channels.  ``run`` takes
    one moving cycle through the CLI's steps."""

    def __init__(self, config: dict, ref_cycle: np.ndarray, device, ref_channel: int = 0):
        self.device = torch.device(device)
        self.ref_channel = ref_channel
        self.shape = tuple(int(s) for s in config["plane"])
        feat, flow = config.get("FeatureReg"), config.get("OptFlowReg")
        self.freg = None
        if feat is not None:
            self.freg = port.FeatureRegistrator(device=self.device)
            self.freg.num_pyr_lvl = feat["NumberPyramidLevels"]
            self.freg.num_iterations = feat["NumberIterationsPerLevel"]
            self.freg.tile_size = feat["TileSize"]
            self.freg.use_full_res_img = feat["UseFullResImage"]
            self.freg.use_dog = feat["UseDOG"]
            self.freg.ref_img = self.project(ref_cycle)
        self.ofreg = port.OptFlowRegistrator(device=self.device)
        self.ofreg.tile_size, self.ofreg.overlap = flow["TileSize"], flow["Overlap"]
        self.ofreg.num_pyr_lvl = flow["NumberPyramidLevels"]
        self.ofreg.num_iterations = flow["NumberIterationsPerLevel"]
        self.ofreg.use_full_res_img = flow["UseFullResImage"]
        self.ofreg.use_dog = flow["UseDOG"]
        self.warper = port.Warper(device=self.device)
        self.warper.tile_size, self.warper.overlap = flow["TileSize"], flow["Overlap"]
        # the chain starts at the reference cycle, whose FeatureReg output is itself
        self.ref_img = self.project(ref_cycle)
        self.last = {}

    def project(self, planes: np.ndarray) -> torch.Tensor:
        """z-max projection of the reference channel, a u8 device tensor."""
        return max_project_u8(iter(planes[self.ref_channel]), self.device)

    def _apply(self, planes: np.ndarray, out: np.ndarray, device_fn) -> None:
        """Every (channel, z) plane through ``device_fn`` into ``out``,
        streamed as the runner streams them."""
        def items():
            for ch in range(planes.shape[0]):
                for z in range(planes.shape[1]):
                    yield (ch, z), planes[ch, z]

        def write_fn(key, plane):
            np.copyto(out[key], plane)

        stream_apply(items(), device_fn, write_fn, device=self.device)

    def run(self, planes: np.ndarray, affine_out: np.ndarray | None, flow_out: np.ndarray, span=_no_span) -> None:
        """One moving cycle, (channels, z, H, W) u16 ``planes``: the
        registers and the applies, the applied planes written into
        ``affine_out`` (FeatureReg's, when configured) and ``flow_out``.
        ``self.last`` keeps what the cycle produced, and under ``prev`` the
        flow (and matrix) of the cycle before, which made the chain's state
        this cycle registered against.  Of the cycles before, the runner
        keeps alive only what the registrators and the Warper hold; so does
        this, but for that flow, held past the register to the cycle's end."""
        h, w = self.shape
        prev = {k: self.last[k] for k in ("flow", "tmat") if k in self.last}
        self.last = {}
        last = {}
        if self.freg is not None:
            with span("projection"):
                self.freg.mov_img = self.project(planes)
            with span("features.register"):
                tmat = self.freg.register(reuse_ref_img=True)
            inv = inverse_of(tmat)
            warp = not np.array_equal(np.asarray(tmat, np.float64), np.eye(2, 3))
            with span("pipeline.apply"):
                self._apply(planes, affine_out, lambda img: runner._apply_affine_plane(img, inv, h, w, WORK_DTYPE, warp))
            last["tmat"] = np.asarray(tmat, np.float64)
            planes = affine_out
        with span("projection"):
            mov = self.project(planes)
        self.ofreg.ref_img = self.ref_img
        self.ofreg.mov_img = mov
        with span("optflow.register"):
            flow = self.ofreg.register_device()
        self.warper.image = mov
        self.warper.flow = flow
        with span("optflow.warp_reference"):
            warped = self.warper.warp_device()
        last.update(ref_in=self.ref_img, mov=mov, flow=flow, warped=warped, prev=prev)
        self.ref_img = warped
        grid = TileGrid.for_image(tuple(flow.shape[:2]), self.ofreg.tile_size, self.ofreg.overlap)
        with span("pipeline.apply"):
            self._apply(planes, flow_out, lambda img: runner._apply_flow_plane(img, flow, grid, WORK_DTYPE))
        self.last = last

    def release(self) -> None:
        """Drop the registrators' state (pyramids, cached features)."""
        self.freg = self.ofreg = self.warper = None
        self.ref_img = None
