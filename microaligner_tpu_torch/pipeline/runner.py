"""Pipeline orchestration, OptFlowReg half: config -> dataset struct ->
register -> warp -> save.

PyTorch counterpart of ``microaligner_tpu/pipeline/runner.py``:

* OptFlowReg chains sequentially (cycle n registers to the *warped* cycle
  n-1); the flow stays on the device from ``register_device`` through the
  reference warp and the apply of every channel and z-plane;
* output modes: one combined TCZYX stack or one file per cycle, with rebuilt
  OME-XML (``io/ome.create_new_meta``);
* the apply streams: TIFF decode and the host->device copy, the warp, and the
  device->host copy and BigTIFF write of consecutive planes overlap
  (``pipeline/apply.py::stream_apply``).

The FeatureReg (affine) engine is not ported yet (ROADMAP queue 1, items
10-11): a config with ``FeatureReg``, and the automatic FeatureReg first pass
that the JAX package runs for per-cycle inputs whose dimensions do not
match, raise ``NotImplementedError``.

Every entry point takes the ``device`` to run on explicitly.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from microaligner_tpu_torch.io.ome import create_new_meta
from microaligner_tpu_torch.io.tiff import MemmapWriter, TiffFile, read_tiff_page
from microaligner_tpu_torch.ops.filters import round_to_dtype
from microaligner_tpu_torch.optflow.registrator import OptFlowRegistrator
from microaligner_tpu_torch.optflow.warper import (
    TORCH_DTYPES,
    Warper,
    round_to_numpy_dtype,
    warp_planes_tiled,
    warp_tiled,
)
from microaligner_tpu_torch.pipeline.apply import stream_apply
from microaligner_tpu_torch.pipeline.config import PipelineConfig
from microaligner_tpu_torch.pipeline.dataset import DatasetStruct, DatasetStructCreator
from microaligner_tpu_torch.tiles import TileGrid
from microaligner_tpu_torch.utils.logging import log, stage_timer
from microaligner_tpu_torch.utils.pages import read_and_max_project_pages
from microaligner_tpu_torch.utils.workers import set_number_of_workers

__all__ = [
    "run_pipeline",
    "run_opt_flow_reg",
    "register_and_save_ofreg_imgs",
    "get_target_shape",
    "check_input_img_dims_match",
    "get_img_path_list",
    "_apply_flow_plane",
    "_apply_flow_planes",
]

_FEATURE_REG_NOT_PORTED = (
    "FeatureReg (the affine engine) is not ported to microaligner_tpu_torch yet "
    "(ROADMAP queue 1, items 10-11); {what}. Run it with the JAX package "
    "(python -m microaligner_tpu) or use an OptFlowReg-only config on inputs of equal size."
)


def _first_value(d: dict):
    return d[list(d.keys())[0]]


def _yx_shapes(img_paths: List[Path]) -> List[Tuple[int, int]]:
    shapes = []
    for p in img_paths:
        with TiffFile(p) as tf:
            s = tf.series[0]
            shapes.append((s.shape[s.axes.index("Y")], s.shape[s.axes.index("X")]))
    return shapes


def get_target_shape(img_paths: List[Path]) -> Tuple[int, int]:
    """Max (H, W) across inputs (reference __main__.py:218-230)."""
    shapes = _yx_shapes(img_paths)
    return max(s[0] for s in shapes), max(s[1] for s in shapes)


def check_input_img_dims_match(img_paths: List[Path]) -> bool:
    shapes = _yx_shapes(img_paths)
    return all(s == shapes[0] for s in shapes)


def _apply_flow_plane(img: torch.Tensor, flow: torch.Tensor, grid: TileGrid,
                      dtype: torch.dtype, band_rows: Optional[int] = None) -> torch.Tensor:
    """Banded warp of one (H, W) plane by the (H, W, 2) flow on the flow's
    device, rounded half to even and clipped back to ``dtype`` (``cv.remap``
    on integer images rounds)."""
    return round_to_dtype(warp_tiled(img, flow, grid, band_rows), dtype)


def _apply_flow_planes(imgs: torch.Tensor, flow: torch.Tensor, grid: TileGrid,
                       dtype: torch.dtype, band_rows: Optional[int] = None) -> torch.Tensor:
    """Banded warp of N (N, H, W) planes sharing one flow (the cycle's
    channel/z stack — reference __main__.py:288-302), rounded to ``dtype``:
    one K5 launch a band warps every plane (``warp_planes_tiled``).  The
    result equals :func:`_apply_flow_plane` on each plane bit for bit."""
    return warp_planes_tiled(imgs, flow, grid, dtype, band_rows)


def _dims_of_struct(struct: DatasetStruct):
    nz = [len(struct.tiff_pages[c][ch]) for c in struct.tiff_pages for ch in struct.tiff_pages[c]]
    nch = [len(struct.tiff_pages[c]) for c in struct.tiff_pages]
    return max(nz), sum(nch), nch


def register_and_save_ofreg_imgs(
    struct: DatasetStruct,
    out_dir: Path,
    filenames: Dict[str, str],
    tile_size: int,
    overlap: int,
    num_pyr_lvl: int,
    num_iter: int,
    ome_meta_per_cyc: Dict[int, str],
    save_to_stack: bool,
    use_full_res_img: bool,
    use_dog: bool,
    device,
):
    """Sequential chain 1<-2, 2<-3, ... (reference __main__.py:320-437) on
    ``device``."""
    ofreg = OptFlowRegistrator(device=device)
    ofreg.tile_size = tile_size
    ofreg.overlap = overlap
    ofreg.num_pyr_lvl = num_pyr_lvl
    ofreg.num_iterations = num_iter
    ofreg.use_full_res_img = use_full_res_img
    ofreg.use_dog = use_dog
    warper = Warper(device=device)
    warper.tile_size = tile_size
    warper.overlap = overlap

    cycles = list(struct.tiff_pages.keys())
    first_cycle = cycles[0]
    img_path = _first_value(_first_value(struct.img_paths[first_cycle]))
    with TiffFile(img_path) as tf:
        s = tf.series[0]
        img_shape = s.shape
        img_dtype = np.dtype(s.dtype)
    max_z, total_ch, nch_per_cyc = _dims_of_struct(struct)
    # planes of a dtype the port does not warp in (uint32, float64, ...) are
    # warped in float32 and rounded and clipped back on the host, as
    # Warper.warp does
    work_dtype = TORCH_DTYPES.get(img_dtype)

    mm = None
    if save_to_stack:
        mm = MemmapWriter(out_dir / filenames["stack"],
                          (1, total_ch, max_z, img_shape[-2], img_shape[-1]),
                          img_dtype, description=ome_meta_per_cyc[first_cycle])

    ref_img = None
    for cyc_id, cyc in enumerate(cycles):
        log(f"Processing Cycle {cyc} [{cyc_id + 1}/{len(cycles)}]")
        if not save_to_stack:
            nch = len(struct.tiff_pages[cyc])
            mm = MemmapWriter(out_dir / filenames["per_cycle"].format(cyc=cyc),
                              (1, nch, max_z, img_shape[-2], img_shape[-1]),
                              img_dtype, description=ome_meta_per_cyc[cyc])
        ref_ch = struct.ref_channel_ids[cyc]
        paths = struct.img_paths[cyc][ref_ch]
        pages = struct.tiff_pages[cyc][ref_ch]

        def out_channel(ch_id):
            # cumulative: correct for heterogeneous per-cycle channel counts
            # (the reference assumes cycle 0's count, __main__.py:199,412)
            return sum(nch_per_cyc[:cyc_id]) + ch_id if save_to_stack else ch_id

        if cyc == first_cycle:
            log("Skipping as it is a reference image")
            with stage_timer("z-max projection", device):
                ref_img = read_and_max_project_pages(paths, pages, device)
            with stage_timer("copy reference cycle"):
                for ch_id, ch in enumerate(struct.tiff_pages[cyc]):
                    for z_id, z in enumerate(struct.img_paths[cyc][ch]):
                        mm[0, out_channel(ch_id), z_id] = read_tiff_page(
                            struct.img_paths[cyc][ch][z], struct.tiff_pages[cyc][ch][z]
                        )
                        mm.flush()
        else:
            with stage_timer("z-max projection", device):
                mov_img = read_and_max_project_pages(paths, pages, device)
            ofreg.ref_img = ref_img
            ofreg.mov_img = mov_img
            # the flow never visits the host: register_device() hands the
            # device tensor straight to the warp and apply stages (a host
            # round trip is 2 x 3.2 GB of f32 at 20k x 20k)
            flow_dev = ofreg.register_device()
            warper.image = mov_img
            warper.flow = flow_dev
            # next cycle registers against this; it stays on the device
            with stage_timer("warp reference", device):
                ref_img = warper.warp_device()
            log(f"Saving Cycle {cyc} [{cyc_id + 1}/{len(cycles)}]")
            grid = TileGrid.for_image(tuple(flow_dev.shape[:2]), tile_size, overlap)

            def planes():
                for ch_id, ch in enumerate(struct.tiff_pages[cyc]):
                    for z_id, z in enumerate(struct.img_paths[cyc][ch]):
                        plane = read_tiff_page(
                            struct.img_paths[cyc][ch][z], struct.tiff_pages[cyc][ch][z]
                        )
                        if work_dtype is None:
                            plane = plane.astype(np.float32)
                        yield (out_channel(ch_id), z_id), plane

            def device_fn(img):
                return _apply_flow_plane(img, flow_dev, grid, work_dtype or torch.float32)

            def write_fn(key, plane):
                out_ch, z_id = key
                mm[0, out_ch, z_id] = plane if work_dtype else round_to_numpy_dtype(plane, img_dtype)
                mm.flush()

            with stage_timer("apply", device):
                stream_apply(planes(), device_fn, write_fn, device=device)
        if not save_to_stack:
            mm.close()
    if save_to_stack:
        mm.close()


def run_opt_flow_reg(config: PipelineConfig, img_paths, target_shape, device):
    inp = config.Input
    out_dir = Path(config.Output.OutputDir)
    out_prefix = config.Output.OutputPrefix
    output_is_stack = config.Output.SaveOutputToCycleStack
    input_is_stack = inp.PipelineInputType == "CycleStack"
    input_is_stack_builder = inp.PipelineInputType == "CycleBuilder"
    p = config.RegistrationParameters.OptFlowReg

    if config.RegistrationParameters.FeatureReg is not None:
        raise NotImplementedError(_FEATURE_REG_NOT_PORTED.format(what="the config has FeatureReg"))
    if not input_is_stack:
        paths = get_img_path_list(config)
        if not check_input_img_dims_match(paths):
            # the JAX package logs this and runs FeatureReg first
            raise NotImplementedError(_FEATURE_REG_NOT_PORTED.format(
                what="the input images' dimensions do not match, so they would need "
                     "a FeatureReg pass first"))

    set_number_of_workers(p.NumberOfWorkers)
    struct_creator = DatasetStructCreator()
    struct_creator.img_paths = img_paths
    struct_creator.input_is_stack = input_is_stack
    struct_creator.input_is_stack_builder = input_is_stack_builder
    struct_creator.output_is_stack = output_is_stack
    struct_creator.ref_channel_name = inp.ReferenceChannel
    struct = struct_creator.create_dataset_struct()

    new_ome = create_new_meta(struct.ome_xmls, target_shape, input_is_stack, output_is_stack)
    filenames = {
        "stack": out_prefix + "optflow_reg_result_stack.tif",
        "per_cycle": out_prefix + "optflow_reg_result_cyc{cyc:03d}.tif",
    }
    log("Performing non-linear optical flow based image registration")
    register_and_save_ofreg_imgs(
        struct, out_dir, filenames, p.TileSize, p.Overlap, p.NumberPyramidLevels,
        p.NumberIterationsPerLevel, new_ome, output_is_stack, p.UseFullResImage, p.UseDOG,
        device,
    )
    log("Finished\n")


def get_img_path_list(config: PipelineConfig) -> List[Path]:
    if config.Input.PipelineInputType == "CycleBuilder":
        return [
            config.Input.InputImagePaths[cyc][ch]
            for cyc in config.Input.InputImagePaths
            for ch in config.Input.InputImagePaths[cyc]
        ]
    return [Path(p) for p in config.Input.InputImagePaths.values()]


def run_pipeline(config: PipelineConfig, device):
    """Run the configured registration on ``device`` (OptFlowReg only; a
    config with FeatureReg raises ``NotImplementedError``)."""
    if config.RegistrationParameters.FeatureReg is not None:
        raise NotImplementedError(_FEATURE_REG_NOT_PORTED.format(what="the config has FeatureReg"))
    out_dir = Path(config.Output.OutputDir)
    out_dir.mkdir(parents=True, exist_ok=True)
    target_shape = get_target_shape(get_img_path_list(config))
    if config.RegistrationParameters.OptFlowReg is not None:
        run_opt_flow_reg(config, config.Input.InputImagePaths, target_shape, device)
