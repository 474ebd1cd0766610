"""Pipeline orchestration: config -> dataset struct -> register -> warp ->
save.

PyTorch counterpart of ``microaligner_tpu/pipeline/runner.py``:

* FeatureReg registers every cycle to one fixed reference cycle, then pads
  and affine-warps every channel and z-plane (``_apply_affine_plane``: pinv
  of the matrix, K1 a band of rows, truncating cast) and writes BigTIFF
  output plus ``feature_reg_parameters.csv``;
* OptFlowReg chains sequentially (cycle n registers to the *warped* cycle
  n-1); the flow stays on the device from ``register_device`` through the
  reference warp and the apply of every channel and z-plane.  After
  FeatureReg it reads FeatureReg's output files;
* per-cycle inputs of unequal size in an OptFlowReg-only config get a
  FeatureReg pass first, with the OptFlowReg parameters (reference
  __main__.py:560-574);
* output modes: one combined TCZYX stack or one file per cycle, with rebuilt
  OME-XML (``io/ome.create_new_meta``);
* every apply streams: TIFF decode and the host->device copy, the warp, and
  the device->host copy and BigTIFF write of consecutive planes overlap
  (``pipeline/apply.py::stream_apply``).

Every entry point takes the ``device`` to run on explicitly.
"""

from __future__ import annotations

import csv
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from microaligner_tpu_torch.features.registrator import FeatureRegistrator
from microaligner_tpu_torch.io.ome import create_new_meta
from microaligner_tpu_torch.io.tiff import MemmapWriter, TiffFile, read_tiff_page
from microaligner_tpu_torch.ops.affine_tiled import affine_warp_bands
from microaligner_tpu_torch.ops.pad import calculate_padding_size, pad_to_shape, zero_pad
from microaligner_tpu_torch.ops.warp import inverse_of
from microaligner_tpu_torch.optflow.flow_calc import dense_banded
from microaligner_tpu_torch.optflow.registrator import OptFlowRegistrator
from microaligner_tpu_torch.optflow.warper import (
    TORCH_DTYPES,
    Warper,
    round_to_numpy_dtype,
    warp_planes_tiled,
    warp_tiled_dtype,
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
    "run_feature_reg",
    "run_opt_flow_reg",
    "do_feature_reg",
    "transform_and_save_freg_imgs",
    "save_param",
    "register_and_save_ofreg_imgs",
    "get_target_shape",
    "check_input_img_dims_match",
    "get_img_path_list",
    "_apply_flow_plane",
    "_apply_flow_planes",
]

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
    """Warp of one (H, W) plane by the (H, W, 2) flow on the flow's device,
    rounded half to even and clipped back to ``dtype`` (``cv.remap`` on
    integer images rounds), on the route ``MICROALIGNER_TPU_FLOW_DENSE``
    names (``warp_tiled_dtype``): by default one launch of K5's band entry
    (``sample_band_multi``) a band, where the plane's dtype is ``dtype``;
    under ``0`` the per-tile warp, K1 a chunk of halo windows."""
    return warp_tiled_dtype(img, flow, grid, dtype, band_rows)


def _apply_flow_planes(imgs: torch.Tensor, flow: torch.Tensor, grid: TileGrid,
                       dtype: torch.dtype, band_rows: Optional[int] = None) -> torch.Tensor:
    """Warp of N (N, H, W) planes sharing one flow (the cycle's channel/z
    stack — reference __main__.py:288-302), rounded to ``dtype``.  By
    default one K5 launch a band warps every plane (``warp_planes_tiled``);
    under ``MICROALIGNER_TPU_FLOW_DENSE=0`` each plane goes through
    :func:`_apply_flow_plane` in turn, as the JAX package's default maps it
    over the planes.  Either way the result equals :func:`_apply_flow_plane`
    on each plane bit for bit."""
    if dense_banded():
        return warp_planes_tiled(imgs, flow, grid, dtype, band_rows)
    out = torch.empty(imgs.shape, dtype=dtype, device=imgs.device)
    for i in range(imgs.shape[0]):
        out[i] = _apply_flow_plane(imgs[i], flow, grid, dtype, band_rows)
    return out


def save_param(out_dir: Path, tmat_per_cycle, padding_per_cycle, image_shape):
    """``feature_reg_parameters.csv``: the 6 matrix coefficients, the padding
    and the size of every cycle (reference __main__.py:47-80)."""
    cols = ["name", "0", "1", "2", "3", "4", "5", "left", "right", "top", "bottom", "width", "height"]
    with open(out_dir / "feature_reg_parameters.csv", "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(cols)
        for cyc in tmat_per_cycle:
            flat = np.asarray(tmat_per_cycle[cyc], dtype=float).flatten().tolist()
            w.writerow([f"Cycle {cyc}"] + flat + list(padding_per_cycle[cyc])
                       + [image_shape[1], image_shape[0]])


def _pad_plane(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Zero pad to (out_h, out_w), the odd pixel right and bottom."""
    left, right = calculate_padding_size(out_w, img.shape[1])
    top, bottom = calculate_padding_size(out_h, img.shape[0])
    return zero_pad(img, top, bottom, left, right)


def _apply_affine_plane(img: torch.Tensor, inv: np.ndarray, out_h: int, out_w: int,
                        dtype: torch.dtype, warp: bool) -> torch.Tensor:
    """Pad one plane on its device and, unless ``warp`` is False (identity),
    warp it by the dst -> src matrix ``inv`` through K1, then cast with
    truncation, as the reference's ``astype`` after its skimage warp
    (``transform_img_with_tmat``; ``FeatureRegistrator.transform_img``
    rounds instead)."""
    padded = _pad_plane(img, out_h, out_w)
    if not warp:
        return padded
    return affine_warp_bands(padded, inv, out_h, out_w).to(dtype)


def _dims_of_struct(struct: DatasetStruct):
    nz = [len(struct.tiff_pages[c][ch]) for c in struct.tiff_pages for ch in struct.tiff_pages[c]]
    nch = [len(struct.tiff_pages[c]) for c in struct.tiff_pages]
    return max(nz), sum(nch), nch


def do_feature_reg(struct: DatasetStruct, ref_cycle_id: int, num_pyr_lvl: int, num_iter: int,
                   tile_size: int, target_shape, use_full_res_img: bool, use_dog: bool, device):
    """Register every cycle's z-max projection to the reference cycle's.
    Returns ({cycle: 2x3 matrix}, {cycle: padding (left, right, top,
    bottom)})."""
    freg = FeatureRegistrator(device=device)
    freg.num_pyr_lvl = num_pyr_lvl
    freg.num_iterations = num_iter
    freg.tile_size = tile_size
    freg.use_full_res_img = use_full_res_img
    freg.use_dog = use_dog
    tmat_per_cycle: Dict[int, np.ndarray] = {}
    padding: Dict[int, tuple] = {}

    ref_ch = struct.ref_channel_ids[ref_cycle_id]
    with stage_timer("feature z-max projection", device, name="runner.feature_projection"):
        ref_img = read_and_max_project_pages(struct.img_paths[ref_cycle_id][ref_ch],
                                             struct.tiff_pages[ref_cycle_id][ref_ch], device)
    ref_img, ref_pad = pad_to_shape(ref_img, target_shape)
    freg.ref_img = ref_img

    cycles = list(struct.tiff_pages.keys())
    for cyc_id, cyc in enumerate(cycles):
        log(f"Processing Cycle {cyc} [{cyc_id + 1}/{len(cycles)}]")
        if cyc == ref_cycle_id:
            log("Skipping as it is a reference cycle")
            tmat_per_cycle[cyc] = np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
            padding[cyc] = ref_pad
            continue
        ch = struct.ref_channel_ids[cyc]
        with stage_timer("feature z-max projection", device, name="runner.feature_projection"):
            mov_img = read_and_max_project_pages(struct.img_paths[cyc][ch],
                                                 struct.tiff_pages[cyc][ch], device)
        mov_img, padding[cyc] = pad_to_shape(mov_img, target_shape)
        freg.mov_img = mov_img
        with stage_timer("feature register", device, name="runner.feature_register"):
            tmat_per_cycle[cyc] = freg.register(reuse_ref_img=True)
    return tmat_per_cycle, padding


def transform_and_save_freg_imgs(struct: DatasetStruct, out_dir: Path, filenames: Dict[str, str],
                                 target_shape, tmat_per_cycle, ome_meta_per_cyc: Dict[int, str],
                                 save_to_stack: bool, device):
    """Pad and warp every channel and z-plane of every cycle by its matrix
    (streamed) and write them; a cycle with fewer z-planes than the largest
    gets zero planes."""
    log("Transforming images")
    cycles = sorted(struct.tiff_pages.keys())
    img_path = _first_value(_first_value(struct.img_paths[cycles[0]]))
    with TiffFile(img_path) as tf:
        img_dtype = np.dtype(tf.series[0].dtype)
    work_dtype = TORCH_DTYPES.get(img_dtype)
    max_z, total_ch, nch_per_cyc = _dims_of_struct(struct)
    out_h, out_w = int(target_shape[0]), int(target_shape[1])

    mm = None
    if save_to_stack:
        mm = MemmapWriter(out_dir / filenames["stack"], (1, total_ch, max_z, out_h, out_w),
                          img_dtype, description=ome_meta_per_cyc[cycles[0]])
    for cyc_id, cyc in enumerate(struct.tiff_pages):
        log(f"Transforming and saving Cycle {cyc} [{cyc_id + 1}/{len(cycles)}]")
        if not save_to_stack:
            mm = MemmapWriter(out_dir / filenames["per_cycle"].format(cyc=cyc),
                              (1, len(struct.tiff_pages[cyc]), max_z, out_h, out_w),
                              img_dtype, description=ome_meta_per_cyc[cyc])
        tmat = np.asarray(tmat_per_cycle[cyc], dtype=np.float64)
        warp = not np.array_equal(tmat, np.eye(2, 3))
        inv = inverse_of(tmat)

        def planes():
            for ch_id, ch in enumerate(struct.tiff_pages[cyc]):
                # cumulative: right for per-cycle channel counts that differ
                # (the reference assumes cycle 0's count, __main__.py:199,412)
                out_ch = sum(nch_per_cyc[:cyc_id]) + ch_id if save_to_stack else ch_id
                pages, paths = struct.tiff_pages[cyc][ch], struct.img_paths[cyc][ch]
                for z_id, z in enumerate(paths):
                    plane = read_tiff_page(paths[z], pages[z])
                    yield (out_ch, z_id), (plane if work_dtype else plane.astype(np.float32))
                for extra_z in range(len(pages), max_z):
                    mm[0, out_ch, extra_z] = 0

        def device_fn(img):
            return _apply_affine_plane(img, inv, out_h, out_w, work_dtype or torch.float32, warp)

        def write_fn(key, plane):
            out_ch, z_id = key
            mm[0, out_ch, z_id] = plane if work_dtype else plane.astype(img_dtype)
            mm.flush()

        with stage_timer("feature apply", device, name="runner.feature_apply"):
            stream_apply(planes(), device_fn, write_fn, device=device)
        if not save_to_stack:
            mm.close()
    if save_to_stack:
        mm.close()


def run_feature_reg(config: PipelineConfig, target_shape, device) -> Dict:
    """The FeatureReg stage; returns the OptFlowReg stage's input paths."""
    log("Performing linear feature based image registration")
    inp = config.Input
    out_dir = Path(config.Output.OutputDir)
    out_prefix = config.Output.OutputPrefix
    output_is_stack = config.Output.SaveOutputToCycleStack
    input_is_stack = inp.PipelineInputType == "CycleStack"
    p = config.RegistrationParameters.FeatureReg

    set_number_of_workers(p.NumberOfWorkers)
    struct_creator = DatasetStructCreator()
    struct_creator.img_paths = inp.InputImagePaths
    struct_creator.input_is_stack = input_is_stack
    struct_creator.input_is_stack_builder = inp.PipelineInputType == "CycleBuilder"
    struct_creator.output_is_stack = output_is_stack
    struct_creator.ref_channel_name = inp.ReferenceChannel
    struct = struct_creator.create_dataset_struct()

    new_ome = create_new_meta(struct.ome_xmls, target_shape, input_is_stack, output_is_stack)
    tmat_per_cycle, padding = do_feature_reg(
        struct, inp.ReferenceCycle, p.NumberPyramidLevels, p.NumberIterationsPerLevel,
        p.TileSize, target_shape, p.UseFullResImage, p.UseDOG, device,
    )
    filenames = {
        "stack": out_prefix + "feature_reg_result_stack.tif",
        "per_cycle": out_prefix + "feature_reg_result_cyc{cyc:03d}.tif",
    }
    transform_and_save_freg_imgs(struct, out_dir, filenames, target_shape, tmat_per_cycle,
                                 new_ome, output_is_stack, device)
    save_param(out_dir, tmat_per_cycle, padding, target_shape)
    if output_is_stack:
        return {"CycleStack": out_dir / filenames["stack"]}
    return {cyc: out_dir / filenames["per_cycle"].format(cyc=cyc) for cyc in struct.img_paths}


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
            with stage_timer("z-max projection", device, name="runner.projection"):
                ref_img = read_and_max_project_pages(paths, pages, device)
            with stage_timer("copy reference cycle", name="runner.copy_reference"):
                for ch_id, ch in enumerate(struct.tiff_pages[cyc]):
                    for z_id, z in enumerate(struct.img_paths[cyc][ch]):
                        mm[0, out_channel(ch_id), z_id] = read_tiff_page(
                            struct.img_paths[cyc][ch][z], struct.tiff_pages[cyc][ch][z]
                        )
                        mm.flush()
        else:
            with stage_timer("z-max projection", device, name="runner.projection"):
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
            with stage_timer("warp reference", device, name="runner.warp_reference"):
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

            with stage_timer("apply", device, name="runner.apply"):
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
        # the input is FeatureReg's output
        input_is_stack = output_is_stack
        input_is_stack_builder = False
    elif not input_is_stack and not check_input_img_dims_match(get_img_path_list(config)):
        log(
            "Image dimensions do not match. "
            "This probably means that they are not aligned. "
            "Will try to perform FeatureReg first"
        )
        config.RegistrationParameters.FeatureReg = p
        img_paths = run_feature_reg(config, target_shape, device)
        input_is_stack = output_is_stack
        input_is_stack_builder = False

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
    """Run the configured stages on ``device``: FeatureReg, then OptFlowReg
    on its output."""
    out_dir = Path(config.Output.OutputDir)
    out_dir.mkdir(parents=True, exist_ok=True)
    target_shape = get_target_shape(get_img_path_list(config))
    img_paths = config.Input.InputImagePaths
    if config.RegistrationParameters.FeatureReg is not None:
        img_paths = run_feature_reg(config, target_shape, device)
    if config.RegistrationParameters.OptFlowReg is not None:
        run_opt_flow_reg(config, img_paths, target_shape, device)
