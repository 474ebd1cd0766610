"""The slice end to end: an OptFlowReg-only config through the JAX package's
``run_pipeline`` and through the port's CLI (``main([cfg], device="cpu")``),
on the same synthetic files.

The data: 260 x 280, 2 cycles x 2 channels x 2 z-planes of u16, cycle 2
pulled by a small elastic warp (2 px sine, 1.5 px cosine).  Two layouts:
one CycleStack in and a stack out, and one file per cycle in and one file
per cycle out.

Bars and their reasons:
* the same output file names and the same OME-XML, byte for byte (the
  port's OME and TIFF code is a copy of the JAX package's);
* reference-cycle planes equal to the input, bit for bit;
* registered planes within 1 u16 level of the JAX CLI's at >= 99.9% of
  pixels: the flows differ by the last-bit differences of the two packages
  (ROADMAP queue 3; about 1e-3 px), and a u16 rounding can cross a .5 tie;
* the registered reference channel's interior MSE to cycle 1 below 5% of
  the unregistered MSE (the bar of ``tests/test_pipeline.py``).

A u32 stack, which the JAX CLI cannot apply (its clip to ``iinfo(uint32)``
overflows in 32-bit mode, ROADMAP queue 3), goes through the port's float32
warp with the round and clip on the host: it gives the u16 run's planes.
One file per cycle and channel (CycleBuilder) gives the CycleStack run's
planes.  FeatureReg configs, and per-cycle inputs whose sizes differ (which
the JAX package would send through FeatureReg first), raise
``NotImplementedError``.
"""

import os
import subprocess
import sys
from pathlib import Path

import cv2 as cv
import numpy as np
import pytest
import torch
import yaml

from microaligner_tpu.io import MemmapWriter
from microaligner_tpu.pipeline.config import PipelineConfigReader as JReader
from microaligner_tpu.pipeline.runner import run_pipeline as j_run_pipeline
from microaligner_tpu_torch.__main__ import main
from microaligner_tpu_torch.io import TiffFile
from microaligner_tpu_torch.pipeline.runner import get_target_shape

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
H, W, NZ = 260, 280, 2
INNER = (slice(30, -30), slice(30, -30))


def _ome(channels, dtype="uint16", h=H, w=W):
    chs = "".join(f'<Channel ID="Channel:0:{i}" Name="{n}" SamplesPerPixel="1"/>'
                  for i, n in enumerate(channels))
    return (
        '<?xml version="1.0" encoding="UTF-8"?>'
        '<OME xmlns="http://www.openmicroscopy.org/Schemas/OME/2016-06"><Image ID="Image:0" Name="t">'
        f'<Pixels ID="Pixels:0" DimensionOrder="XYZCT" Type="{dtype}" SizeT="1" '
        f'SizeC="{len(channels)}" SizeZ="{NZ}" SizeY="{h}" SizeX="{w}" '
        'PhysicalSizeX="0.5" PhysicalSizeXUnit="um" PhysicalSizeY="0.5" PhysicalSizeYUnit="um">'
        + chs + "</Pixels></Image></OME>"
    )


def _write(path, planes, channels, dtype=np.uint16):
    """planes: list over channels of lists over z of 2-D arrays."""
    h, w = planes[0][0].shape
    mm = MemmapWriter(path, (1, len(planes), NZ, h, w), dtype,
                      description=_ome(channels, np.dtype(dtype).name, h, w))
    for c, zs in enumerate(planes):
        for z, img in enumerate(zs):
            mm[0, c, z] = img.astype(dtype)
    mm.close()


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    rng = np.random.default_rng(2026)
    d = tmp_path_factory.mktemp("ds")
    textures = []
    for sigma in (2.0, 3.0):
        t = cv.GaussianBlur(rng.random((H, W), dtype=np.float32), (0, 0), sigma)
        textures.append(cv.normalize(t, None, 0, 60000, cv.NORM_MINMAX, cv.CV_16U))
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    mx, my = xs + 2.0 * np.sin(ys / 30), ys + 1.5 * np.cos(xs / 35)
    cyc1 = [[t, (t * (0.8 - 0.1 * c)).astype(np.uint16)] for c, t in enumerate(textures)]
    cyc2 = [[cv.remap(p, mx, my, cv.INTER_LINEAR) for p in zs] for zs in cyc1]
    _write(d / "stack.ome.tif", cyc1 + cyc2, ("c01 DAPI", "c01 Cy5", "c02 DAPI", "c02 Cy5"))
    _write(d / "stack_u32.ome.tif", cyc1 + cyc2, ("c01 DAPI", "c01 Cy5", "c02 DAPI", "c02 Cy5"),
           np.uint32)
    _write(d / "cyc1.ome.tif", cyc1, ("DAPI", "Cy5"))
    _write(d / "cyc2.ome.tif", cyc2, ("DAPI", "Cy5"))
    _write(d / "cyc2_small.ome.tif", [[p[:-8, :-6] for p in zs] for zs in cyc2], ("DAPI", "Cy5"))
    for c, cyc in ((1, cyc1), (2, cyc2)):
        for ch, zs in zip(("DAPI", "Cy5"), cyc):
            _write(d / f"cyc{c}_{ch}.ome.tif", [zs], (ch,))
    return d, cyc1, cyc2


def _config(inputs, out_dir, stack_out, feature=False):
    params = dict(NumberPyramidLevels=1, NumberIterationsPerLevel=2, TileSize=300, Overlap=50,
                  NumberOfWorkers=0, UseFullResImage=True, UseDOG=False)
    reg = {"OptFlowReg": params}
    if feature:
        reg["FeatureReg"] = dict(params, UseDOG=True)
    return {
        "Input": {"InputImagePaths": inputs, "ReferenceCycle": 1, "ReferenceChannel": "DAPI"},
        "Output": {"OutputDir": str(out_dir), "OutputPrefix": "t_", "SaveOutputToCycleStack": stack_out},
        "RegistrationParameters": reg,
    }


def _write_config(path, cfg) -> Path:
    path.write_text(yaml.dump(cfg, sort_keys=False))
    return path


def _run_port(tmp_path, cfg, name="port"):
    cfg = dict(cfg, Output=dict(cfg["Output"], OutputDir=str(tmp_path / name)))
    main([str(_write_config(tmp_path / f"{name}.yaml", cfg))], device="cpu")
    return tmp_path / name


def _pages(path):
    with TiffFile(path) as tf:
        return tf.ome_metadata, tf.series[0].shape, [tf.read_page(i) for i in range(len(tf.pages))]


LAYOUTS = {
    "stack-in-stack-out": (lambda d: {"CycleStack": str(d / "stack.ome.tif")}, True),
    "per-cycle-in-per-cycle-out": (lambda d: {"Cycle 1": str(d / "cyc1.ome.tif"),
                                              "Cycle 2": str(d / "cyc2.ome.tif")}, False),
}


@pytest.fixture(scope="module", params=list(LAYOUTS))
def both_runs(request, data, tmp_path_factory):
    d, cyc1, cyc2 = data
    inputs, stack_out = LAYOUTS[request.param]
    tmp = tmp_path_factory.mktemp(request.param)
    cfg = _config(inputs(d), tmp / "jax", stack_out)
    j_run_pipeline(JReader().read_config(_write_config(tmp / "jax.yaml", cfg)))
    port_dir = _run_port(tmp, cfg)
    return tmp / "jax", port_dir, stack_out, cyc1, cyc2


def _planes_by_cycle(out_dir, stack_out):
    """{cycle: (ome, shape, pages)} with pages ordered channel-major, z minor."""
    files = sorted(out_dir.iterdir())
    if stack_out:
        ome, shape, pages = _pages(files[0])
        half = len(pages) // 2
        return {1: (ome, shape, pages[:half]), 2: (ome, shape, pages[half:])}
    return {i + 1: _pages(f) for i, f in enumerate(files)}


def test_same_files_and_ome(both_runs):
    jax_dir, port_dir, stack_out, _, _ = both_runs
    names = sorted(p.name for p in port_dir.iterdir())
    assert names == sorted(p.name for p in jax_dir.iterdir())
    assert names == (["t_optflow_reg_result_stack.tif"] if stack_out
                     else ["t_optflow_reg_result_cyc001.tif", "t_optflow_reg_result_cyc002.tif"])
    got, want = _planes_by_cycle(port_dir, stack_out), _planes_by_cycle(jax_dir, stack_out)
    for cyc in (1, 2):
        assert got[cyc][0] == want[cyc][0]  # OME-XML, byte for byte
        assert got[cyc][1] == want[cyc][1] == ((4, NZ, H, W) if stack_out else (2, NZ, H, W))


def test_reference_cycle_bit_for_bit(both_runs):
    _, port_dir, stack_out, cyc1, _ = both_runs
    pages = _planes_by_cycle(port_dir, stack_out)[1][2]
    for i, page in enumerate(pages):
        assert page.dtype == np.uint16
        np.testing.assert_array_equal(page, cyc1[i // NZ][i % NZ])


def test_registered_planes_match_jax_and_align(both_runs):
    jax_dir, port_dir, stack_out, cyc1, cyc2 = both_runs
    got = _planes_by_cycle(port_dir, stack_out)[2][2]
    want = _planes_by_cycle(jax_dir, stack_out)[2][2]
    for g, w in zip(got, want):
        diff = np.abs(g.astype(np.int32) - w.astype(np.int32))
        assert (diff <= 1).mean() >= 0.999, f"max {diff.max()}, {(diff > 1).mean():.2e} beyond 1"
    ref, mov = cyc1[0][0][INNER].astype(float), cyc2[0][0][INNER].astype(float)
    before = np.mean((mov - ref) ** 2)
    after = np.mean((got[0][INNER].astype(float) - ref) ** 2)
    assert after < 0.05 * before, f"before={before} after={after}"


def test_u32_stack_gives_the_u16_planes(data, tmp_path):
    d, _, _ = data
    u16 = _run_port(tmp_path, _config({"CycleStack": str(d / "stack.ome.tif")}, None, True), "u16")
    u32 = _run_port(tmp_path, _config({"CycleStack": str(d / "stack_u32.ome.tif")}, None, True), "u32")
    _, shape16, pages16 = _pages(u16 / "t_optflow_reg_result_stack.tif")
    ome32, shape32, pages32 = _pages(u32 / "t_optflow_reg_result_stack.tif")
    assert shape32 == shape16 and 'Type="uint32"' in ome32
    for a, b in zip(pages32, pages16):
        assert a.dtype == np.uint32
        np.testing.assert_array_equal(a, b.astype(np.uint32))


def test_cycle_builder_gives_the_stack_planes(data, tmp_path):
    """One file per cycle and channel (CycleBuilder), OptFlowReg only: the
    same planes as the CycleStack run.  The JAX CLI cannot run this config
    (its dims check builds a Path from each cycle's channel dict, ROADMAP
    queue 3), so the port's CycleStack run is the reference."""
    d, _, _ = data
    builder = {f"Cycle {c}": {ch: str(d / f"cyc{c}_{ch}.ome.tif") for ch in ("DAPI", "Cy5")}
               for c in (1, 2)}
    got = _run_port(tmp_path, _config(builder, None, True), "builder")
    want = _run_port(tmp_path, _config({"CycleStack": str(d / "stack.ome.tif")}, None, True), "stack")
    _, shape, pages = _pages(got / "t_optflow_reg_result_stack.tif")
    _, want_shape, want_pages = _pages(want / "t_optflow_reg_result_stack.tif")
    assert shape == want_shape == (4, NZ, H, W)
    for a, b in zip(pages, want_pages):
        np.testing.assert_array_equal(a, b)


def test_feature_reg_config_raises(data, tmp_path):
    d, _, _ = data
    cfg = _config({"CycleStack": str(d / "stack.ome.tif")}, tmp_path / "o", True, feature=True)
    with pytest.raises(NotImplementedError, match="FeatureReg"):
        main([str(_write_config(tmp_path / "f.yaml", cfg))], device="cpu")


def test_mismatched_dims_raise(data, tmp_path):
    d, _, _ = data
    paths = [d / "cyc1.ome.tif", d / "cyc2_small.ome.tif"]
    assert get_target_shape(paths) == (H, W)
    cfg = _config({"Cycle 1": str(paths[0]), "Cycle 2": str(paths[1])}, tmp_path / "o", True)
    with pytest.raises(NotImplementedError, match="dimensions do not match"):
        main([str(_write_config(tmp_path / "m.yaml", cfg))], device="cpu")


def test_cli_refuses_without_a_card(data, tmp_path):
    """``python -m microaligner_tpu_torch cfg`` runs on CUDA only: with no
    visible card it exits non-zero with a clear error and writes nothing."""
    d, _, _ = data
    out = tmp_path / "o"
    cfg = _config({"CycleStack": str(d / "stack.ome.tif")}, out, True)
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-m", "microaligner_tpu_torch",
                           str(_write_config(tmp_path / "c.yaml", cfg))],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is False" in proc.stderr
    assert not out.exists()
