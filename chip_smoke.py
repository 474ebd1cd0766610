#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``microaligner_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --cards   # on a machine with two or more cards: phase 11 across them

Run it from the repository root; with no arguments it needs one card.  Phases, each printing its own lines:

1. build: compile ``microaligner_tpu_torch/csrc/*.cu`` with nvcc for sm_90a
   (one nvcc process a source, all at once); K1's registers, the two K3
   kernels' registers, shared memory a block and blocks an SM, and the
   registers and shared memory of K5's six instantiations (one a dtype),
   are printed, and a spill in any of them (or more than 64 registers for
   K1) fails the run;
2. kernels: K1-K4 against their plain PyTorch versions on the card, at the
   main path's band shapes (4296 x 4296, 1256 x 20680) and edge cases, with
   CUDA-event times of kernel and plain version; K1 bit for bit, under the
   K3 flow and a random +-20 px flow, timed against ``F.grid_sample``
   under both, and at the shape the main path gives it, a chunk of the
   tiled flow composition (32 windows of 1200^2), timed there against
   ``F.grid_sample`` and its bound (the numbers of K1's entry in the
   ``kernels`` line); K3 also at windows 11 and
   257, at N > 1 and at H or W below the half-window, its row pass alone,
   and, with its plain version, against the plain version run in float64
   (the kernel must be no further from it than the plain version is); K5
   (N planes, one flow) against its plain version and against N K1
   launches, bit for bit, at 8 planes of a 4096^2 band slab and 2 of a
   20480^2 one, each timed under a random +-20 px flow and under the z-stack
   apply's smooth flow, and at the edge shapes under both flows, with the
   share of its tiles that took the staged branch (both branches must run);
   K5's band entry at one plane, the entry of the one-plane band warps (the
   Warper, the per-plane apply, the banded Farneback's post-warp), bit for
   bit against its plain version for u8, u16, i16, i32 and f32 4096^2
   planes, a 4096 x 4100 u16 plane and u8 and u16 20480^2 planes in the
   main path's bands, for a slab-coordinate flow and for an int32 plane at
   its maximum, timed on the u16 4096^2 and 20480^2 planes against its
   plain version and its bytes bound;
   K6 (one image's expansion) bit for bit against its plain version and
   K2's expansions at those slabs and at H or W of 1-3, timed against
   ``F.conv2d`` with the five folded filters, K2, and 2 x K6 plus the
   zero-flow combine.  Each kernel's bound (bytes over 3.35 TB/s or
   float32 operations over 67 TFLOP/s, whichever is larger) and, where one
   PyTorch call computes the same function (``F.grid_sample`` for K1 and
   K5, ``F.conv2d`` for K6), that call's time;
3. parity: a 1024^2 pair through ``OptFlowRegistrator.register_device`` on
   the card against the same pair through the plain versions on the CPU;
   then the unpaired Farneback route (``MICROALIGNER_TPU_PALLAS_POLY=1``)
   on that pair and on one 4096^2 register: the flow bit for bit equal to
   the default route's, with K6 launched and K2 not;
4. main path: the CLI's cycle loop (z-max projection, ``register_device``,
   ``warp_device``, per-plane apply) over a synthetic 3-cycle x 2-channel x
   3-z u16 4096^2 stack, then a 2-cycle 20480^2 u8 register and a one-plane
   apply, with stage times, peak device memory and the kernels' launch counts;
   the Warper, the per-plane apply and the banded Farneback's post-warp
   each make one K5 launch a band and none of K1, and the first two
   allocate nothing but their output; and one 4096^2 register under
   torch.profiler (device time by kernel and the device's busy share; the
   table goes to ``chiprun_out/``);
5. z-stack apply: 8 4096^2 planes warped by one flow through
   ``_apply_flow_planes`` (one K5 launch a band, ``sample_band_multi``,
   the stored dtype in and out) as u16, u8, i16 and f32 stacks, each bit
   for bit equal to the band entry's plain version and to
   ``_apply_flow_plane`` on each plane; the band entry is timed on the
   u16 stack against its plain version and its bytes bound (the numbers of
   K5's entry in the ``kernels`` line, since every K5 launch of the paths is
   this wrapper's) and on the f32 stack against ``F.grid_sample``;
6. the CLI: that 4096^2 stack written as an OME CycleStack and run through
   ``microaligner_tpu_torch.__main__.main`` in process and once more as
   ``python -m microaligner_tpu_torch``; then a 2-cycle x 2-channel 20480^2
   u16 CycleStack through the CLI in process.  Each output is checked: its
   TCZYX shape and OME sizes, the reference cycle bit for bit, and the
   registered planes' interior MSE to cycle 1 below a quarter of the
   unregistered MSE;
7. FeatureReg: ``FeatureRegistrator.register`` on config 1's pair of the
   JAX package's bench (4096^2, ``t_true`` of ``bench.py::bench_feature``),
   two textures, each on the card and on the CPU (the corners within 1e-3
   px of each other and within 0.5 px of the truth), then on a 20480^2
   pair with the stage timers on (each level's find, match, RANSAC and
   gate, summed over the iterations);
8. the chained CLI (``config_with_all_info.yaml``'s parameters: FeatureReg,
   then OptFlowReg) at 4096^2 (3 cycles x 2 channels x 3 z, one OME-TIFF a
   cycle) and 20480^2 (2 x 2 x 1, one CycleStack).  Cycle 2 is the
   reference's texture moved by an affine (0.3 degrees, (37.4, -21.7) px)
   and a smooth displacement of 1 px; the synthetic planes are warped with
   ``scipy.ndimage.affine_transform`` (order 1), an independent warp.
   Checked: TCZYX shapes and OME sizes of both outputs, the CSV rows, the
   recovered affine within 0.5 px at the corners, the reference cycle bit
   for bit, the registered MSE below a quarter of the unregistered;
9. the automatic FeatureReg pass: an OptFlowReg-only config over one
   4096 x 4096 and one 4000 x 4100 image;
10. the JAX package's alternate routes (``alternate_routes``, run after
   phase 6's 4096^2 CLI; each variable set for its case only, the
   environment restored after it): under ``MICROALIGNER_TPU_FLOW_DENSE=0``
   phase 3's 1024^2 parity (card against CPU, phase 3's bars), a 20480^2
   register, ``Warper.warp_device`` and ``_apply_flow_plane`` (K1-K4
   launched, K5 never; the main path's bars), timed beside the banded
   route on the same pair, and the 4096^2 OptFlowReg CLI (K5 never; the
   CLI's MSE bar); the three OptFlow drivers (whole,
   ``WHOLE_REGISTER=0``, ``CARRY_LEVEL=0``) on one 4096^2 pair, the same
   accept/reject and flows within 1e-4 px; on config 1's 4096^2 pair the
   FeatureReg drivers (``FUSED_REGISTER=0``, ``FUSED_LEVEL=0``: linear part
   within 1e-4 and translation within 0.05 px of the whole route's) and
   the per-tile feature path (``FEATURE_DENSE=0``: the whole level's
   keypoints), each within 0.5 px of the truth, then ``FEATURE_DENSE=0``
   once at ``FEATURE_PER_TILE_N``^2, timed; FeatureReg under
   ``DAISY_NRM=0`` (the reference's raw descriptors) at config 1's
   parameters: at 1024^2 with and without DoG on the card and on the CPU
   (corners within 1e-3 px, the same outcome), at 4096^2 without DoG within
   0.5 px of the truth, at 20480^2 timed beside the unit-norm route with
   each ``match_descriptors`` call's near-ties; and a 20480^2 register
   under ``FLOW_BAND_ROWS=1088``, bit-equal to ``band_rows = 1088``, timed
   beside the default bands.  Phase 2 also holds K2-K4 at the per-tile
   route's chunk, 8 halo windows of 1200^2, and times them;
11. the tile mesh (``mesh_phase``; one card, so a mesh of several entries
   repeats ``cuda:0`` and its shards run one after the other): (a) the
   sharded register step (``parallel/step.py``) at config 2 of the JAX
   package's bench (4096^2, tile 1000, overlap 100, window 99, 3
   iterations: 25 halo windows) on the meshes (cuda:0,) x 1, 2 and 4, the
   flow, warp and NMI histogram bit-equal across them and the histogram at
   exactly 4096^2, each timed with CUDA events; (b) that step at 1024^2,
   tile 500, on the card against a CPU mesh of 2 (phase 3's bars); (c) a
   20480^2 ``register_device`` on both ``FLOW_DENSE`` routes,
   ``Warper.warp_device`` and ``affine_warp_bands`` of a u16 plane, and
   FeatureReg's banded and per-tile ``find_features`` at 4096^2, each on
   (cuda:0,) x 2 against (cuda:0,), in turns, bit-equal, with both meshes'
   peak device memory; (d) a 1-rank NCCL group formed by
   ``init_distributed_from_env`` running ``tile_map`` and an
   ``all_reduce``, then 2 gloo ranks on the one card running (a)'s step,
   each rank's outputs bit-equal to the one-process result (every group a
   subprocess, killed if it outlasts its timeout).

Every path of phases 4-11 runs with the kernels' launch counters set to 0
just before it and read just after: each kernel of the path must have
launched and no plain version may have run.  The last lines are the card's
name and power limit as nvidia-smi prints them, a JSON object with one entry
per kernel, and ``{"ok": true, ...}``.  Any failed check raises and the
script exits non-zero.  Without a CUDA device it exits non-zero before
printing anything.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
# K3's bar is against its plain version: the kernel sums each tap with one fused multiply-add
# (one rounding) where the plain version multiplies and adds (two), so the two differ in the
# last bits of every sum and K3 is held to 1e-4 px of flow, not bit for bit; it must also be
# no further from a float64 run of the plain version than the float32 plain version is
TOL = {"K1": "0: bit-equal to its plain version", "K2": "1e-5*max|plain|+1e-6", "K3": "atol 1e-4 px", "K4": "1e-5*max|plain|+1e-6",
       "K5": "0: bit-equal to its plain version and to one K1 launch a plane",
       "K6": "0: bit-equal to its plain version and to K2's expansions"}
# NVIDIA H100 SXM: HBM3 rate and float32 rate outside the tensor cores
H100_BYTES_PER_S, H100_F32_FLOPS = 3.35e12, 67e12


class CheckFailed(RuntimeError):
    """A phase's check did not hold."""


def require(cond, msg) -> None:
    """Raise unless ``cond`` (not ``assert``: checks must survive ``-O``)."""
    if not cond:
        raise CheckFailed(str(msg))


def log(*args):
    print(*args, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def clocks_under(fn, launches: int = 1000) -> str:
    """nvidia-smi's SM clock and power draw, read once while ``launches``
    calls of ``fn`` are queued on the card."""
    fn()
    torch.cuda.synchronize()
    for _ in range(launches):
        fn()
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    torch.cuda.synchronize()
    return out


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call over ``reps`` calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class Counters:
    """The launch counters of every kernel wrapper and the call counters of
    their plain versions: ``reset()`` just before a path, ``read()`` just
    after it.  K5 has two entries, the float32 one and the band entry of the
    band warps (the z-stack apply's and, at one plane, the Warper's, the
    per-plane apply's and the banded Farneback's post-warp); their counts
    are summed."""

    def __init__(self):
        from microaligner_tpu_torch.ops import kernel_agg, kernel_matrices, kernel_poly, kernel_sample as ks

        self.wrappers = {"K1": (ks.sample_displaced,), "K2": (kernel_poly.poly_pair_m,),
                         "K3": (kernel_agg.smooth5_solve,), "K4": (kernel_matrices.update_matrices,),
                         "K5": (ks.sample_displaced_multi, ks.sample_band_multi), "K6": (kernel_poly.poly_exp5,)}
        self.plains = {"K1": (ks.sample_displaced_plain,), "K2": (kernel_poly.poly_pair_m_plain,),
                       "K3": (kernel_agg.smooth5_solve_plain,), "K4": (kernel_matrices.update_matrices_plain,),
                       "K5": (ks.sample_displaced_multi_plain, ks.sample_band_multi_plain),
                       "K6": (kernel_poly.poly_exp5_plain,)}

    def reset(self) -> None:
        for fns in (*self.wrappers.values(), *self.plains.values()):
            for fn in fns:
                if hasattr(fn, "launches"):
                    fn.launches = 0
                if hasattr(fn, "calls"):
                    fn.calls = 0

    def snapshot(self) -> dict:
        """Launches of each kernel's wrappers and calls of its plain versions
        (``K1 plain`` ...) so far."""
        got = {k: sum(w.launches for w in fns) for k, fns in self.wrappers.items()}
        got.update({k + " plain": sum(f.calls for f in fns) for k, fns in self.plains.items()})
        return got

    def read(self, path: str, kernels) -> dict:
        """Launches of every kernel since ``reset``; raises unless each of
        ``kernels`` launched and no plain version ran."""
        launches = {k: sum(w.launches for w in fns) for k, fns in self.wrappers.items()}
        plain = {k: sum(f.calls for f in fns) for k, fns in self.plains.items()}
        log(f"[{path}] kernel launches {launches}; plain versions called {plain}")
        require(all(launches[k] > 0 for k in kernels), f"{path}: a kernel of the path was never launched")
        require(not any(plain.values()), f"{path}: a plain version ran on the path")
        return launches


def texture(rng, h, w, dev, sigmas=(2.0, 6.0)) -> torch.Tensor:
    """Smooth random texture in [0, 1] (noise from numpy, blurred on ``dev``)."""
    from microaligner_tpu_torch.ops.filters import gaussian_blur, minmax_normalize_f32

    noise = torch.from_numpy(rng.random((h, w), dtype=np.float32)).to(dev)
    out = sum(gaussian_blur(noise, int(6 * s) | 1, s) * (i + 1) for i, s in enumerate(sigmas))
    return minmax_normalize_f32(out)


def displacement(h, w, amp, phase, dev, wavelength=700.0):
    """A known smooth warp: (dx, dy) = amp * (sin(y / L + phase), cos(x / L - phase))."""
    ys = torch.arange(h, device=dev, dtype=torch.float32).view(h, 1)
    xs = torch.arange(w, device=dev, dtype=torch.float32).view(1, w)
    dx = amp * torch.sin(ys / (wavelength / (2 * math.pi)) + phase).expand(h, w)
    dy = 0.7 * amp * torch.cos(xs / (wavelength / (2 * math.pi)) - phase).expand(h, w)
    return dx, dy


def remap_rows(img, dx, dy, rows=2048):
    """mov(p) = img(p + d(p)), bilinear, zero outside, in row chunks (the
    plain gather of ``bilinear_remap``, not the kernel under test)."""
    from microaligner_tpu_torch.ops.warp import bilinear_remap

    h, w = img.shape
    out = torch.empty_like(img)
    xs = torch.arange(w, device=img.device, dtype=torch.float32).view(1, w)
    for r0 in range(0, h, rows):
        r1 = min(h, r0 + rows)
        ys = torch.arange(r0, r1, device=img.device, dtype=torch.float32).view(-1, 1)
        out[r0:r1] = bilinear_remap(img, xs + dx[r0:r1], ys + dy[r0:r1])
    return out


# -- phase 2 ---------------------------------------------------------------

def kernel_bounds(h, w, planes=8, taps=99) -> dict:
    """{kernel: (bound ms, "bytes" or "operations")} at an (h, w) slab: each
    input read once and each output written once over HBM's rate, against
    the float32 operations over the non-tensor-core rate.  Operations a
    pixel are counted from each kernel's arithmetic (K3: two passes of 5
    planes x ``taps`` multiply-adds, plus the solve)."""
    px, pad = h * w, (h + 2) * (w + 2)
    work = {  # (bytes, float32 operations)
        "K1": (4 * px + 8 * px + 4 * px, 17 * px),
        "K2": (2 * 4 * pad + 15 * 4 * px, 170 * px),
        "K3": (5 * 4 * px + 2 * 4 * px, (2 * 5 * taps * 2 + 15) * px),
        "K4": (10 * 4 * px + 8 * px + 5 * 4 * px, 90 * px),
        "K5": (planes * 4 * px * 2 + 8 * px, (13 * planes + 4) * px),
        "K6": (4 * pad + 5 * 4 * px, 66 * px),
    }
    out = {}
    for k, (nbytes, flops) in work.items():
        tb, tf = 1e3 * nbytes / H100_BYTES_PER_S, 1e3 * flops / H100_F32_FLOPS
        out[k] = (max(tb, tf), "bytes" if tb >= tf else "operations")
    return out


def band_entry_bound(planes, px, itemsize) -> tuple:
    """(bound ms, "bytes" or "operations") of K5's band entry over ``planes``
    stored planes of ``px`` pixels: each stored plane read once and written
    once, the (H, W, 2) flow read once; K5's operations a plane and output
    (``kernel_bounds``), the taps' 4 conversions and the rounding's 3."""
    nbytes, ops = planes * px * itemsize * 2 + 8 * px, (20 * planes + 4) * px
    tb, tf = 1e3 * nbytes / H100_BYTES_PER_S, 1e3 * ops / H100_F32_FLOPS
    return max(tb, tf), "bytes" if tb >= tf else "operations"


def device_generator(rng, dev) -> torch.Generator:
    """A torch generator on ``dev`` seeded from ``rng``: large random inputs
    are made on the card, not on the host."""
    return torch.Generator(device=dev).manual_seed(int(rng.integers(2**62)))


def sample_grid(fx, fy):
    """The (N, H, W, 2) ``grid_sample`` grid (align_corners=True) of p +
    (fx, fy): the library call is timed only, its [-1, 1] coordinates lose
    about 1e-3 px at 20k."""
    n, h, w = fx.shape
    xs = torch.arange(w, device=fx.device, dtype=torch.float32).view(1, 1, w)
    ys = torch.arange(h, device=fx.device, dtype=torch.float32).view(1, h, 1)
    return torch.stack([(xs + fx) * (2.0 / (w - 1)) - 1.0, (ys + fy) * (2.0 / (h - 1)) - 1.0], dim=-1)


def grid_sample_call(img, grid):
    return F.grid_sample(img, grid, mode="bilinear", padding_mode="zeros", align_corners=True)


def poly_filters(coeffs, dev) -> torch.Tensor:
    """K6's expansion as five folded 3 x 3 correlation filters for
    ``F.conv2d`` (the library yardstick)."""
    g0, g1, xg1, xxg1, ig11, ig03, ig33, ig55 = coeffs
    g = np.array([g0, g1, g0])
    xg = np.array([-xg1, 0.0, xg1])
    xxg = np.array([xxg1, 0.0, xxg1])
    filt = [ig11 * np.outer(xg, g), ig11 * np.outer(g, xg),
            ig33 * np.outer(xxg, g) + ig03 * np.outer(g, g),
            ig33 * np.outer(g, xxg) + ig03 * np.outer(g, g), ig55 * np.outer(xg, xg)]
    return torch.tensor(np.stack(filt)[:, None], dtype=torch.float32, device=dev)

BAND_SHAPES = ((4296, 4296, "4096^2 band slab"), (1256, 20680, "20480^2 band slab"))
EDGE_SHAPES = ((9, 45, "H<16"), (37, 1001, "ragged width"))
# K1 where the main path launches it: a chunk of the tiled flow composition (``compose_flows_batched``),
# 32 halo windows of tile 1000 + 2 x overlap 100
COMPOSE_CHUNK = (32, 1200)
# K2-K4 where the per-tile route (MICROALIGNER_TPU_FLOW_DENSE=0) launches them: a chunk of
# MICROALIGNER_TPU_FLOW_TILE_BATCH's default 8 halo windows of tile 1000 + 2 x overlap 100
PER_TILE_CHUNK = (8, 1200)
# K3 beside the main path's window of 99: (N, H, W, winsize), cropped from one real M
K3_WINDOW_SHAPES = ((2, 12, 45, 11), (1, 515, 290, 11), (1, 70, 300, 257), (1, 700, 520, 257),
                    (2, 300, 1001, 99), (1, 40, 30, 99), (1, 3, 2, 99), (1, 1, 3, 11), (3, 2, 1, 11))
F64_SLACK = 1e-6  # px: K3 may be this much further from the float64 run than its plain version


def check_kernels(dev, rng) -> dict:
    from microaligner_tpu_torch.ops import kernel_agg, kernel_matrices, kernel_poly, kernel_sample
    from microaligner_tpu_torch.optflow import farneback as fb

    coeffs = fb._poly_coeff_tuple(1, 1.7)
    results = {k: {"max_abs_err": 0.0} for k in ("K1", "K2", "K3", "K4")}

    def rel_ok(name, got, want):
        err = float((got - want).abs().max())
        bound = 1e-5 * float(want.abs().max()) + 1e-6
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)
        require(err <= bound, f"{name}: max abs err {err} > {bound}")
        return err

    def abs_ok(name, got, want, atol):
        err = float((got - want).abs().max())
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)
        require(err <= atol, f"{name}: max abs err {err} > {atol}")
        return err

    def k3_f64_ok(label, m, win, got, plain):
        """K3 and its float32 plain version, each against the plain version
        run in float64 on the same M: the kernel's max and mean absolute
        error in fx, fy must be no larger than the plain version's."""
        exact = kernel_agg.smooth5_solve_plain(m.double(), win)
        errs = {}
        for name, pair in (("kernel", got), ("plain", plain)):
            diffs = [(a.double() - e).abs() for a, e in zip(pair, exact)]
            errs[name] = (max(float(d.max()) for d in diffs), max(float(d.mean()) for d in diffs))
        del exact
        worst = results["K3"].setdefault("f64", {"kernel_max": 0.0, "plain_max": 0.0, "kernel_mean": 0.0,
                                                 "plain_mean": 0.0})
        for name, (mx, mean) in errs.items():
            worst[name + "_max"], worst[name + "_mean"] = max(worst[name + "_max"], mx), max(worst[name + "_mean"], mean)
        log(f"[kernels] K3 {label} window {win} against float64: kernel max {errs['kernel'][0]:.3e} mean "
            f"{errs['kernel'][1]:.3e} px, plain version max {errs['plain'][0]:.3e} mean {errs['plain'][1]:.3e} px")
        require(errs["kernel"][0] <= errs["plain"][0] + F64_SLACK and errs["kernel"][1] <= errs["plain"][1] + F64_SLACK,
                f"K3 {label}: further from the float64 run than its plain version: {errs}")

    def k3_windows():
        """K3 at windows 11 and 257 (and 99 at N = 2 and at H, W < r): against
        its plain version, against float64, and the row pass alone."""
        n, h, w = 3, 708, 1009
        base = texture(rng, h + 8, w + 8, dev) * 255
        scale = torch.tensor([1.0, 0.6, 0.3], device=dev).view(n, 1, 1)
        mov = (base[4 : 4 + h, 4 : 4 + w][None] * scale).contiguous()
        ref = (base[3 : 3 + h, 5 : 5 + w][None] * scale).contiguous()
        m_all = kernel_poly.poly_pair_m_plain(fb._pad_replicate1(fb._pre_smooth(mov)),
                                              fb._pad_replicate1(fb._pre_smooth(ref)), coeffs)[2]
        unit = torch.from_numpy(rng.random((3, 5, h, w), dtype=np.float32)).to(dev)
        for n, h, w, win in K3_WINDOW_SHAPES:
            m = m_all[:n, :, :h, :w].contiguous()
            got = kernel_agg.smooth5_solve(m, win)
            plain = kernel_agg.smooth5_solve_plain(m, win)
            err = max(abs_ok("K3", g, p, 1e-4) for g, p in zip(got, plain))
            x = unit[:n, :, :h, :w].contiguous()
            row_err = float((kernel_agg.smooth_w(x, win) - kernel_agg.smooth_w_plain(x, win)).abs().max())
            log(f"[kernels] K3 {n}x{h}x{w} window {win}: max_abs_err {err:.3e} ({TOL['K3']}); row pass alone on "
                f"unit-range data {row_err:.3e} (atol 1e-5)")
            require(row_err <= 1e-5, f"K3 row pass {n}x{h}x{w} window {win}: {row_err} > 1e-5")
            k3_f64_ok(f"{n}x{h}x{w}", m, win, got, plain)

    def case(h, w, label, timed):
        base = texture(rng, h + 8, w + 8, dev) * 255
        mov = base[4 : 4 + h, 4 : 4 + w][None].contiguous()
        ref = base[3 : 3 + h, 5 : 5 + w][None].contiguous()
        sp0 = fb._pad_replicate1(fb._pre_smooth(mov))
        sp1 = fb._pad_replicate1(fb._pre_smooth(ref))
        line = {}
        # K2
        got = kernel_poly.poly_pair_m(sp0, sp1, coeffs)
        want = kernel_poly.poly_pair_m_plain(sp0, sp1, coeffs)
        line["K2"] = max(rel_ok("K2", g, wv) for g, wv in zip(got, want))
        r0, r1, m0 = want
        del got
        # K3 on the real first-iteration equations
        fx, fy = kernel_agg.smooth5_solve(m0, 99)
        rx, ry = kernel_agg.smooth5_solve_plain(m0, 99)
        line["K3"] = max(abs_ok("K3", fx, rx, 1e-4), abs_ok("K3", fy, ry, 1e-4))
        k3_f64_ok(f"{label} {h}x{w}", m0, 99, (fx, fy), (rx, ry))
        # K4 at the flow K3 found
        got = kernel_matrices.update_matrices(r0, r1, rx, ry)
        line["K4"] = rel_ok("K4", got, kernel_matrices.update_matrices_plain(r0, r1, rx, ry))
        del got
        # K1: the band image pulled by that flow, and by +-20 px, bit for bit
        img = (mov / 255).contiguous()
        nfx, nfy = -rx, -ry
        big = torch.from_numpy(((rng.random((2, h, w)) - 0.5) * 40).astype(np.float32)).to(dev)
        line["K1"] = max(abs_ok("K1", kernel_sample.sample_displaced(img, *f), kernel_sample.sample_displaced_plain(img, *f),
                                0.0) for f in ((nfx, nfy), (big[0:1].contiguous(), big[1:2].contiguous())))
        times = {}
        if timed:
            reps, preps = (20, 3)
            calls = {
                "K1": (lambda: kernel_sample.sample_displaced(img, nfx, nfy),
                       lambda: kernel_sample.sample_displaced_plain(img, nfx, nfy)),
                "K2": (lambda: kernel_poly.poly_pair_m(sp0, sp1, coeffs),
                       lambda: kernel_poly.poly_pair_m_plain(sp0, sp1, coeffs)),
                "K3": (lambda: kernel_agg.smooth5_solve(m0, 99),
                       lambda: kernel_agg.smooth5_solve_plain(m0, 99)),
                "K4": (lambda: kernel_matrices.update_matrices(r0, r1, rx, ry),
                       lambda: kernel_matrices.update_matrices_plain(r0, r1, rx, ry)),
            }
            for k, (kern, plain) in calls.items():
                # order plain, kernel, kernel, plain: compare within one call
                p1 = cuda_ms(plain, preps)
                k1 = cuda_ms(kern, reps)
                k2 = cuda_ms(kern, reps)
                p2 = cuda_ms(plain, preps)
                times[k] = (min(k1, k2), min(p1, p2), None)
            grid = sample_grid(nfx, nfy)
            times["K1"] = times["K1"][:2] + (cuda_ms(lambda: grid_sample_call(img[:, None], grid), reps),)
            # and under the random flow: kernel, grid_sample, kernel
            bx, by = big[0:1].contiguous(), big[1:2].contiguous()
            grid = sample_grid(bx, by)
            k_r = cuda_ms(lambda: kernel_sample.sample_displaced(img, bx, by), reps)
            lib_r = cuda_ms(lambda: grid_sample_call(img[:, None], grid), reps)
            k_r = min(k_r, cuda_ms(lambda: kernel_sample.sample_displaced(img, bx, by), reps))
            times["K1 random"] = (k_r, lib_r)
            log(f"[kernels] K1 {label} {h}x{w}, random +-20 px flow: kernel {k_r:.4f} ms grid_sample {lib_r:.4f} ms")
            del grid, bx, by
            # K3's two passes apart (the row pass is `smooth_w`), and the clock the sums run at
            row_ms = min(cuda_ms(lambda: kernel_agg.smooth_w(m0, 99), reps) for _ in range(2))
            key = "" if label.startswith("4096") else "_20k_band"
            results["K3"]["row_pass_ms" + key] = row_ms
            results["K3"]["clocks_under_load" + key] = clocks_under(lambda: kernel_agg.smooth5_solve(m0, 99))
            log(f"[kernels] K3 {label} {h}x{w}: row pass alone {row_ms:.4f} ms, column pass + solve "
                f"{times['K3'][0] - row_ms:.4f} ms; SM clock and power draw under 1000 queued K3 calls: "
                f"{results['K3']['clocks_under_load' + key]}")
        for k in ("K1", "K2", "K3", "K4"):
            t = f" kernel {times[k][0]:.4f} ms plain {times[k][1]:.4f} ms" if k in times else ""
            if k in times and times[k][2] is not None:
                t += f" grid_sample {times[k][2]:.4f} ms"
            log(f"[kernels] {k} {label} {h}x{w}: max_abs_err {line[k]:.3e} ({TOL[k]}){t}")
        return times

    def k1_compose():
        """K1 at the main path's shape: one chunk of the tiled flow
        composition, which samples flow2's channels (N windows of a smooth
        flow of a few px) at p - flow1(p) (another such flow), one launch a
        channel; and the same windows under a random +-20 px flow.  Bit for
        bit, and timed under the smooth flow against its plain version,
        ``grid_sample`` and its bound (plain, kernel, grid_sample, kernel,
        plain)."""
        n, s = COMPOSE_CHUNK
        ph = torch.arange(n, device=dev, dtype=torch.float32).view(n, 1, 1) * 0.37
        ys = torch.arange(s, device=dev, dtype=torch.float32).view(1, s, 1)
        xs = torch.arange(s, device=dev, dtype=torch.float32).view(1, 1, s)
        img = (2.5 * torch.sin(xs / 90 + ph) * torch.cos(ys / 130 - ph)).contiguous()
        fx = (-3.0 * torch.sin(ys / 110 + ph)).expand(n, s, s).contiguous()
        fy = (-2.1 * torch.cos(xs / 110 - ph)).expand(n, s, s).contiguous()
        big = torch.rand((2, n, s, s), generator=device_generator(rng, dev), device=dev).sub_(0.5).mul_(40)
        for f in ((fx, fy), (big[0], big[1])):
            abs_ok("K1", kernel_sample.sample_displaced(img, *f), kernel_sample.sample_displaced_plain(img, *f), 0.0)
        del big
        grid = sample_grid(fx, fy)
        p1 = cuda_ms(lambda: kernel_sample.sample_displaced_plain(img, fx, fy), 3)
        k_1 = cuda_ms(lambda: kernel_sample.sample_displaced(img, fx, fy), 20)
        lib = cuda_ms(lambda: grid_sample_call(img[:, None], grid), 20)
        k_2 = cuda_ms(lambda: kernel_sample.sample_displaced(img, fx, fy), 20)
        p2 = cuda_ms(lambda: kernel_sample.sample_displaced_plain(img, fx, fy), 3)
        bound, by = kernel_bounds(n * s, s)["K1"]
        res = {"shape": f"{n} x {s}^2", "ms": min(k_1, k_2), "plain_ms": min(p1, p2), "library_ms": lib,
               "bound_ms": bound, "bound_by": by}
        log(f"[kernels] K1 at the flow composition's chunk, {n} x {s}^2: kernel {res['ms']:.4f} ms "
            f"({100 * bound / res['ms']:.0f}% of its {bound:.4f} ms bound, {by}), grid_sample {lib:.4f} ms, plain "
            f"{res['plain_ms']:.3f} ms; bit-equal to its plain version there and under a random +-20 px flow")
        return res

    def k234_per_tile():
        """K2-K4 where the per-tile route (``MICROALIGNER_TPU_FLOW_DENSE=0``)
        launches them: one chunk of 8 halo windows of 1200^2 (tile 1000,
        overlap 100), held to their bars (K3 at window 99 also against
        float64) and timed against their plain versions and bounds (plain,
        kernel, kernel, plain)."""
        n, s = PER_TILE_CHUNK
        base = texture(rng, s + 8, n * s + 8, dev) * 255
        mov = torch.stack([base[4 : 4 + s, i * s + 4 : i * s + 4 + s] for i in range(n)]).contiguous()
        ref = torch.stack([base[3 : 3 + s, i * s + 5 : i * s + 5 + s] for i in range(n)]).contiguous()
        del base
        sp0, sp1 = fb._pad_replicate1(fb._pre_smooth(mov)), fb._pad_replicate1(fb._pre_smooth(ref))
        del mov, ref
        errs = {}
        got = kernel_poly.poly_pair_m(sp0, sp1, coeffs)
        want = kernel_poly.poly_pair_m_plain(sp0, sp1, coeffs)
        errs["K2"] = max(rel_ok("K2", g, wv) for g, wv in zip(got, want))
        del got
        r0, r1, m0 = want
        fx, fy = kernel_agg.smooth5_solve(m0, 99)
        rx, ry = kernel_agg.smooth5_solve_plain(m0, 99)
        errs["K3"] = max(abs_ok("K3", fx, rx, 1e-4), abs_ok("K3", fy, ry, 1e-4))
        k3_f64_ok(f"per-tile chunk {n} x {s}^2", m0, 99, (fx, fy), (rx, ry))
        del fx, fy
        errs["K4"] = rel_ok("K4", kernel_matrices.update_matrices(r0, r1, rx, ry),
                            kernel_matrices.update_matrices_plain(r0, r1, rx, ry))
        calls = {
            "K2": (lambda: kernel_poly.poly_pair_m(sp0, sp1, coeffs),
                   lambda: kernel_poly.poly_pair_m_plain(sp0, sp1, coeffs)),
            "K3": (lambda: kernel_agg.smooth5_solve(m0, 99), lambda: kernel_agg.smooth5_solve_plain(m0, 99)),
            "K4": (lambda: kernel_matrices.update_matrices(r0, r1, rx, ry),
                   lambda: kernel_matrices.update_matrices_plain(r0, r1, rx, ry)),
        }
        bounds = kernel_bounds(n * s, s)
        out = {}
        for k, (kern, plain) in calls.items():
            p1, k_1, k_2, p2 = cuda_ms(plain, 3), cuda_ms(kern, 20), cuda_ms(kern, 20), cuda_ms(plain, 3)
            out[k] = {"shape": f"{n} x {s}^2", "ms": min(k_1, k_2), "plain_ms": min(p1, p2),
                      "bound_ms": bounds[k][0], "bound_by": bounds[k][1], "max_abs_err": errs[k]}
            log(f"[kernels] {k} at the per-tile chunk, {n} x {s}^2: kernel {out[k]['ms']:.4f} ms "
                f"({100 * bounds[k][0] / out[k]['ms']:.0f}% of its {bounds[k][0]:.4f} ms bound, {bounds[k][1]}), "
                f"plain {out[k]['plain_ms']:.3f} ms; max_abs_err {errs[k]:.3e} ({TOL[k]})")
        return out

    t4k, t20k = (case(h, w, label, timed=True) for h, w, label in BAND_SHAPES)
    for h, w, label in EDGE_SHAPES:
        case(h, w, label, timed=False)
    k3_windows()
    bounds = kernel_bounds(*BAND_SHAPES[0][:2])
    for key, t in (("", t4k), ("_20k_band", t20k)):
        results["K1"]["ms_random_flow" + key], results["K1"]["library_ms_random_flow" + key] = t["K1 random"]
    for k in results:
        results[k]["ms"], results[k]["plain_ms"], results[k]["library_ms"] = t4k[k]
        results[k]["ms_20k_band"], results[k]["plain_ms_20k_band"], results[k]["library_ms_20k_band"] = t20k[k]
        results[k]["bound_ms"], results[k]["bound_by"] = bounds[k]
        results[k]["bound_ms_20k_band"] = kernel_bounds(*BAND_SHAPES[1][:2])[k][0]
    # K1's own keys: the shape the main path gives it; its 4296^2 band slab's keep the suffix _4k_band
    for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
        results["K1"][key + "_4k_band"] = results["K1"][key]
    results["K1"].update(k1_compose())
    for k, entry in k234_per_tile().items():
        results[k]["per_tile_chunk"] = entry
    # the wrappers refuse what the kernels do not take
    for bad in (lambda: kernel_sample.sample_displaced(torch.zeros((1, 4, 4), device=dev, dtype=torch.float64),
                                                       torch.zeros((1, 4, 4), device=dev),
                                                       torch.zeros((1, 4, 4), device=dev)),
                lambda: kernel_agg.smooth5_solve(torch.zeros((1, 5, 8, 8), device=dev), 301)):
        try:
            bad()
        except (TypeError, ValueError):
            pass
        else:
            raise CheckFailed("a wrapper accepted an input its kernel does not take")
    # u16 planes on the card: the copy and cast kernels the apply relies on
    u16 = torch.from_numpy(rng.integers(0, 65536, (64, 70)).astype(np.uint16)).to(dev)
    require(torch.equal(u16.to(torch.float32).round().to(torch.uint16).cpu(), u16.cpu()),
            "u16 round trip on the card")
    return results


# (dtype, H, W): 4096^2 planes of five dtypes, a width whose u16 rows are not on 16 bytes, and the 20480^2
# planes of the Warper's and the per-plane apply's 20k paths
ONE_PLANE_BANDS = ((torch.uint8, 4096, 4096), (torch.uint16, 4096, 4096), (torch.int16, 4096, 4096),
                   (torch.int32, 4096, 4096), (torch.float32, 4096, 4096), (torch.uint16, 4096, 4100),
                   (torch.uint8, 20480, 20480), (torch.uint16, 20480, 20480))


def typed_plane(gen, dt, h, w, dev) -> torch.Tensor:
    """A white-noise plane stored as ``dt``, over most of its range (int32:
    up to about 2^31, where the rounding saturates), made on ``dev`` by
    the generator ``gen``."""
    base = torch.randint(0, 65535, (h, w), generator=gen, device=dev, dtype=torch.int64)
    return {torch.uint8: base % 256, torch.int8: base % 256 - 128, torch.uint16: base, torch.int16: base - 32768,
            torch.int32: (base - 32768) * 65537, torch.float32: base.to(torch.float32) / 65535}[dt].to(dt)


def check_one_plane_band(dev, rng, tile=1000, overlap=100, timed=(4096, 20480)) -> dict:
    """The band entry of the one-plane band warps (``sample_band_multi`` at
    one plane: the Warper, the per-plane apply, the banded Farneback's
    post-warp) bit for bit against its plain version on the card, on the
    planes of ``ONE_PLANE_BANDS``, each as the main path cuts it (tile 1000,
    overlap 100) and, up to 4100 wide, also in bands of 1000 rows (a ragged
    last band), under the z-stack apply's smooth flow and a random +-20 px
    flow; a slab-coordinate flow (the banded Farneback's post-warp); an
    int32 plane at its maximum against the CPU's rounding.  Timed on the
    u16 4096^2 and 20480^2 planes under the smooth flow, plain, entry,
    entry, plain, against the bytes bound (the stored plane read and
    written once, the flow read once)."""
    from microaligner_tpu_torch.ops import kernel_sample as ks
    from microaligner_tpu_torch.optflow.flow_calc import band_rows_for
    from microaligner_tpu_torch.tiles import TileGrid

    res = {"max_abs_err": 0.0}
    gen = device_generator(rng, dev)

    def bit_ok(label, got, want):
        err = float((got.to(torch.float64) - want.to(torch.float64)).abs().max())
        res["max_abs_err"] = max(res["max_abs_err"], err)
        require(torch.equal(got, want), f"one-plane band entry {label}: not bit-equal to its plain version (err {err})")

    def bands(fn, img, flow, out, rows):
        for row0 in range(0, img.shape[-2], rows):
            fn(img[None], flow, out[None], row0, rows, overlap)
        return out

    def main_rows(h, w):
        return band_rows_for(TileGrid.for_image((h, w), tile, overlap))

    for dt, h, w in ONE_PLANE_BANDS:
        img = typed_plane(gen, dt, h, w, dev)
        for flow_kind in ("smooth", "random"):
            flow = (torch.stack(smooth_flow(h, w, dev), dim=-1).contiguous() if flow_kind == "smooth" else
                    torch.rand((h, w, 2), generator=gen, device=dev).sub_(0.5).mul_(40))
            for rows in (main_rows(h, w),) + ((1000,) if w <= 4100 else ()):
                got = bands(ks.sample_band_multi, img, flow, torch.empty_like(img), rows)
                bit_ok(f"{dt} {h}x{w} {flow_kind} rows {rows}", got, bands(ks.sample_band_multi_plain, img, flow,
                                                                           torch.empty_like(img), rows))
                del got
            del flow
        del img
    # the banded Farneback's post-warp: the band's own flow in slab coordinates, its halo not read
    img = typed_plane(gen, torch.uint16, 1000, 3000, dev)
    rows = 256
    for row0 in range(0, 1000, rows):
        slab = (torch.rand((2, rows + 2 * overlap, 3000 + 2 * overlap), generator=gen, device=dev) - 0.5) * 40
        pair = (slab[0], slab[1])
        got = ks.sample_band_multi(img[None], pair, torch.zeros_like(img)[None], row0, rows, overlap)
        bit_ok(f"slab flow, band at {row0}", got, ks.sample_band_multi_plain(
            img[None], pair, torch.zeros_like(img)[None], row0, rows, overlap))
    # int32 at its maximum: the card's saturating store against the CPU's rounding
    top = torch.full((1, 64, 304), 2**31 - 1, dtype=torch.int32)
    top[..., ::3] = 2**31 - 200
    flow = torch.full((64, 304, 2), 0.5, dtype=torch.float32)
    want = ks.sample_band_multi_plain(top, flow, torch.empty_like(top), 0, 64, overlap)
    got = ks.sample_band_multi(top.to(dev), flow.to(dev), torch.empty_like(top, device=dev), 0, 64, overlap).cpu()
    require(torch.equal(got, want) and int(want.max()) == 2**31 - 1,
            f"int32 at its maximum: card {got.max()}, CPU {want.max()}")
    # timing: u16 planes under the smooth flow, cut as on the main path
    for n, key in zip(timed, ("", "_20k")):
        img = typed_plane(gen, torch.uint16, n, n, dev)
        flow = torch.stack(smooth_flow(n, n, dev), dim=-1).contiguous()
        rows = main_rows(n, n)
        out = torch.empty_like(img)
        p1, b1 = cuda_ms(lambda: bands(ks.sample_band_multi_plain, img, flow, out, rows), 3), cuda_ms(
            lambda: bands(ks.sample_band_multi, img, flow, out, rows), 20)
        b2, p2 = cuda_ms(lambda: bands(ks.sample_band_multi, img, flow, out, rows), 20), cuda_ms(
            lambda: bands(ks.sample_band_multi_plain, img, flow, out, rows), 3)
        bound, by = band_entry_bound(1, n * n, 2)
        res.update({"ms" + key: min(b1, b2), "plain_ms" + key: min(p1, p2), "bound_ms" + key: bound,
                    "bound_by" + key: by, "bands" + key: -(-n // rows)})
        log(f"[kernels] K5 band entry at one plane, u16 {n}^2, smooth flow, {res['bands' + key]} band(s): "
            f"{res['ms' + key]:.4f} ms ({100 * bound / res['ms' + key]:.0f}% of its {bound:.4f} ms bound, {by}), "
            f"plain {res['plain_ms' + key]:.3f} ms")
        del img, flow, out
    log(f"[kernels] K5 band entry at one plane: bit-equal to its plain version for {len(ONE_PLANE_BANDS)} planes "
        f"(up to 20480^2), the main path's band cut and bands of 1000 rows, 2 flows, a slab flow and int32 at its "
        f"maximum")
    return res


def smooth_flow(h, w, dev):
    """The z-stack apply's flow (config 4 of the JAX package's bench):
    fx = 2 sin(y / 50), fy = 1.5 cos(x / 45), each (h, w)."""
    ys = torch.arange(h, device=dev, dtype=torch.float32).view(h, 1).expand(h, w)
    xs = torch.arange(w, device=dev, dtype=torch.float32).view(1, w).expand(h, w)
    return (2.0 * torch.sin(ys / 50)).contiguous(), (1.5 * torch.cos(xs / 45)).contiguous()


def check_k5(dev, rng, planes=((8,) + BAND_SHAPES[0], (2,) + BAND_SHAPES[1])) -> dict:
    """K5 against its plain version and against N K1 launches (one a plane,
    the per-plane apply's path), bit for bit, with the share of its tiles
    that took the staged branch (the others gather from global memory).
    The band slabs are timed under two flows, in this order: a +-20 px
    random flow (a stress reading: no tile's taps fit the staged window)
    and the smooth flow of the z-stack apply (what the system produces).
    The z-stack apply times the band entry, which the ``kernels`` line
    reports; these times of the float32 entry stay in the report.  The edge shapes (H <
    16 with rows on 16 bytes or not, an odd width: rows not on 16 bytes take
    the direct branch) run both flows."""
    from microaligner_tpu_torch.ops import kernel_sample as ks

    res = {"max_abs_err": 0.0, "staged_share": {}}
    cases = [(n, h, w, label, flow, True) for n, h, w, label in planes for flow in ("random", "smooth")]
    cases += [(3, h, w, label, flow, False) for h, w, label in EDGE_SHAPES + ((9, 48, "H<16, rows on 16 B"),)
              for flow in ("random", "smooth")]
    for n, h, w, label, flow_kind, timed in cases:
        imgs = torch.from_numpy(rng.random((n, h, w), dtype=np.float32)).to(dev)
        if flow_kind == "random":
            flow = torch.from_numpy(((rng.random((2, h, w)) - 0.5) * 40).astype(np.float32)).to(dev)
            fx, fy = flow[0].contiguous(), flow[1].contiguous()
            del flow
        else:
            fx, fy = smooth_flow(h, w, dev)
        staged = torch.zeros(1, dtype=torch.int32, device=dev)
        got = ks.sample_displaced_multi(imgs, fx, fy, staged=staged)
        share = int(staged.item()) / (-(-h // ks.K5_TILE[0]) * -(-w // ks.K5_TILE[1]))
        res["staged_share"][f"{label} {flow_kind}"] = share
        want = ks.sample_displaced_multi_plain(imgs, fx, fy)
        per_plane = torch.stack([ks.sample_displaced(imgs[i : i + 1], fx[None], fy[None])[0]
                                 for i in range(n)])
        err = max(float((got - want).abs().max()), float((got - per_plane).abs().max()))
        res["max_abs_err"] = max(res["max_abs_err"], err)
        require(torch.equal(got, want) and torch.equal(got, per_plane),
                f"K5 {label}, {flow_kind} flow: not bit-equal to its plain version and to {n} K1 launches "
                f"(err {err})")
        t = ""
        if timed:
            def kern():
                return ks.sample_displaced_multi(imgs, fx, fy)

            def plain():
                return ks.sample_displaced_multi_plain(imgs, fx, fy)

            def k1s():
                for i in range(n):
                    ks.sample_displaced(imgs[i : i + 1], fx[None], fy[None])

            # order plain, kernel, N x K1, kernel, N x K1, plain
            p1, k_1, n1 = cuda_ms(plain, 3), cuda_ms(kern, 20), cuda_ms(k1s, 20)
            k_2, n2, p2 = cuda_ms(kern, 20), cuda_ms(k1s, 20), cuda_ms(plain, 3)
            grid = sample_grid(fx[None], fy[None])
            lib = cuda_ms(lambda: grid_sample_call(imgs[None], grid), 20)
            del grid
            key = ("" if flow_kind == "smooth" else "_random_flow") + ("" if label.startswith("4096") else "_20k_band")
            res["ms" + key], res["k1_x%d_ms" % n + key], res["plain_ms" + key], res["library_ms" + key] = (
                min(k_1, k_2), min(n1, n2), min(p1, p2), lib)
            res["bound_ms" + key], res["bound_by" + key] = kernel_bounds(h, w, planes=n)["K5"]
            t = (f" kernel {min(k_1, k_2):.4f} ms ({100 * res['bound_ms' + key] / min(k_1, k_2):.0f}% of its "
                 f"bound), {n} x K1 {min(n1, n2):.4f} ms, plain {min(p1, p2):.4f} ms, "
                 f"grid_sample {lib:.4f} ms, bound {res['bound_ms' + key]:.4f} ms")
        log(f"[kernels] K5 {label} {n}x{h}x{w}, {flow_kind} flow: max_abs_err {err:.3e} ({TOL['K5']}); "
            f"staged tiles {100 * share:.1f}%{t}")
        del imgs, fx, fy, got, want, per_plane
    shares = res["staged_share"].values()
    require(max(shares) > 0 and min(shares) < 1, f"K5: both branches must run, staged shares {res['staged_share']}")
    for bad in (lambda: ks.sample_displaced_multi(torch.zeros((2, 4, 4), device=dev),
                                                  torch.zeros((2, 4, 4), device=dev),
                                                  torch.zeros((2, 4, 4), device=dev)),
                lambda: ks.sample_displaced_multi(torch.zeros((2, 4, 4), device=dev, dtype=torch.float16),
                                                  torch.zeros((4, 4), device=dev),
                                                  torch.zeros((4, 4), device=dev)),
                lambda: ks.sample_band_multi(torch.zeros((2, 4, 4), device=dev, dtype=torch.float64),
                                             torch.zeros((4, 4, 2), device=dev),
                                             torch.zeros((2, 4, 4), device=dev, dtype=torch.float64), 0, 8, 2)):
        try:
            bad()
        except (TypeError, ValueError):
            pass
        else:
            raise CheckFailed("K5's wrapper accepted an input its kernel does not take")
    return res


def check_k6(dev, rng) -> dict:
    """K6 bit for bit against its plain version and K2's expansions, at the
    band slabs (timed) and at H or W of 1-3; times of K6, ``F.conv2d`` with
    the folded filters (same function, allclose), K2, and 2 x K6 plus the
    zero-flow combine (the unpaired route's stage, against K2)."""
    from microaligner_tpu_torch.ops import kernel_poly as kp
    from microaligner_tpu_torch.ops.kernel_matrices import zero_flow_matrices
    from microaligner_tpu_torch.optflow import farneback as fb

    coeffs = fb._poly_coeff_tuple(1, 1.7)
    weight = poly_filters(coeffs, dev)
    res = {"max_abs_err": 0.0}
    cases = [(1, h, w, label, True) for h, w, label in BAND_SHAPES]
    cases += [(2, 1, 45, "H=1", False), (1, 3, 2, "H=3 W=2", False), (3, 2, 3, "H=2 W=3", False),
              (1, 40, 1, "W=1", False)]
    for n, h, w, label, timed in cases:
        base = texture(rng, h + 8, w + 8, dev) * 255 if min(h, w) > 8 else \
            torch.from_numpy(rng.random((n, h + 8, w + 8), dtype=np.float32) * 255).to(dev)
        base = base.expand(n, h + 8, w + 8) if base.dim() == 2 else base
        mov = base[:, 4 : 4 + h, 4 : 4 + w].contiguous()
        ref = base[:, 3 : 3 + h, 5 : 5 + w].contiguous()
        sp0 = fb._pad_replicate1(fb._pre_smooth(mov))
        sp1 = fb._pad_replicate1(fb._pre_smooth(ref))
        got = kp.poly_exp5(sp0, coeffs)
        want = kp.poly_exp5_plain(sp0, coeffs)
        pair = kp.poly_pair_m(sp0, sp1, coeffs)
        err = float((got - want).abs().max())
        res["max_abs_err"] = max(res["max_abs_err"], err)
        require(torch.equal(got, want) and torch.equal(got, pair[0]),
                f"K6 {label}: not bit-equal to its plain version and K2's R0 (err {err})")
        line = f"[kernels] K6 {label} {n}x{h}x{w}: max_abs_err {err:.3e} ({TOL['K6']})"
        if timed:
            lib_out = F.conv2d(sp0[:, None], weight)
            lib_err = float((lib_out - want).abs().max())
            require(lib_err <= 1e-4 * float(want.abs().max()) + 1e-3, f"conv2d yardstick off by {lib_err}")
            del lib_out, pair, got

            def two_k6():
                return zero_flow_matrices(kp.poly_exp5(sp0, coeffs), kp.poly_exp5(sp1, coeffs))

            # order plain, kernel, conv2d, K2, 2 x K6 + combine, then back
            t = {"plain": [cuda_ms(lambda: kp.poly_exp5_plain(sp0, coeffs), 3)],
                 "kernel": [cuda_ms(lambda: kp.poly_exp5(sp0, coeffs), 20)],
                 "conv2d": [cuda_ms(lambda: F.conv2d(sp0[:, None], weight), 20)],
                 "k2": [cuda_ms(lambda: kp.poly_pair_m(sp0, sp1, coeffs), 20)],
                 "two_k6": [cuda_ms(two_k6, 20)]}
            for name, fn in (("two_k6", two_k6), ("k2", lambda: kp.poly_pair_m(sp0, sp1, coeffs)),
                             ("conv2d", lambda: F.conv2d(sp0[:, None], weight)),
                             ("kernel", lambda: kp.poly_exp5(sp0, coeffs)),
                             ("plain", lambda: kp.poly_exp5_plain(sp0, coeffs))):
                t[name].append(cuda_ms(fn, 3 if name == "plain" else 20))
            t = {k: min(v) for k, v in t.items()}
            key = "" if label.startswith("4096") else "_20k_band"
            res.update({"ms" + key: t["kernel"], "plain_ms" + key: t["plain"], "library_ms" + key: t["conv2d"],
                        "k2_ms" + key: t["k2"], "two_k6_combine_ms" + key: t["two_k6"],
                        "conv2d_max_abs_err" + key: lib_err})
            res["bound_ms" + key], res["bound_by" + key] = kernel_bounds(h, w)["K6"]
            line += (f" kernel {t['kernel']:.4f} ms, conv2d {t['conv2d']:.4f} ms, plain {t['plain']:.4f} ms, "
                     f"K2 {t['k2']:.4f} ms, 2 x K6 + combine {t['two_k6']:.4f} ms, "
                     f"bound {res['bound_ms' + key]:.4f} ms")
        log(line)
        del base, mov, ref, sp0, sp1, want
    return res


# -- phase 3 ---------------------------------------------------------------

def parity_run(dev, rng, n=1024, label="parity", counters: "Counters | None" = None, kernels=()) -> dict:
    """A 1024^2 pair registered on the card and through the plain versions
    on the CPU (tile 500, overlap 100, bands of 256 rows on the banded
    route); with ``counters``, the card run's launches are counted from 0
    and each of ``kernels`` must have launched."""
    from microaligner_tpu_torch.ops.filters import minmax_normalize_u8
    from microaligner_tpu_torch.optflow.registrator import OptFlowRegistrator

    base = texture(rng, n, n, torch.device("cpu"))
    dx, dy = displacement(n, n, 3.0, 0.4, torch.device("cpu"), wavelength=400.0)
    ref = minmax_normalize_u8(base).numpy()
    mov = minmax_normalize_u8(remap_rows(base, dx, dy)).numpy()
    flows, scores, secs = {}, {}, {}
    res = {}
    for name, device in (("cuda", dev), ("cpu", torch.device("cpu"))):
        reg = OptFlowRegistrator(device=device)
        reg.num_pyr_lvl, reg.num_iterations = 3, 3
        reg.tile_size, reg.overlap, reg.band_rows = 500, 100, 256
        reg.use_full_res_img = True
        reg.ref_img, reg.mov_img = ref, mov
        if counters is not None and name == "cuda":
            counters.reset()
        t0 = time.perf_counter()
        flows[name] = reg.register_device().cpu()
        secs[name] = time.perf_counter() - t0
        scores[name] = reg.last_scores
        if counters is not None and name == "cuda":
            res["launches"] = counters.read(label, kernels)
    decisions = {k: [a > b for _, a, b in v] for k, v in scores.items()}
    require(decisions["cuda"] == decisions["cpu"], f"{label}: accept/reject differ: {decisions}")
    err = (flows["cuda"] - flows["cpu"]).abs()
    mean, mx = float(err.mean()), float(err.max())
    log(f"[{label}] {n}^2 register_device: card {secs['cuda']:.2f} s, cpu plain {secs['cpu']:.2f} s; "
        f"accept/reject {decisions['cuda']} on both; flow diff mean {mean:.3e} max {mx:.3e} px")
    require(bool(torch.isfinite(flows["cuda"]).all()), f"{label}: non-finite flow")
    require(mean < 1e-4 and mx < 1e-2, f"{label}: flow diff mean {mean} max {mx}")
    res.update(flow_diff_mean=mean, flow_diff_max=mx, decisions=decisions["cuda"], card_s=secs["cuda"],
               cpu_s=secs["cpu"])
    return res


def unpaired_route(dev, rng, counters: "Counters", stack_planes, n=1024) -> dict:
    """``MICROALIGNER_TPU_PALLAS_POLY=1`` (the JAX package's switch): the
    1024^2 parity pair and the 4096^2 stack's first register go through K6
    (2 launches a Farneback call) instead of K2, and give the default
    route's flow bit for bit."""
    from microaligner_tpu_torch.ops.filters import minmax_normalize_u8
    from microaligner_tpu_torch.optflow.farneback import PALLAS_POLY_ENV
    from microaligner_tpu_torch.optflow.registrator import OptFlowRegistrator
    from microaligner_tpu_torch.utils.pages import max_project_u8

    base = texture(rng, n, n, dev)
    dx, dy = displacement(n, n, 3.0, 0.4, dev, wavelength=400.0)
    pairs = {"1024^2 parity pair": (minmax_normalize_u8(base), minmax_normalize_u8(remap_rows(base, dx, dy)),
                                    dict(num_pyr_lvl=3, tile_size=500, band_rows=256)),
             "4096^2 stack register": (max_project_u8(stack_planes[0][0], dev),
                                       max_project_u8(stack_planes[1][0], dev), dict(num_pyr_lvl=3))}
    res = {}
    launches = {}
    for label, (ref, mov, params) in pairs.items():
        flows = {}
        for route in ("default", "unpaired"):
            reg = OptFlowRegistrator(device=dev)
            reg.num_iterations, reg.overlap, reg.use_full_res_img = 3, 100, True
            for k, v in params.items():
                setattr(reg, k, v)
            reg.ref_img, reg.mov_img = ref, mov
            if route == "unpaired":
                os.environ[PALLAS_POLY_ENV] = "1"
                counters.reset()
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                flows[route] = reg.register_device()
                torch.cuda.synchronize()
                res[f"{label} {route} s"] = time.perf_counter() - t0
            finally:
                os.environ.pop(PALLAS_POLY_ENV, None)
            if route == "unpaired":
                got = counters.read(f"unpaired {label}", ("K1", "K3", "K4", "K5", "K6"))
                require(got["K2"] == 0, f"unpaired {label}: K2 launched {got['K2']} times")
                launches = {k: launches.get(k, 0) + v for k, v in got.items()}
        same = torch.equal(flows["default"], flows["unpaired"])
        log(f"[unpaired] {label}: register default route {res[f'{label} default s']:.3f} s, unpaired route "
            f"{res[f'{label} unpaired s']:.3f} s; flows bit-equal: {same}")
        require(same, f"unpaired {label}: the flow differs from the default route's")
    res["launches"] = launches
    return res


# -- phase 4 ---------------------------------------------------------------

def interior_err(flow, dx, dy, margin):
    sl = (slice(margin, -margin), slice(margin, -margin))
    return float(((flow[..., 0][sl] - dx[sl]).abs() + (flow[..., 1][sl] - dy[sl]).abs()).mean() / 2)


def interior_mse(a, b, margin):
    sl = (slice(margin, -margin), slice(margin, -margin))
    return float(((a[sl].float() - b[sl].float()) ** 2).mean())


def cycle_stack(dev, rng, n=4096, cycles=3, channels=2, zs=3):
    """Host u16 planes [cycle][channel][z] and the known per-cycle warps."""
    textures = [texture(rng, n, n, dev) for _ in range(channels)]
    planes, warps = [], []
    for c in range(cycles):
        dx, dy = displacement(n, n, 0.0 if c == 0 else 2.0 + c, 0.5 * c, dev)
        warps.append((dx, dy))
        per_ch = []
        for t in textures:
            moved = remap_rows(t, dx, dy) if c else t
            per_ch.append([
                torch.clamp(moved * (0.8 + 0.1 * z) * 50000 + 2000, 0, 65535).round()
                .to(torch.uint16).cpu().numpy()
                for z in range(zs)
            ])
        planes.append(per_ch)
    del textures
    return planes, warps


def band_warp_check(label, fn, bands, dev, counters: "Counters", out_bytes=None) -> dict:
    """``fn()``, a one-plane band warp of the main path, launches K5's band
    entry once a band, K1 never and no plain version, and (with
    ``out_bytes``) allocates nothing but its output."""
    before = counters.snapshot()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    fn()
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated(dev) - base
    delta = {k: v - before[k] for k, v in counters.snapshot().items()}
    plain = sum(v for k, v in delta.items() if k.endswith("plain"))
    log(f"[main] {label}: {delta['K5']} K5 band-entry launches for {bands} band(s), K1 {delta['K1']}, plain "
        f"versions {plain}; {extra} bytes allocated at the peak")
    require(delta["K5"] == bands and delta["K1"] == 0 and plain == 0, f"{label}: launches {delta}")
    if out_bytes is not None:
        require(extra <= out_bytes + 2**20, f"{label}: {extra} bytes allocated for a {out_bytes}-byte output")
    return {"launches": delta["K5"], "bands": bands, "peak_extra_bytes": extra}


def profile_register(reg, ref, mov, out_dir: Path) -> dict:
    """One ``register_device`` under ``torch.profiler``: device time by op
    (table written to ``out_dir``) and the device's busy share of the wall."""
    from torch.profiler import ProfilerActivity, profile

    reg.ref_img, reg.mov_img = ref, mov
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        reg.register_device()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))

    # device-side rows only: an op's row repeats the time of the kernels it launched
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(dev_us(e) for e in kernels) / 1e6
    top = sorted(kernels, key=dev_us, reverse=True)[:12]
    (out_dir / "profile_register.txt").write_text(
        events.table(sort_by="self_cuda_time_total", row_limit=40))
    log(f"[profile] register_device {tuple(ref.shape)}: wall {wall:.3f} s, device busy {busy:.3f} s "
        f"({100 * busy / wall:.1f}%)")
    for e in top:
        log(f"[profile]   {dev_us(e) / 1e3:9.2f} ms  x{e.count:<5d} {e.key[:90]}")
    return {"wall_s": wall, "device_busy_s": busy,
            "top": [(e.key, dev_us(e) / 1e3, e.count) for e in top]}


def main_path(dev, rng, out_dir: Path, counters: Counters, n_stack=4096, n_big=20480, tile=1000,
              overlap=100):
    """PR 1's path; returns its report and the host planes of the 4096^2
    stack [cycle][channel][z], which the CLI phase writes to a file."""
    from microaligner_tpu_torch.ops.filters import minmax_normalize_u8
    from microaligner_tpu_torch.optflow.registrator import OptFlowRegistrator
    from microaligner_tpu_torch.optflow.warper import Warper
    from microaligner_tpu_torch.pipeline.runner import _apply_flow_plane
    from microaligner_tpu_torch.tiles import TileGrid
    from microaligner_tpu_torch.utils.pages import max_project_u8

    # defaults: config_examples/config_cycle_stack_optflow_only.yaml

    def registrator():
        reg = OptFlowRegistrator(device=dev)
        reg.num_pyr_lvl, reg.num_iterations = 3, 3
        reg.tile_size, reg.overlap = tile, overlap
        reg.use_full_res_img, reg.use_dog = True, False
        return reg

    def sync_time(t0):
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    planes, warps = cycle_stack(dev, rng, n_stack)
    log(f"[main] synthetic 3x2x3 u16 {n_stack}^2 stack made in {time.perf_counter() - t0:.2f} s")

    counters.reset()
    torch.cuda.reset_peak_memory_stats(dev)
    report = {"stack_4096": []}

    # the CLI loop of pipeline/runner.py: cycle 0 is the reference
    warper = Warper(device=dev)
    warper.tile_size, warper.overlap = tile, overlap
    reg = registrator()
    t_all = time.perf_counter()
    ref_img = max_project_u8(planes[0][0], dev)
    ref0 = ref_img
    for c in range(1, len(planes)):
        stage = {"cycle": c}
        t0 = time.perf_counter()
        mov_img = max_project_u8(planes[c][0], dev)
        stage["project_s"] = sync_time(t0)
        reg.ref_img, reg.mov_img = ref_img, mov_img
        t0 = time.perf_counter()
        flow = reg.register_device()
        stage["register_s"] = sync_time(t0)
        warper.image, warper.flow = mov_img, flow
        t0 = time.perf_counter()
        ref_img = warper.warp_device()
        stage["warp_ref_s"] = sync_time(t0)
        grid = TileGrid.for_image(tuple(flow.shape[:2]), tile, overlap)
        t0 = time.perf_counter()
        applied = []
        for ch in planes[c]:
            for plane in ch:
                out = _apply_flow_plane(torch.from_numpy(plane).to(dev), flow, grid, torch.uint16)
                applied.append(out.cpu().numpy())  # the CLI writes each plane to disk
        stage["apply_6_planes_s"] = sync_time(t0)
        # correctness: the known warp is recovered, the projection and the
        # channel-1 planes line up with cycle 0
        require(flow.shape == (n_stack, n_stack, 2) and bool(torch.isfinite(flow).all()),
                f"flow {tuple(flow.shape)} not finite or of the wrong shape")
        stage["flow_err_px"] = interior_err(flow, *warps[c], 200)
        before = interior_mse(mov_img, ref0, 200)
        after = interior_mse(ref_img, ref0, 200)
        ch1_before = interior_mse(torch.from_numpy(planes[c][1][2].astype(np.float32)),
                                  torch.from_numpy(planes[0][1][2].astype(np.float32)), 200)
        ch1_after = interior_mse(torch.from_numpy(applied[5].astype(np.float32)),
                                 torch.from_numpy(planes[0][1][2].astype(np.float32)), 200)
        stage.update(proj_mse_before=before, proj_mse_after=after,
                     ch1_mse_before=ch1_before, ch1_mse_after=ch1_after,
                     gate=[(f, a > b) for f, a, b in reg.last_scores])
        log(f"[main] {n_stack}^2 cycle {c}: project {stage['project_s']:.3f} s, register "
            f"{stage['register_s']:.3f} s, warp ref {stage['warp_ref_s']:.3f} s, apply 6 u16 planes "
            f"{stage['apply_6_planes_s']:.3f} s; flow err {stage['flow_err_px']:.4f} px; "
            f"proj mse {before:.1f} -> {after:.1f}; ch1 mse {ch1_before:.0f} -> {ch1_after:.0f}; "
            f"gate {stage['gate']}")
        require(stage["flow_err_px"] < 0.25, stage)
        require(after < 0.25 * before and ch1_after < 0.25 * ch1_before, stage)
        report["stack_4096"].append(stage)
    report["stack_4096_total_s"] = sync_time(t_all)
    report["stack_4096_peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    log(f"[main] {n_stack}^2 stack: {report['stack_4096_total_s']:.2f} s for 2 registered cycles, "
        f"peak device memory {report['stack_4096_peak_gib']:.2f} GiB")
    # the one-plane band warps of the path: one K5 launch a band, nothing allocated but the output
    from microaligner_tpu_torch.optflow.flow_calc import band_rows_for, calc_flow_and_warp_dense_banded

    grid = TileGrid.for_image((n_stack, n_stack), tile, overlap)
    bands = -(-n_stack // band_rows_for(grid))
    plane = torch.from_numpy(planes[1][1][0]).to(dev)

    def warp_device():
        warper.image, warper.flow = plane, flow
        return warper.warp_device()

    report["band_warps"] = {
        "Warper.warp_device": band_warp_check("Warper.warp_device", warp_device, bands, dev, counters, 2 * n_stack**2),
        "_apply_flow_plane": band_warp_check("_apply_flow_plane", lambda: _apply_flow_plane(plane, flow, grid, torch.uint16),
                                             bands, dev, counters, 2 * n_stack**2),
        "post-warp, band_rows 1024": band_warp_check(
            "banded Farneback's post-warp, band_rows 1024",
            lambda: calc_flow_and_warp_dense_banded(ref0, mov_img, plane, grid, 51, 1, torch.uint16, 1024),
            4, dev, counters)}
    del plane
    report["profile_4096"] = profile_register(
        registrator(), ref0, max_project_u8(planes[1][0], dev), out_dir)
    del applied, ref_img, ref0, flow

    n = n_big
    t0 = time.perf_counter()
    base = texture(rng, n, n, dev)
    dx, dy = displacement(n, n, 3.0, 0.3, dev, wavelength=2000.0)
    ref = minmax_normalize_u8(base)
    mov_f = remap_rows(base, dx, dy)
    mov = minmax_normalize_u8(mov_f)
    plane = torch.clamp(mov_f * 60000 + 1000, 0, 65535).round().to(torch.uint16).cpu().numpy()
    del base, mov_f
    log(f"[main] {n}^2 pair and u16 plane made in {sync_time(t0):.2f} s")
    torch.cuda.reset_peak_memory_stats(dev)
    reg = registrator()
    reg.ref_img, reg.mov_img = ref, mov
    t0 = time.perf_counter()
    flow = reg.register_device()
    reg_s = sync_time(t0)
    warper.image, warper.flow = mov, flow
    t0 = time.perf_counter()
    warped = warper.warp_device()
    warp_s = sync_time(t0)
    t0 = time.perf_counter()
    grid = TileGrid.for_image((n, n), tile, overlap)
    applied = _apply_flow_plane(torch.from_numpy(plane).to(dev), flow, grid, torch.uint16).cpu()
    apply_s = sync_time(t0)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    require(flow.shape == (n, n, 2) and bool(torch.isfinite(flow).all()),
            f"flow {tuple(flow.shape)} not finite or of the wrong shape")
    err = interior_err(flow, dx, dy, 500)
    before, after = interior_mse(mov, ref, 500), interior_mse(warped, ref, 500)
    report["register_20480"] = dict(register_s=reg_s, warp_s=warp_s, apply_1_plane_s=apply_s,
                                    peak_gib=peak, flow_err_px=err, mse_before=before,
                                    mse_after=after, gate=[(f, a > b) for f, a, b in reg.last_scores])
    log(f"[main] {n}^2 u8 register {reg_s:.2f} s, warp {warp_s:.2f} s, apply 1 u16 plane "
        f"{apply_s:.2f} s; peak device memory {peak:.2f} GiB; flow err {err:.4f} px; "
        f"mse {before:.1f} -> {after:.1f}; gate {report['register_20480']['gate']}")
    require(err < 0.25 and after < 0.25 * before, report["register_20480"])
    require(applied.dtype == torch.uint16, applied.dtype)
    del flow, warped, applied, ref, mov

    report["launches"] = counters.read("main", ("K1", "K2", "K3", "K4", "K5"))
    return report, planes


# -- phase 5 ---------------------------------------------------------------

ZSTACK_DTYPES = (torch.uint16, torch.uint8, torch.int16, torch.float32)  # u16: the bench's


def zstack_apply(dev, rng, counters: Counters, n=4096, n_planes=8, tile=1000, overlap=100) -> dict:
    """Config 4 of the JAX package's bench (``bench.py::bench_zstack_apply``):
    8 4096^2 planes on the card warped by one flow through
    ``_apply_flow_planes``, one K5 launch a band (``sample_band_multi``)
    that reads the stored planes and writes the rounded result, for u16
    (the bench's), u8, i16 and f32 stacks; each held bit for bit against
    the band entry's plain version on the card and ``_apply_flow_plane`` on
    each plane (K5 at one plane).  Every K5 launch of the paths is this
    wrapper's, so
    K5's entry of the ``kernels`` line is its u16 launches, timed here
    against the plain version and against the bound (stored planes read
    once and written once, the flow read once); the f32 stack's launches
    are timed against ``F.grid_sample`` on the same planes."""
    from microaligner_tpu_torch.ops import kernel_sample as ks
    from microaligner_tpu_torch.optflow.flow_calc import band_rows_for
    from microaligner_tpu_torch.pipeline.runner import _apply_flow_plane, _apply_flow_planes
    from microaligner_tpu_torch.tiles import TileGrid

    base = torch.from_numpy(rng.integers(0, 65535, (n_planes, n, n)).astype(np.uint16)).to(dev)
    wide = base.to(torch.int32)
    stacks = {torch.uint16: base, torch.uint8: (wide % 256).to(torch.uint8),
              torch.int16: (wide - 32768).to(torch.int16), torch.float32: wide.to(torch.float32) / 65535}
    del wide
    flow = torch.stack(smooth_flow(n, n, dev), dim=-1).contiguous()
    grid = TileGrid.for_image((n, n), tile, overlap)
    rows = band_rows_for(grid)
    bands = -(-n // rows)

    def per_plane(planes, dt):
        return torch.stack([_apply_flow_plane(p, flow, grid, dt) for p in planes])

    def band_entry(fn, planes, out):
        for row0 in range(0, n, rows):
            fn(planes, flow, out, row0, rows, overlap)
        return out

    counters.reset()
    outs = {dt: _apply_flow_planes(planes, flow, grid, dt) for dt, planes in stacks.items()}
    torch.cuda.synchronize()
    launches = counters.read("zstack", ("K5",))
    require(launches["K1"] == 0, f"zstack: the z-stack apply launched K1 {launches['K1']} times")
    require(launches["K5"] == bands * len(stacks),
            f"zstack: {launches['K5']} K5 launches for {len(stacks)} stacks of {bands} band(s)")
    err = 0.0
    for dt, planes in stacks.items():
        multi = outs[dt]
        require(multi.dtype == dt and multi.shape == planes.shape, f"{multi.dtype} {tuple(multi.shape)}")
        want = band_entry(ks.sample_band_multi_plain, planes, torch.empty_like(planes))
        err = max(err, float((multi.to(torch.float64) - want.to(torch.float64)).abs().max()))
        require(torch.equal(multi, want), f"z-stack apply, {dt}: K5 and its plain version differ")
        del want
        require(torch.equal(multi, per_plane(planes, dt)), f"z-stack apply, {dt}: the stack and the apply a plane differ")
    del outs
    res = {"launches": launches, "bands": bands, "apply_ms": {}}
    for dt, planes in stacks.items():
        res["apply_ms"][str(dt)] = min(cuda_ms(lambda: _apply_flow_planes(planes, flow, grid, dt), 5)
                                       for _ in range(2))
    # u16: order plain, K5, per-plane, K5, per-plane, plain
    planes, out = stacks[torch.uint16], torch.empty_like(stacks[torch.uint16])
    p1 = cuda_ms(lambda: band_entry(ks.sample_band_multi_plain, planes, out), 3)
    k_1, t1 = cuda_ms(lambda: band_entry(ks.sample_band_multi, planes, out), 20), cuda_ms(
        lambda: per_plane(planes, torch.uint16), 5)
    k_2, t2 = cuda_ms(lambda: band_entry(ks.sample_band_multi, planes, out), 20), cuda_ms(
        lambda: per_plane(planes, torch.uint16), 5)
    p2 = cuda_ms(lambda: band_entry(ks.sample_band_multi_plain, planes, out), 3)
    # f32 stack against grid_sample on the same planes (a pull: taps at p - flow)
    planes, out = stacks[torch.float32], torch.empty_like(stacks[torch.float32])
    f32_ms = cuda_ms(lambda: band_entry(ks.sample_band_multi, planes, out), 20)
    grid_s = sample_grid(-flow[None, ..., 0], -flow[None, ..., 1])
    lib_f32 = cuda_ms(lambda: grid_sample_call(planes[None], grid_s), 20)
    del grid_s, out
    bound, by = band_entry_bound(n_planes, n * n, 2)
    res["band_entry"] = {"max_abs_err": err, "ms": min(k_1, k_2), "plain_ms": min(p1, p2), "bound_ms": bound,
                         "bound_by": by, "library_ms": None, "f32_ms": f32_ms, "f32_library_ms": lib_f32}
    res["per_plane_ms"] = min(t1, t2)
    b = res["band_entry"]
    log(f"[zstack] {n_planes} u16 {n}^2 planes, one flow, tile {tile} overlap {overlap}, {bands} band(s): "
        f"sample_band_multi (K5) {b['ms']:.4f} ms ({100 * b['bound_ms'] / b['ms']:.0f}% of its "
        f"{b['bound_ms']:.4f} ms bound, {b['bound_by']}), plain {b['plain_ms']:.3f} ms, _apply_flow_plane a plane "
        f"{res['per_plane_ms']:.3f} ms; _apply_flow_planes u16, u8, i16, f32 "
        f"{', '.join(f'{v:.4f}' for v in res['apply_ms'].values())} ms; f32 stack's band entry {f32_ms:.4f} ms, "
        f"grid_sample {lib_f32:.4f} ms; all bit-equal to the plain version and to the apply a plane")
    return res


# -- phase 6 ---------------------------------------------------------------

def stack_ome(channels, h, w, nz) -> str:
    chs = "".join(f'<Channel ID="Channel:0:{i}" Name="{n}" SamplesPerPixel="1"/>'
                  for i, n in enumerate(channels))
    return ('<?xml version="1.0" encoding="UTF-8"?>'
            '<OME xmlns="http://www.openmicroscopy.org/Schemas/OME/2016-06"><Image ID="Image:0" Name="s">'
            f'<Pixels ID="Pixels:0" DimensionOrder="XYZCT" Type="uint16" SizeT="1" SizeC="{len(channels)}" '
            f'SizeZ="{nz}" SizeY="{h}" SizeX="{w}" PhysicalSizeX="0.5" PhysicalSizeXUnit="um" '
            'PhysicalSizeY="0.5" PhysicalSizeYUnit="um">' + chs + "</Pixels></Image></OME>")


def write_cycle_stack(path: Path, planes) -> None:
    """planes[cycle][channel][z] (host u16) as one OME CycleStack, written
    with the port's ``MemmapWriter``; channels are named ``cNN DAPI`` and
    ``cNN Cy5``."""
    from microaligner_tpu_torch.io import MemmapWriter

    cycles, channels, nz = len(planes), len(planes[0]), len(planes[0][0])
    h, w = planes[0][0][0].shape
    names = [f"c{c + 1:02d} {('DAPI', 'Cy5', 'FITC')[ch]}" for c in range(cycles) for ch in range(channels)]
    mm = MemmapWriter(path, (1, cycles * channels, nz, h, w), np.uint16,
                      description=stack_ome(names, h, w, nz))
    for c in range(cycles):
        for ch in range(channels):
            for z in range(nz):
                mm[0, c * channels + ch, z] = planes[c][ch][z]
    mm.close()


def run_cli_in_process(cfg: Path, dev, output: list | None = None) -> tuple:
    """``__main__.main([cfg])`` on ``dev`` with the stage timers on; returns
    (wall seconds, {stage: seconds}) and appends the CLI's printed lines to
    ``output`` when given."""
    from microaligner_tpu_torch.__main__ import main as cli_main

    buf = io.StringIO()
    os.environ["MICROALIGNER_TPU_PROFILE"] = "1"
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            cli_main([str(cfg)], device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        os.environ.pop("MICROALIGNER_TPU_PROFILE", None)
    if output is not None:
        output.append(buf.getvalue())
    stages = {}
    for name, secs in re.findall(r"^\[profile\] (.+): ([0-9.]+)s$", buf.getvalue(), re.M):
        stages[name] = round(stages.get(name, 0.0) + float(secs), 4)
    return wall, stages


def cli_4096(dev, planes, counters: Counters, work: Path) -> dict:
    stack, out1, out2 = work / "stack_4096.ome.tif", work / "out_4096", work / "out_4096_subprocess"
    write_cycle_stack(stack, planes)
    for cfg, out in (("cfg_4096.yaml", out1), ("cfg_4096_subprocess.yaml", out2)):
        write_named_config(work / cfg, "config_cycle_stack_optflow_only.yaml", {"CycleStack": str(stack)}, out)
    torch.cuda.reset_peak_memory_stats(dev)
    counters.reset()
    wall, stages = run_cli_in_process(work / "cfg_4096.yaml", dev)
    launches = counters.read("cli_4096", ("K1", "K2", "K3", "K4", "K5"))
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    res = check_stage_output(out1 / "optflow_reg_result_stack.tif", planes, planes[0], 200, "cli 4096", dev,
                             mse_bar=0.25)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "microaligner_tpu_torch", str(work / "cfg_4096_subprocess.yaml")],
                          cwd=ROOT, capture_output=True, text=True, timeout=600)
    sub_wall = time.perf_counter() - t0
    require(proc.returncode == 0, f"python -m microaligner_tpu_torch exited {proc.returncode}:\n{proc.stderr[-3000:]}")
    same = (out1 / "optflow_reg_result_stack.tif").read_bytes() == (out2 / "optflow_reg_result_stack.tif").read_bytes()
    require(same, "the CLI in a subprocess wrote another file than in process")
    res.update(wall_s=wall, stages_s=stages, subprocess_wall_s=sub_wall, peak_gib=peak, launches=launches)
    log(f"[cli] 4096^2 3 cycles x 2 ch x 3 z u16 CycleStack: in process {wall:.2f} s (stage timers on), "
        f"peak device memory {peak:.2f} GiB, "
        f"python -m {sub_wall:.2f} s (process start and build check included), same output file; "
        f"stages {stages}; registered mse / unregistered mse <= {res['mse_ratio_max']:.4f}")
    return res


def cli_20480(dev, rng, counters: Counters, n=20480) -> dict:
    """Config 5b's data shape (``bench.py::bench_20k_cli``): a 2-cycle x
    2-channel x 1-z u16 CycleStack through the CLI, in a temporary
    directory deleted afterwards."""
    work = Path(tempfile.mkdtemp(prefix="ma_chip_smoke_20k_"))
    try:
        free = shutil.disk_usage(work).free
        require(free > 10 * 2**30, f"{free / 2**30:.1f} GiB free in {work}; the 20480^2 CLI needs 10")
        t0 = time.perf_counter()
        base = texture(rng, n, n, dev)
        dx, dy = displacement(n, n, 3.0, 0.3, dev, wavelength=2000.0)
        moved = remap_rows(base, dx, dy)
        del dx, dy

        def u16(x):
            return torch.clamp(x * 60000 + 1000, 0, 65535).round().to(torch.uint16).cpu().numpy()

        dapi = [u16(base), u16(moved)]
        del base, moved
        planes = [[[dapi[c]], [dapi[c] // 3]] for c in range(2)]
        stack = work / "stack.ome.tif"
        write_cycle_stack(stack, planes)
        write_named_config(work / "cfg.yaml", "config_cycle_stack_optflow_only.yaml", {"CycleStack": str(stack)},
                           work / "out")
        log(f"[cli] {n}^2 2 cycles x 2 ch x 1 z u16 CycleStack made and written in "
            f"{time.perf_counter() - t0:.2f} s")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        counters.reset()
        wall, stages = run_cli_in_process(work / "cfg.yaml", dev)
        launches = counters.read("cli_20480", ("K1", "K2", "K3", "K4", "K5"))
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        pinned = torch.cuda.host_memory_stats().get("allocated_bytes.peak", 0)
        margin = max(64, n // 40)  # 512 px at 20480^2, as bench.py's config 5b
        res = check_stage_output(work / "out" / "optflow_reg_result_stack.tif", planes, planes[0], margin,
                                 "cli 20480", dev, mse_bar=0.25)
        res.update(wall_s=wall, stages_s=stages, peak_gib=peak, pinned_host_bytes=pinned,
                   launches=launches)
        log(f"[cli] {n}^2 CLI in process {wall:.2f} s (stage timers on), peak device memory {peak:.2f} GiB, "
            f"pinned host bytes {pinned}; stages {stages}; registered mse / unregistered mse <= "
            f"{res['mse_ratio_max']:.4f}")
        return res
    finally:
        shutil.rmtree(work, ignore_errors=True)


# -- phases 7-9 ------------------------------------------------------------

def warp_affine_scipy(img: np.ndarray, fwd, out_shape=None) -> np.ndarray:
    """``cv.warpAffine(img, fwd)``: out(q) = img(fwd^-1 q), bilinear, zero
    outside, with ``scipy.ndimage.affine_transform`` (order 1), in row
    chunks on threads.  An independent warp for the synthetic data."""
    import scipy.ndimage as ndi

    inv = np.linalg.inv(np.vstack([np.asarray(fwd, np.float64), [0.0, 0.0, 1.0]]))[:2]
    mat = np.array([[inv[1, 1], inv[1, 0]], [inv[0, 1], inv[0, 0]]])  # (row, col) order
    off = np.array([inv[1, 2], inv[0, 2]])
    h, w = out_shape or img.shape
    src = np.ascontiguousarray(img, dtype=np.float32)

    def part(r0):
        r1 = min(h, r0 + 1024)
        return ndi.affine_transform(src, mat, offset=off + mat @ np.array([r0, 0.0]),
                                    output_shape=(r1 - r0, w), order=1, mode="constant", cval=0.0)

    with ThreadPoolExecutor(os.cpu_count() or 1) as ex:
        return np.concatenate(list(ex.map(part, range(0, h, 1024))))


def rotation_fwd(h, w, degrees, shift) -> np.ndarray:
    """Forward 2x3 (x, y) matrix: rotation about the image centre by
    ``degrees`` (counter-clockwise on screen, as cv.getRotationMatrix2D),
    then ``shift``."""
    a, b = math.cos(math.radians(degrees)), math.sin(math.radians(degrees))
    cx, cy = w / 2.0, h / 2.0
    return np.array([[a, b, (1 - a) * cx - b * cy + shift[0]],
                     [-b, a, b * cx + (1 - a) * cy + shift[1]]])


def corner_err(tmat, want, shape) -> float:
    h, w = shape
    pts = np.array([[0, 0, 1], [w - 1, 0, 1], [0, h - 1, 1], [w - 1, h - 1, 1]], float).T
    return float(np.abs(np.asarray(tmat) @ pts - np.asarray(want) @ pts).max())


def inverse2x3(fwd) -> np.ndarray:
    return np.linalg.inv(np.vstack([np.asarray(fwd, np.float64), [0.0, 0.0, 1.0]]))[:2]


def feature_pairs(dev, rng, counters: "Counters", sizes=(4096, 20480), cpu_pairs=2) -> dict:
    """Config 1 of the JAX package's bench (``bench.py::bench_feature``):
    ``FeatureRegistrator`` (3 levels [8, 4, 2], 3 iterations, tile 1000,
    DoG) on 4096^2 u8 pairs moved by ``t_true``, ``cpu_pairs`` textures,
    each on the card and on the CPU; then a 20480^2 pair on the card with
    the stage timers on (each level's find, match, RANSAC and gate)."""
    from microaligner_tpu_torch.features import FeatureRegistrator
    from microaligner_tpu_torch.ops.filters import minmax_normalize_u8

    t_true = np.array([[1.0004, 0.0003, 6.4], [-0.0003, 1.0004, -9.1]])
    truth = inverse2x3(t_true)  # register() maps mov coords to ref coords
    res, launches = {}, []
    cases = [(sizes[0], p) for p in range(cpu_pairs)] + [(n, 0) for n in sizes[1:]]
    for n, pair in cases:
        key = f"{n}" if pair == 0 else f"{n}_pair{pair + 1}"
        t0 = time.perf_counter()
        ref = minmax_normalize_u8(texture(rng, n, n, dev)).cpu().numpy()
        mov = np.clip(np.round(warp_affine_scipy(ref, t_true)), 0, 255).astype(np.uint8)
        log(f"[feature] {key}: {n}^2 u8 pair made in {time.perf_counter() - t0:.2f} s")
        runs = {}
        for where in (("cuda", "cpu") if n == sizes[0] else ("cuda",)):
            reg = FeatureRegistrator(device=dev if where == "cuda" else "cpu")
            reg.num_pyr_lvl, reg.num_iterations, reg.tile_size, reg.use_dog = 3, 3, 1000, True
            reg.ref_img, reg.mov_img = ref, mov
            profile = where == "cuda" and n != sizes[0]
            if where == "cuda":
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(dev)
                counters.reset()
            buf = io.StringIO()
            if profile:
                os.environ["MICROALIGNER_TPU_PROFILE"] = "1"
            try:
                with contextlib.redirect_stdout(buf):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    runs[where] = reg.register()
                    torch.cuda.synchronize()
                    secs = time.perf_counter() - t0
            finally:
                os.environ.pop("MICROALIGNER_TPU_PROFILE", None)
            res[f"{key}_{where}_s"] = secs
            if where == "cuda":
                res[f"{key}_peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
                launches.append(counters.read(f"feature_{key}", ("K1",)))
            if profile:
                stages = {}
                for name, t in re.findall(r"^\[profile\] (.+): ([0-9.]+)s$", buf.getvalue(), re.M):
                    stages[name] = round(stages.get(name, 0.0) + float(t), 4)
                res[f"{key}_stages_s"] = stages
                log(f"[feature] {key} stage timers (summed over the iterations): {stages}")
        err_truth = corner_err(runs["cuda"], truth, (n, n))
        res[f"{key}_tmat"] = runs["cuda"].tolist()
        res[f"{key}_truth_err_px"] = err_truth
        line = (f"[feature] {key}: FeatureRegistrator on the card {res[f'{key}_cuda_s']:.2f} s, peak device "
                f"memory {res[f'{key}_peak_gib']:.2f} GiB; corners vs truth {err_truth:.4f} px")
        if "cpu" in runs:
            res[f"{key}_card_vs_cpu_px"] = corner_err(runs["cuda"], runs["cpu"], (n, n))
            line += f"; CPU run {res[f'{key}_cpu_s']:.2f} s, card vs CPU {res[f'{key}_card_vs_cpu_px']:.2e} px"
        log(line)
        require(err_truth < 0.5, f"feature {key}: {err_truth} px from the truth")
        if "cpu" in runs:
            require(res[f"{key}_card_vs_cpu_px"] < 1e-3, f"feature {key}: card vs CPU {res[f'{key}_card_vs_cpu_px']} px")
        del ref, mov
    res["launches"] = {k: sum(run[k] for run in launches) for k in launches[0]}
    return res


def smooth_displacement(n, dev, amp=1.0, periods=2):
    """An even cosine field of whole periods about the centre: no affine
    part, so FeatureReg's fit is the affine alone and OptFlowReg removes
    this."""
    c = (torch.arange(n, device=dev, dtype=torch.float32) - n / 2.0) * (2 * math.pi * periods / n)
    return (amp * torch.cos(c).view(n, 1).expand(n, n).contiguous(),
            0.7 * amp * torch.cos(c).view(1, n).expand(n, n).contiguous())


def moved_texture(tex: torch.Tensor, fwd, dev) -> torch.Tensor:
    """``tex`` moved by the forward affine ``fwd`` (scipy), then pulled by
    the smooth displacement (the plain gather), on ``dev``, in [0, 1]."""
    n = tex.shape[0]
    aff = torch.from_numpy(warp_affine_scipy(tex.cpu().numpy(), fwd)).to(dev)
    dx, dy = smooth_displacement(n, dev)
    return remap_rows(aff, dx, dy)


def write_cycle_files(work: Path, planes) -> dict:
    """One OME-TIFF a cycle ([channel][z] u16 planes), channels DAPI, Cy5."""
    from microaligner_tpu_torch.io import MemmapWriter

    paths = {}
    for c, per_ch in enumerate(planes):
        nch, nz = len(per_ch), len(per_ch[0])
        h, w = per_ch[0][0].shape
        path = work / f"cycle{c + 1}.ome.tif"
        mm = MemmapWriter(path, (1, nch, nz, h, w), np.uint16,
                          description=stack_ome(["DAPI", "Cy5", "FITC"][:nch], h, w, nz))
        for ch in range(nch):
            for z in range(nz):
                mm[0, ch, z] = per_ch[ch][z]
        mm.close()
        paths[f"Cycle {c + 1}"] = str(path)
    return paths


def write_named_config(path: Path, example: str, inputs: dict, out_dir: Path) -> dict:
    import yaml

    cfg = yaml.safe_load((ROOT / "config_examples" / example).read_text())
    cfg["Input"]["InputImagePaths"] = inputs
    cfg["Output"]["OutputDir"] = str(out_dir)
    path.write_text(yaml.dump(cfg, sort_keys=False))
    return cfg


def check_stage_output(path: Path, planes, ref_planes, margin: int, label: str, dev, mse_bar=None) -> dict:
    """One stage's TCZYX stack: shape, dtype and OME sizes; the reference
    cycle equal to ``ref_planes`` bit for bit; with ``mse_bar``, every other
    plane's interior MSE to the reference below ``mse_bar`` times its
    unregistered MSE.  ``planes[cycle][channel][z]`` are the inputs at the
    output's size."""
    from microaligner_tpu_torch.io import TiffFile
    from microaligner_tpu_torch.io.ome import extract_pixels_info, str_to_xml

    cycles, channels, nz = len(planes), len(planes[0]), len(planes[0][0])
    h, w = planes[0][0][0].shape
    res = {"ratios": []}
    with TiffFile(path) as tf:
        s = tf.series[0]
        info = extract_pixels_info(str_to_xml(tf.ome_metadata))
        want_shape = (cycles * channels, nz, h, w) if nz > 1 else (cycles * channels, h, w)
        require(s.shape == want_shape and s.dtype == np.uint16, f"{label}: {s.shape} {s.dtype}")
        require((int(info["SizeC"]), int(info["SizeZ"]), int(info["SizeT"]), int(info["SizeY"]),
                 int(info["SizeX"])) == (cycles * channels, nz, 1, h, w), f"{label}: OME sizes {info}")
        for c in range(cycles):
            for ch in range(channels):
                for z in range(nz):
                    page = tf.read_page((c * channels + ch) * nz + z)
                    if c == 0:
                        require(np.array_equal(page, ref_planes[ch][z]), f"{label}: reference plane {ch},{z} changed")
                        continue
                    if mse_bar is None:
                        continue
                    sl = (slice(margin, -margin), slice(margin, -margin))
                    ref = torch.from_numpy(ref_planes[ch][z][sl]).to(dev).float()
                    before = float(((torch.from_numpy(planes[c][ch][z][sl]).to(dev).float() - ref) ** 2).mean())
                    after = float(((torch.from_numpy(page[sl]).to(dev).float() - ref) ** 2).mean())
                    res["ratios"].append(after / before)
                    require(after < mse_bar * before, f"{label}: cycle {c + 1} ch {ch} z {z} mse {before} -> {after}")
    res["mse_ratio_max"] = max(res["ratios"]) if res["ratios"] else None
    res["tczyx"] = (1, cycles * channels, nz, h, w)
    return res


def check_csv(path: Path, truths: dict, shape, paddings: dict) -> dict:
    """``feature_reg_parameters.csv``: one row a cycle with its padding and
    the output size; each matrix within 0.5 px of ``truths[cycle]`` at the
    corners."""
    import csv

    with open(path, newline="") as fh:
        rows = list(csv.reader(fh))
    require(rows[0] == ["name", "0", "1", "2", "3", "4", "5", "left", "right", "top", "bottom", "width",
                        "height"], f"CSV header {rows[0]}")
    errs = {}
    for row in rows[1:]:
        cyc = int(row[0].split()[1])
        require(row[7:] == [str(v) for v in paddings[cyc]] + [str(shape[1]), str(shape[0])], f"CSV row {row}")
        errs[cyc] = corner_err(np.array(row[1:7], float).reshape(2, 3), truths[cyc], shape)
        require(errs[cyc] < 0.5, f"CSV cycle {cyc}: {errs[cyc]} px from the truth")
    require(sorted(errs) == sorted(truths), f"CSV cycles {sorted(errs)}")
    return errs


def chained_cli(dev, rng, counters: "Counters", n: int, big: bool) -> dict:
    """``config_with_all_info.yaml``'s two stages through the CLI in
    process: 3 cycles x 2 channels x 3 z, one file a cycle, or (``big``)
    2 x 2 x 1 in one CycleStack.  Cycle 2 (and 3) moved by an affine plus a
    1 px smooth displacement."""
    cycles, channels, zs = (2, 2, 1) if big else (3, 2, 3)
    moves = {2: rotation_fwd(n, n, 0.3, (37.4, -21.7)), 3: rotation_fwd(n, n, -0.2, (-12.3, 8.8))}
    work = Path(tempfile.mkdtemp(prefix=f"ma_chip_smoke_chained_{n}_"))
    try:
        free = shutil.disk_usage(work).free
        need = (12 if big else 2) * 2**30
        if free < need:
            raise CheckFailed(f"{free / 2**30:.1f} GiB free in {work}; the {n}^2 chained CLI needs "
                              f"{need / 2**30:.0f}")
        t0 = time.perf_counter()
        textures = [texture(rng, n, n, dev) for _ in range(1 if big else channels)]

        def u16(x, z):
            return torch.clamp(x * (0.8 + 0.1 * z) * 50000 + 2000, 0, 65535).round().to(torch.uint16).cpu().numpy()

        planes = []
        for c in range(cycles):
            per_ch = []
            for ch in range(channels):
                tex = textures[min(ch, len(textures) - 1)]
                moved = tex if c == 0 else moved_texture(tex, moves[c + 1], dev)
                zplanes = [u16(moved, z) for z in range(zs)]
                per_ch.append([p // 3 for p in zplanes] if big and ch == 1 else zplanes)
                del moved
            planes.append(per_ch)
        del textures
        if big:
            stack = work / "stack.ome.tif"
            write_cycle_stack(stack, planes)
            inputs = {"CycleStack": str(stack)}
        else:
            inputs = write_cycle_files(work, planes)
        cfg = write_named_config(work / "cfg.yaml", "config_with_all_info.yaml", inputs, work / "out")
        log(f"[chained] {n}^2 {cycles} cycles x {channels} ch x {zs} z u16 made and written in "
            f"{time.perf_counter() - t0:.2f} s")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        counters.reset()
        wall, stages = run_cli_in_process(work / "cfg.yaml", dev)
        launches = counters.read(f"chained_{n}", ("K1", "K2", "K3", "K4", "K5"))
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        pinned = torch.cuda.host_memory_stats().get("allocated_bytes.peak", 0)
        prefix = cfg["Output"]["OutputPrefix"]
        out = work / "out"
        margin = min(max(200, n // 40), n // 8)
        freg = check_stage_output(out / f"{prefix}feature_reg_result_stack.tif", planes, planes[0], margin,
                                  f"chained {n} FeatureReg", dev)
        ofreg = check_stage_output(out / f"{prefix}optflow_reg_result_stack.tif", planes, planes[0], margin,
                                   f"chained {n} OptFlowReg", dev, mse_bar=0.25)
        truths = {1: np.eye(2, 3), **{c: inverse2x3(moves[c]) for c in range(2, cycles + 1)}}
        errs = check_csv(out / "feature_reg_parameters.csv", truths, (n, n),
                         {c: (0, 0, 0, 0) for c in range(1, cycles + 1)})
        res = dict(wall_s=wall, stages_s=stages, peak_gib=peak, pinned_host_bytes=pinned, launches=launches,
                   affine_err_px=errs, mse_ratio_max=ofreg["mse_ratio_max"], tczyx=ofreg["tczyx"],
                   feature_tczyx=freg["tczyx"])
        log(f"[chained] {n}^2 CLI (FeatureReg + OptFlowReg) in process {wall:.2f} s (stage timers on), peak "
            f"device memory {peak:.2f} GiB, pinned host bytes {pinned}; stages {stages}; affine vs truth "
            f"{errs} px; registered mse / unregistered mse <= {ofreg['mse_ratio_max']:.4f}")
        return res
    finally:
        shutil.rmtree(work, ignore_errors=True)


def auto_feature_pass(dev, rng, counters: "Counters", h=4096) -> dict:
    """An OptFlowReg-only config (``config_cycle_stack_optflow_only.yaml``'s
    parameters) over per-cycle images of h x h and (h - 96) x (h + 4)
    (4096 x 4096 and 4000 x 4100): the CLI runs FeatureReg first and pads
    both to h x (h + 4)."""
    w = h + 4
    work = Path(tempfile.mkdtemp(prefix="ma_chip_smoke_auto_"))
    try:
        tex = texture(rng, h, w, dev)
        fwd = rotation_fwd(h, w, 0.1, (5.3, -3.1))
        moved = torch.from_numpy(warp_affine_scipy(tex.cpu().numpy(), fwd)).to(dev)

        def u16(x):
            return torch.clamp(x * 50000 + 2000, 0, 65535).round().to(torch.uint16).cpu().numpy()

        full = [u16(tex), u16(moved)]
        cyc1 = [[full[0][:, 2 : h + 2].copy()], [full[0][:, 2 : h + 2] // 3]]
        cyc2 = [[full[1][48 : h - 48].copy()], [full[1][48 : h - 48] // 3]]
        inputs = write_cycle_files(work, [cyc1, cyc2])
        write_named_config(work / "cfg.yaml", "config_cycle_stack_optflow_only.yaml", inputs, work / "out")
        # the inputs as the CLI pads them: what the outputs are checked against
        padded = [[[np.pad(p, ((0, 0), (2, 2)))] for p in (cyc1[0][0], cyc1[1][0])],
                  [[np.pad(p, ((48, 48), (0, 0)))] for p in (cyc2[0][0], cyc2[1][0])]]
        del tex, moved
        torch.cuda.reset_peak_memory_stats(dev)
        counters.reset()
        printed = []
        wall, stages = run_cli_in_process(work / "cfg.yaml", dev, printed)
        launches = counters.read("auto", ("K1", "K2", "K3", "K4", "K5"))
        require("Will try to perform FeatureReg first" in printed[0], "auto: no FeatureReg pass")
        out = work / "out"
        margin = min(200, h // 8)
        freg = check_stage_output(out / "feature_reg_result_stack.tif", padded, padded[0], margin,
                                  "auto FeatureReg", dev)
        ofreg = check_stage_output(out / "optflow_reg_result_stack.tif", padded, padded[0], margin,
                                   "auto OptFlowReg", dev, mse_bar=0.25)
        errs = check_csv(out / "feature_reg_parameters.csv", {1: np.eye(2, 3), 2: inverse2x3(fwd)}, (h, w),
                         {1: (2, 2, 0, 0), 2: (0, 0, 48, 48)})
        res = dict(wall_s=wall, stages_s=stages, launches=launches, affine_err_px=errs,
                   mse_ratio_max=ofreg["mse_ratio_max"], tczyx=ofreg["tczyx"], feature_tczyx=freg["tczyx"],
                   peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30)
        log(f"[auto] OptFlowReg-only config over {h}x{h} and {h - 96}x{w} images: FeatureReg pass run, in process "
            f"{wall:.2f} s; outputs {ofreg['tczyx']}; affine vs truth {errs} px; registered mse / unregistered "
            f"mse <= {ofreg['mse_ratio_max']:.4f}")
        return res
    finally:
        shutil.rmtree(work, ignore_errors=True)


# -- phase 10 --------------------------------------------------------------

ROUTE_VARIABLES = ("FLOW_DENSE", "FLOW_TILE_BATCH", "WHOLE_REGISTER", "CARRY_LEVEL", "FUSED_REGISTER",
                   "FUSED_LEVEL", "FEATURE_DENSE", "FEATURE_DENSE_MAX_MPIX", "DAISY_NRM", "FLOW_BAND_ROWS")
# the per-tile feature path's timed FeatureReg run: the largest plane the repo runs
FEATURE_PER_TILE_N = 20480


@contextlib.contextmanager
def routes(**variables):
    """The JAX package's route variables (``MICROALIGNER_TPU_<name>``) as
    given, the others unset, for the block; the environment as it was after
    it, so that later phases take the default routes."""
    keys = [f"MICROALIGNER_TPU_{k}" for k in ROUTE_VARIABLES]
    saved = {k: os.environ.pop(k, None) for k in keys}
    try:
        os.environ.update({f"MICROALIGNER_TPU_{k}": v for k, v in variables.items()})
        yield
    finally:
        for k in keys:
            os.environ.pop(k, None)
        os.environ.update({k: v for k, v in saved.items() if v is not None})


def routes_per_tile_20480(dev, rng, counters: "Counters", n=20480, tile=1000, overlap=100) -> dict:
    """The per-tile route at full width: a 20480^2 u8 pair moved by
    ``displacement()`` registered at the main path's settings, then
    ``Warper.warp_device`` and ``_apply_flow_plane`` on a u16 plane, under
    ``FLOW_DENSE=0`` with the counters from 0 (K1-K4 launched, K5 never),
    held to the main path's bars; then the register timed on both routes
    in turns (per-tile, banded, per-tile, banded) and the per-plane apply
    of one flow on both (per-tile, banded, per-tile, banded)."""
    from microaligner_tpu_torch.ops.filters import minmax_normalize_u8
    from microaligner_tpu_torch.optflow.registrator import OptFlowRegistrator
    from microaligner_tpu_torch.optflow.warper import Warper
    from microaligner_tpu_torch.pipeline.runner import _apply_flow_plane
    from microaligner_tpu_torch.tiles import TileGrid

    t0 = time.perf_counter()
    base = texture(rng, n, n, dev)
    dx, dy = displacement(n, n, 3.0, 0.3, dev, wavelength=2000.0)
    ref = minmax_normalize_u8(base)
    mov_f = remap_rows(base, dx, dy)
    mov = minmax_normalize_u8(mov_f)
    plane = torch.clamp(mov_f * 60000 + 1000, 0, 65535).round().to(torch.uint16)
    del base, mov_f
    torch.cuda.synchronize()
    log(f"[routes] {n}^2 pair and u16 plane made in {time.perf_counter() - t0:.2f} s")
    grid = TileGrid.for_image((n, n), tile, overlap)

    def register():
        reg = OptFlowRegistrator(device=dev)
        reg.num_pyr_lvl, reg.num_iterations, reg.tile_size, reg.overlap = 3, 3, tile, overlap
        reg.use_full_res_img, reg.use_dog = True, False
        reg.ref_img, reg.mov_img = ref, mov
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        flow = reg.register_device()
        torch.cuda.synchronize()
        # the register's own peak: device memory allocated at the peak beyond what was live before it
        extra = (torch.cuda.max_memory_allocated(dev) - base) / 2**30
        return flow, time.perf_counter() - t0, extra, reg.last_scores

    with routes(FLOW_DENSE="0"):
        counters.reset()
        flow, reg_s, peak, scores = register()
        warper = Warper(device=dev)
        warper.tile_size, warper.overlap = tile, overlap
        warper.image, warper.flow = mov, flow
        t0 = time.perf_counter()
        warped = warper.warp_device()
        torch.cuda.synchronize()
        warp_s = time.perf_counter() - t0
        applied = _apply_flow_plane(plane, flow, grid, torch.uint16)
        torch.cuda.synchronize()
        launches = counters.read("routes per-tile 20480", ("K1", "K2", "K3", "K4"))
    require(launches["K5"] == 0, f"routes per-tile 20480: K5 launched {launches['K5']} times")
    require(flow.shape == (n, n, 2) and bool(torch.isfinite(flow).all()), "per-tile 20480: bad flow")
    require(applied.dtype == torch.uint16 and applied.shape == (n, n), "per-tile 20480: bad apply")
    err = interior_err(flow, dx, dy, 500)
    before, after = interior_mse(mov, ref, 500), interior_mse(warped, ref, 500)
    res = dict(launches=launches, register_s={"per-tile": [reg_s], "banded": []}, peak_gib={"per-tile": peak},
               warp_s=warp_s, flow_err_px=err, mse_before=before, mse_after=after,
               gate=[(f, a > b) for f, a, b in scores])
    log(f"[routes] {n}^2 u8 register on the per-tile route {reg_s:.2f} s ({peak:.2f} GiB at its peak beyond the "
        f"inputs), warp_device "
        f"{warp_s:.3f} s; flow err {err:.4f} px; mse {before:.1f} -> {after:.1f}; gate {res['gate']}")
    require(err < 0.25 and after < 0.25 * before, res)
    del warped, applied
    for route in ("1", "0", "1"):
        name = "per-tile" if route == "0" else "banded"
        with routes(FLOW_DENSE=route):
            f, secs, peak, _ = register()
        del f
        res["register_s"][name].append(secs)
        res["peak_gib"][name] = max(res["peak_gib"].get(name, 0.0), peak)
    apply_ms = {"per-tile": [], "banded": []}
    for route in ("0", "1", "0", "1"):
        with routes(FLOW_DENSE=route):
            apply_ms["per-tile" if route == "0" else "banded"].append(
                cuda_ms(lambda: _apply_flow_plane(plane, flow, grid, torch.uint16), 3))
    res["apply_ms"] = apply_ms
    log(f"[routes] {n}^2 register, per-tile route {res['register_s']['per-tile']} s, banded "
        f"{res['register_s']['banded']} s; device memory at the register's peak beyond its inputs {res['peak_gib']} "
        f"GiB; _apply_flow_plane on a u16 plane, "
        f"per-tile {apply_ms['per-tile']} ms, banded {apply_ms['banded']} ms")
    del flow, plane, ref, mov, dx, dy
    torch.cuda.empty_cache()
    return res


def routes_drivers(dev, rng, counters: "Counters", n=4096) -> dict:
    """The three OptFlow drivers on one 4096^2 u8 pair on the default
    route: whole, ``WHOLE_REGISTER=0`` and ``CARRY_LEVEL=0`` give the same
    accept/reject and flows within 1e-4 px of the whole driver's (the JAX
    package's bar for whole against per-level; in the port both values of
    ``WHOLE_REGISTER`` run the same carry loop)."""
    from microaligner_tpu_torch.ops.filters import minmax_normalize_u8
    from microaligner_tpu_torch.optflow.registrator import OptFlowRegistrator

    base = texture(rng, n, n, dev)
    dx, dy = displacement(n, n, 3.0, 0.6, dev)
    ref, mov = minmax_normalize_u8(base), minmax_normalize_u8(remap_rows(base, dx, dy))
    del base, dx, dy
    flows, decisions, secs, launches = {}, {}, {}, {}
    for name, variables in (("whole", {}), ("per-level", {"WHOLE_REGISTER": "0"}), ("stepwise", {"CARRY_LEVEL": "0"})):
        reg = OptFlowRegistrator(device=dev)
        reg.num_pyr_lvl, reg.num_iterations, reg.tile_size, reg.overlap, reg.use_full_res_img = 3, 3, 1000, 100, True
        reg.ref_img, reg.mov_img = ref, mov
        with routes(**variables):
            counters.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            flows[name] = reg.register_device()
            torch.cuda.synchronize()
            secs[name] = time.perf_counter() - t0
            got = counters.read(f"routes driver {name}", ("K1", "K2", "K3", "K4", "K5"))
        launches = {k: launches.get(k, 0) + v for k, v in got.items()}
        decisions[name] = [a > b for _, a, b in reg.last_scores]
    errs = {k: float((flows[k] - flows["whole"]).abs().max()) for k in ("per-level", "stepwise")}
    del flows
    # timed again in the reverse order: each driver's time is the better of its two runs
    for name, variables in (("stepwise", {"CARRY_LEVEL": "0"}), ("per-level", {"WHOLE_REGISTER": "0"}), ("whole", {})):
        reg = OptFlowRegistrator(device=dev)
        reg.num_pyr_lvl, reg.num_iterations, reg.tile_size, reg.overlap, reg.use_full_res_img = 3, 3, 1000, 100, True
        reg.ref_img, reg.mov_img = ref, mov
        with routes(**variables):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            reg.register_device()
            torch.cuda.synchronize()
            secs[name] = [secs[name], time.perf_counter() - t0]
    log(f"[routes] three OptFlow drivers on a {n}^2 pair: {secs} s (forward, then reverse order); accept/reject "
        f"{decisions}; max flow difference from the whole driver's {errs} px")
    require(all(d == decisions["whole"] for d in decisions.values()), f"drivers: accept/reject differ {decisions}")
    require(all(e < 1e-4 for e in errs.values()), f"drivers: flows differ {errs}")
    return {"launches": launches, "secs": secs, "decisions": decisions["whole"], "max_flow_diff_px": errs}


def routes_cli_4096(dev, planes, counters: "Counters") -> dict:
    """The OptFlowReg CLI at 4096^2 (the 4096^2 stack of phase 4 as an OME
    CycleStack) under ``FLOW_DENSE=0``: K1-K4 launched and K5 never, and
    the CLI's MSE bar."""
    work = Path(tempfile.mkdtemp(prefix="ma_chip_smoke_routes_"))
    try:
        stack = work / "stack_4096.ome.tif"
        write_cycle_stack(stack, planes)
        write_named_config(work / "cfg.yaml", "config_cycle_stack_optflow_only.yaml", {"CycleStack": str(stack)},
                           work / "out")
        torch.cuda.reset_peak_memory_stats(dev)
        with routes(FLOW_DENSE="0"):
            counters.reset()
            wall, stages = run_cli_in_process(work / "cfg.yaml", dev)
            launches = counters.read("routes cli_4096 FLOW_DENSE=0", ("K1", "K2", "K3", "K4"))
        require(launches["K5"] == 0, f"routes cli_4096: K5 launched {launches['K5']} times")
        res = check_stage_output(work / "out" / "optflow_reg_result_stack.tif", planes, planes[0], 200,
                                 "cli 4096 FLOW_DENSE=0", dev, mse_bar=0.25)
        res.update(wall_s=wall, stages_s=stages, launches=launches,
                   peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30)
        log(f"[routes] 4096^2 OptFlowReg CLI under FLOW_DENSE=0: in process {wall:.2f} s (stage timers on), peak "
            f"{res['peak_gib']:.2f} GiB; stages {stages}; registered mse / unregistered mse <= "
            f"{res['mse_ratio_max']:.4f}")
        return res
    finally:
        shutil.rmtree(work, ignore_errors=True)


def routes_feature(dev, rng, counters: "Counters", n=4096, n_big=FEATURE_PER_TILE_N) -> dict:
    """Config 1's 4096^2 pair (``feature_pairs``) through the FeatureReg
    drivers: ``FUSED_REGISTER=0`` and ``FUSED_LEVEL=0`` against the whole
    route (linear part within 1e-4, translation within 0.05 px) and
    ``FEATURE_DENSE=0``, each within 0.5 px of the truth at the corners;
    the per-tile path's keypoints equal the whole level's on the pair's
    DoG'd reference; then ``FEATURE_DENSE=0`` once on an ``n_big``^2 pair,
    timed."""
    from microaligner_tpu_torch.features import FeatureRegistrator
    from microaligner_tpu_torch.features.tile_features import find_features
    from microaligner_tpu_torch.ops.filters import dog_traced, minmax_normalize_u8

    t_true = np.array([[1.0004, 0.0003, 6.4], [-0.0003, 1.0004, -9.1]])
    truth = inverse2x3(t_true)

    def pair(size):
        ref = minmax_normalize_u8(texture(rng, size, size, dev)).cpu().numpy()
        return ref, np.clip(np.round(warp_affine_scipy(ref, t_true)), 0, 255).astype(np.uint8)

    def register(ref, mov, label, **variables):
        reg = FeatureRegistrator(device=dev)
        reg.num_pyr_lvl, reg.num_iterations, reg.tile_size, reg.use_dog = 3, 3, 1000, True
        reg.ref_img, reg.mov_img = ref, mov
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        with routes(**variables):
            counters.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                tmat = reg.register()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            got = counters.read(f"routes feature {label}", ("K1",))
        require(got["K5"] == 0, f"routes feature {label}: K5 launched")
        err = corner_err(tmat, truth, ref.shape)
        require(err < 0.5, f"routes feature {label}: {err} px from the truth")
        return tmat, {"s": secs, "truth_err_px": err, "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
                      "launches": got}

    ref, mov = pair(n)
    res, launches = {}, {}
    whole, res["whole"] = register(ref, mov, "whole")
    for label, variables in (("FUSED_REGISTER=0", {"FUSED_REGISTER": "0"}), ("FUSED_LEVEL=0", {"FUSED_LEVEL": "0"}),
                             ("FEATURE_DENSE=0", {"FEATURE_DENSE": "0"})):
        tmat, res[label] = register(ref, mov, label, **variables)
        lin, trans = float(np.abs(tmat[:, :2] - whole[:, :2]).max()), float(np.abs(tmat[:, 2] - whole[:, 2]).max())
        res[label].update(linear_diff=lin, translation_diff_px=trans)
        if label != "FEATURE_DENSE=0":
            require(lin < 1e-4 and trans < 0.05, f"routes feature {label}: {lin} linear, {trans} px from whole")
    # timed again in the reverse order: each route's time is the better of its two runs
    for label, variables in (("FEATURE_DENSE=0", {"FEATURE_DENSE": "0"}), ("FUSED_LEVEL=0", {"FUSED_LEVEL": "0"}),
                             ("FUSED_REGISTER=0", {"FUSED_REGISTER": "0"}), ("whole", {})):
        _, again = register(ref, mov, label, **variables)
        res[label]["s"] = [res[label]["s"], again["s"]]
        launches = {k: launches.get(k, 0) + v for k, v in again["launches"].items()}
    det = dog_traced(torch.from_numpy(ref).to(dev), True)
    feats = {}
    for mode in ("1", "0"):
        with routes(FEATURE_DENSE=mode):
            feats[mode] = find_features(det, 1000)
    same = all(torch.equal(getattr(feats["1"], a), getattr(feats["0"], a)) for a in ("coords", "valid", "responses"))
    require(same, "routes feature: the per-tile path's keypoints differ from the whole level's")
    del feats, det
    big_ref, big_mov = pair(n_big)
    _, res[f"FEATURE_DENSE=0 {n_big}"] = register(big_ref, big_mov, f"FEATURE_DENSE=0 {n_big}", FEATURE_DENSE="0")
    del big_ref, big_mov
    for entry in res.values():
        launches = {k: launches.get(k, 0) + v for k, v in entry.pop("launches").items()}
    log(f"[routes] FeatureRegistrator on config 1's {n}^2 pair and a {n_big}^2 pair, by route: {res}; the per-tile "
        f"path's keypoints equal the whole level's")
    return {"launches": launches, "runs": res}


@contextlib.contextmanager
def near_tie_census():
    """Counts, for each ``match_descriptors`` call of the block, the queries
    that it decided again in float64 (``match.near_ties``) and the queries
    that the rule it replaced would have counted as near-ties (within 2^-14
    of ``|q|^2 + max |t|^2``, of which it re-decided 256 at most), from the
    float32 distances of that call."""
    from microaligner_tpu_torch.features import match, registrator

    top2, match_descriptors = match._top2, registrator.match_descriptors
    last, old = {}, []

    def spy_top2(query, train, t_valid, chunk):
        out = top2(query, train, t_valid, chunk)
        if query.dtype == torch.float32:
            last.update(out=out, t_valid=t_valid)
        return out

    def spy_match(des_ref, des_mov, ref_valid, mov_valid, *args):
        good, idx = match_descriptors(des_ref, des_mov, ref_valid, mov_valid, *args)
        d1, d2, _, qn, tn = last.pop("out")
        margin = (d1 - 0.25 * d2).abs() / (qn + torch.amax(torch.where(last["t_valid"], tn, 0.0)))
        old.append(int(((margin <= 2.0**-14) & mov_valid).sum()))
        return good, idx

    match.near_ties.update(calls=0, rows=0, max=0)
    match._top2, registrator.match_descriptors = spy_top2, spy_match
    census = {"old_rule": old}
    try:
        yield census
    finally:
        match._top2, registrator.match_descriptors = top2, match_descriptors
        census.update(match.near_ties)


def routes_strict(dev, rng, counters: "Counters", sizes=(1024, 4096, 20480), n_band=20480) -> dict:
    """FeatureReg under ``MICROALIGNER_TPU_DAISY_NRM=0`` (the reference's raw
    DAISY descriptors) at config 1's parameters on pairs moved by its
    ``t_true``: at ``sizes[0]`` with and without DoG on the card and on the
    CPU (corners within 1e-3 px of each other; with DoG, whatever the CPU's
    outcome is, the card's is the same); at ``sizes[1]`` without DoG within
    0.5 px of the truth; at ``sizes[2]`` without DoG timed beside the
    unit-norm route (strict, unit-norm, strict), with peak device memory and
    the near-ties of each ``match_descriptors`` call.  Every card run
    launches K1 and no plain version.  Then ``MICROALIGNER_TPU_FLOW_BAND_ROWS
    =1088`` on an ``n_band``^2 ``register_device``: bit-equal to
    ``band_rows = 1088``, timed beside the default bands."""
    from microaligner_tpu_torch.features import FeatureRegistrator
    from microaligner_tpu_torch.ops.filters import minmax_normalize_u8
    from microaligner_tpu_torch.optflow.registrator import OptFlowRegistrator

    t_true = np.array([[1.0004, 0.0003, 6.4], [-0.0003, 1.0004, -9.1]])
    truth = inverse2x3(t_true)
    res, launches = {}, {}

    def pair(n):
        ref = minmax_normalize_u8(texture(rng, n, n, dev)).cpu().numpy()
        return ref, np.clip(np.round(warp_affine_scipy(ref, t_true)), 0, 255).astype(np.uint8)

    def register(ref, mov, where, use_dog, label, nrm="0"):
        reg = FeatureRegistrator(device=dev if where == "cuda" else "cpu")
        reg.num_pyr_lvl, reg.num_iterations, reg.tile_size, reg.use_dog = 3, 3, 1000, use_dog
        reg.ref_img, reg.mov_img = ref, mov
        out = {}
        with routes(DAISY_NRM=nrm), near_tie_census() as census:
            if where == "cuda":
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(dev)
                counters.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                tmat = reg.register()
            torch.cuda.synchronize()
            out["s"] = time.perf_counter() - t0
            if where == "cuda":
                got = counters.read(f"routes strict {label}", ("K1",))
                for k, v in got.items():
                    launches[k] = launches.get(k, 0) + v
                out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
        out.update(near_ties=census, truth_err_px=corner_err(tmat, truth, ref.shape),
                   identity=bool(np.abs(tmat - np.eye(2, 3)).max() < 1e-6))
        return tmat, out

    ref, mov = pair(sizes[0])
    for use_dog in (False, True):
        key = f"{sizes[0]}_{'dog' if use_dog else 'no_dog'}"
        card, res[key] = register(ref, mov, "cuda", use_dog, key)
        cpu, res[key + "_cpu"] = register(ref, mov, "cpu", use_dog, key + " cpu")
        diff = corner_err(card, cpu, ref.shape)
        res[key]["card_vs_cpu_px"] = diff
        log(f"[routes] strict FeatureReg {key}: card {res[key]['s']:.2f} s, CPU {res[key + '_cpu']['s']:.2f} s; "
            f"card vs CPU {diff:.2e} px; corners vs truth {res[key]['truth_err_px']:.4f} px; identity "
            f"card {res[key]['identity']}, CPU {res[key + '_cpu']['identity']}")
        require(diff < 1e-3, f"routes strict {key}: card vs CPU {diff} px")
        require(res[key]["identity"] == res[key + "_cpu"]["identity"], f"routes strict {key}: outcomes differ")
    ref, mov = pair(sizes[1])
    key = f"{sizes[1]}_no_dog"
    _, res[key] = register(ref, mov, "cuda", False, key)
    log(f"[routes] strict FeatureReg {key}: {res[key]['s']:.2f} s, corners vs truth {res[key]['truth_err_px']:.4f} px")
    require(res[key]["truth_err_px"] < 0.5, f"routes strict {key}: {res[key]['truth_err_px']} px from the truth")
    ref, mov = pair(sizes[2])
    runs = {"strict": [], "unit-norm": []}
    for nrm in ("0", "1", "0"):
        name = "strict" if nrm == "0" else "unit-norm"
        _, out = register(ref, mov, "cuda", False, f"{sizes[2]} {name}", nrm)
        runs[name].append(out)
        log(f"[routes] {sizes[2]}^2 FeatureReg, no DoG, {name}: {out['s']:.2f} s, peak {out['peak_gib']:.2f} GiB, "
            f"corners vs truth {out['truth_err_px']:.4f} px; near-ties re-decided in float64 {out['near_ties']}")
        require(out["truth_err_px"] < 0.5, f"routes strict {sizes[2]} {name}: {out['truth_err_px']} px from the truth")
    res[f"{sizes[2]}_no_dog"] = runs
    del ref, mov

    base = texture(rng, n_band, n_band, dev)
    dx, dy = displacement(n_band, n_band, 3.0, 0.3, dev, wavelength=2000.0)
    bref, bmov = minmax_normalize_u8(base), minmax_normalize_u8(remap_rows(base, dx, dy))
    del base, dx, dy

    def register_band(label, band_rows=None, **variables):
        reg = OptFlowRegistrator(device=dev)
        reg.num_pyr_lvl, reg.num_iterations, reg.tile_size, reg.overlap = 3, 3, 1000, 100
        reg.use_full_res_img, reg.use_dog, reg.band_rows = True, False, band_rows
        reg.ref_img, reg.mov_img = bref, bmov
        with routes(**variables), contextlib.redirect_stdout(io.StringIO()):
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            counters.reset()
            t0 = time.perf_counter()
            flow = reg.register_device()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            got = counters.read(f"routes band rows {label}", ("K1", "K2", "K3", "K4", "K5"))
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        # the register's own peak: beyond what was live before it (an earlier run's flow)
        return flow, {"s": secs, "peak_gib": (torch.cuda.max_memory_allocated(dev) - base) / 2**30, "launches": got}

    bands = {}
    env_flow, bands["FLOW_BAND_ROWS=1088"] = register_band("env", FLOW_BAND_ROWS="1088")
    attr_flow, bands["band_rows=1088"] = register_band("attribute", band_rows=1088)
    same = torch.equal(env_flow, attr_flow)
    del attr_flow
    default_flow, bands["default"] = register_band("default")
    bands["max_diff_from_default_px"] = float((env_flow - default_flow).abs().max())
    del env_flow, default_flow, bref, bmov
    torch.cuda.empty_cache()
    log(f"[routes] {n_band}^2 register_device by band height: {bands}; the variable bit-equal to the attribute: {same}")
    require(same, "routes band rows: FLOW_BAND_ROWS=1088 differs from band_rows = 1088")
    res["band_rows"] = bands
    return {"launches": launches, "runs": res}


def alternate_routes(dev, rng, counters: "Counters", stack_planes) -> dict:
    """Phase 10: the JAX package's alternate routes, each variable set for
    its case only.  Returns one report entry a case, each with the
    launches counted from 0 around it."""
    with routes(FLOW_DENSE="0"):
        parity = parity_run(dev, rng, label="routes parity FLOW_DENSE=0", counters=counters,
                            kernels=("K1", "K2", "K3", "K4"))
    require(parity["launches"]["K5"] == 0, "routes parity: K5 launched on the per-tile route")
    return {"routes_parity": parity,
            "routes_per_tile_20480": routes_per_tile_20480(dev, rng, counters),
            "routes_drivers": routes_drivers(dev, rng, counters),
            "routes_cli_4096": routes_cli_4096(dev, stack_planes, counters),
            "routes_feature": routes_feature(dev, rng, counters),
            "routes_strict": routes_strict(dev, rng, counters)}


# -- phase 11 --------------------------------------------------------------

# the sharded register step at config 2 of the JAX package's bench
# (``bench.py::bench_optflow_step``): 4096^2, tile 1000, overlap 100, window 99, 3 iterations
STEP_N, STEP_TILE, STEP_OVERLAP, STEP_WIN, STEP_ITERS = 4096, 1000, 100, 99, 3
MESH_WORKER_TIMEOUT_S = 240

# one rank of phase 11's process groups, on its first visible card: ``collectives`` runs
# tile_map (gathered across the ranks) and an all_reduce; ``step`` runs the sharded step on
# the pair in ``pair.pt`` and prints a digest of its outputs and its kernel launches
MESH_WORKER = r'''
import hashlib, json, os, sys
mode, backend, pid, nproc, coord, root, work = sys.argv[1:8]
sys.path.insert(0, root)
os.environ.update(MICROALIGNER_TPU_DIST="1", MICROALIGNER_TPU_DIST_COORD=coord,
                  MICROALIGNER_TPU_DIST_NPROC=nproc, MICROALIGNER_TPU_DIST_PID=pid)
import torch
import torch.distributed as dist
from microaligner_tpu_torch.ops import kernel_agg, kernel_matrices, kernel_poly, kernel_sample as ks
from microaligner_tpu_torch.parallel import get_tile_mesh, init_distributed_from_env, tile_map
from microaligner_tpu_torch.parallel.step import make_sharded_register_step
from microaligner_tpu_torch.tiles import TileGrid

dev = torch.device("cuda", 0)
if not init_distributed_from_env(backend=backend, timeout_s=120):
    raise SystemExit("MICROALIGNER_TPU_DIST is not 1")
mesh = get_tile_mesh([dev])
out = {"mode": mode, "backend": dist.get_backend(), "rank": mesh.rank, "world": mesh.world_size,
       "shards": mesh.size}
if mode == "collectives":
    tiles = torch.arange(11 * 64 * 64, device=dev, dtype=torch.float32).reshape(11, 64, 64)
    got = tile_map(lambda t: (t * 2.0 + 1.0, t.to(torch.uint16)), (tiles,), batch=4, mesh=mesh)
    out["tile_map_ok"] = bool(torch.equal(got[0], tiles * 2.0 + 1.0) and torch.equal(got[1], tiles.to(torch.uint16)))
    total = tiles.sum((1, 2))
    dist.all_reduce(total, op=dist.ReduceOp.SUM)
    out["all_reduce_ok"] = bool(torch.equal(total, int(nproc) * tiles.sum((1, 2))))
else:
    pair = torch.load(os.path.join(work, "pair.pt"))
    n, tile, overlap, win, iters = pair["params"]
    step = make_sharded_register_step(mesh, TileGrid.for_image((n, n), tile, overlap), win, iters)
    wrappers = {"K1": ks.sample_displaced, "K2": kernel_poly.poly_pair_m, "K3": kernel_agg.smooth5_solve,
                "K4": kernel_matrices.update_matrices}
    plains = (ks.sample_displaced_plain, kernel_poly.poly_pair_m_plain, kernel_agg.smooth5_solve_plain,
              kernel_matrices.update_matrices_plain)
    for fn in (*wrappers.values(), *plains):
        setattr(fn, "launches" if hasattr(fn, "launches") else "calls", 0)
    warped, flow, hist = step(pair["ref"].to(dev), pair["mov"].to(dev))
    torch.cuda.synchronize()
    out["launches"] = {k: fn.launches for k, fn in wrappers.items()}
    out["plain_calls"] = sum(fn.calls for fn in plains)
    out["digest"] = {name: hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()
                     for name, t in (("warped", warped), ("flow", flow), ("hist", hist))}
    out["hist_sum"] = int(hist.sum())
dist.destroy_process_group()
print("MESH_WORKER " + json.dumps(out), flush=True)
'''


def step_pair(dev, rng, n):
    """A float32 0-255 pair moved by ``displacement()``, on ``dev``."""
    base = texture(rng, n, n, dev)
    dx, dy = displacement(n, n, 3.0, 0.4, dev, wavelength=700.0)
    return base * 255.0, remap_rows(base, dx, dy) * 255.0


def digests(outs) -> dict:
    import hashlib

    return {name: hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()
            for name, t in zip(("warped", "flow", "hist"), outs)}


def mesh_label(devices) -> str:
    devices = tuple(devices)
    if len(set(devices)) == 1:
        return f"({devices[0]},) x {len(devices)}"
    return "(" + ", ".join(map(str, devices)) + ")"


def mesh_step(dev, rng, counters: "Counters", meshes=None) -> dict:
    """(a) the sharded step at config 2's size on each of ``meshes``, by
    default (cuda:0,) x 1, 2 and 4 (25 halo windows: the 2- and 4-entry
    meshes pad the axis): every mesh's flow, warp and histogram bit-equal
    to the first mesh's, the histogram at exactly 4096^2, K1-K4 launched
    and no plain version; each timed with CUDA events (mean of 3 after a
    warm-up)."""
    from microaligner_tpu_torch.parallel import get_tile_mesh
    from microaligner_tpu_torch.parallel.step import make_sharded_register_step
    from microaligner_tpu_torch.tiles import TileGrid

    n = STEP_N
    meshes = meshes or [(dev,) * k for k in (1, 2, 4)]
    ref, mov = step_pair(dev, rng, n)
    grid = TileGrid.for_image((n, n), STEP_TILE, STEP_OVERLAP)
    res, launches, first = {"pair": (ref, mov)}, {}, None
    for devices in meshes:
        label = mesh_label(devices)
        step = make_sharded_register_step(get_tile_mesh(devices), grid, STEP_WIN, STEP_ITERS)
        torch.cuda.synchronize()
        for d in set(devices):
            torch.cuda.reset_peak_memory_stats(d)
        counters.reset()
        outs = step(ref, mov)
        torch.cuda.synchronize()
        got = counters.read(f"mesh step {label}", ("K1", "K2", "K3", "K4"))
        launches = {key: launches.get(key, 0) + v for key, v in got.items()}
        peak = max(torch.cuda.max_memory_allocated(d) for d in set(devices)) / 2**30
        ms = cuda_ms(lambda: step(ref, mov), 3)
        warped, flow, hist = outs
        require(warped.shape == (n, n) and flow.shape == (n, n, 2) and bool(torch.isfinite(flow).all()),
                f"mesh step {label}: outputs {tuple(warped.shape)}, {tuple(flow.shape)} or a non-finite flow")
        require(int(hist.sum()) == n * n, f"mesh step {label}: the histogram sums to {int(hist.sum())}, not {n * n}")
        if first is None:
            first = outs
        same = all(torch.equal(a, b.to(a.device)) for a, b in zip(first, outs))
        log(f"[mesh] step {n}^2, tile {STEP_TILE}, window {STEP_WIN}, {STEP_ITERS} iterations, mesh {label}: "
            f"{ms:.3f} ms, peak device memory {peak:.2f} GiB; histogram sum {int(hist.sum())}; bit-equal to the "
            f"first mesh's: {same}")
        require(same, f"mesh step {label}: outputs differ from the first mesh's")
        res[label] = dict(ms=ms, peak_gib=peak, launches=got)
    res["digest"] = digests(first)
    res["launches"] = launches
    return res


def mesh_step_parity(dev, rng, counters: "Counters", n=1024, tile=500) -> dict:
    """(b) the step at 1024^2, tile 500 (window 51, 3 iterations) on the card
    against a CPU mesh of 2 running the plain versions: phase 3's bars
    (flow mean < 1e-4 px, max < 1e-2 px), both histograms at exactly n^2."""
    from microaligner_tpu_torch.parallel import get_tile_mesh
    from microaligner_tpu_torch.parallel.step import make_sharded_register_step
    from microaligner_tpu_torch.tiles import TileGrid

    ref, mov = step_pair(dev, rng, n)
    grid = TileGrid.for_image((n, n), tile, 100)
    counters.reset()
    card = make_sharded_register_step(get_tile_mesh([dev]), grid, 51, 3)(ref, mov)
    torch.cuda.synchronize()
    launches = counters.read("mesh step parity", ("K1", "K2", "K3", "K4"))
    t0 = time.perf_counter()
    cpu = make_sharded_register_step(get_tile_mesh(["cpu"] * 2), grid, 51, 3)(ref.cpu(), mov.cpu())
    cpu_s = time.perf_counter() - t0
    err = (card[1].cpu() - cpu[1]).abs()
    mean, mx = float(err.mean()), float(err.max())
    wdiff = float((card[0].cpu() - cpu[0]).abs().max())
    log(f"[mesh] step {n}^2, tile {tile}: card (cuda:0,) against a CPU mesh of 2 ({cpu_s:.1f} s): flow diff mean "
        f"{mean:.3e} max {mx:.3e} px, warped max diff {wdiff:.3e}; histogram sums {int(card[2].sum())}, "
        f"{int(cpu[2].sum())}")
    require(mean < 1e-4 and mx < 1e-2, f"mesh step parity: flow diff mean {mean} max {mx}")
    require(int(card[2].sum()) == n * n == int(cpu[2].sum()), "mesh step parity: a histogram is not n^2")
    return dict(flow_diff_mean=mean, flow_diff_max=mx, warped_diff_max=wdiff, cpu_s=cpu_s, launches=launches)


def mesh_engines(dev, rng, counters: "Counters", other=None, n=20480, n_feat=4096, tile=1000,
                 overlap=100) -> dict:
    """(c) the engines at full width on the mesh ``other``, by default
    (cuda:0,) x 2, against (cuda:0,): a
    20480^2 ``register_device`` on both ``FLOW_DENSE`` routes,
    ``Warper.warp_device`` of a u16 plane and ``affine_warp_bands`` of it,
    then FeatureReg's banded and per-tile ``find_features`` at 4096^2.
    Each result bit-equal across the meshes; each case runs in turns (one,
    other, other, one), and each mesh's first run counts its launches from 0
    (K1-K4, and K5 on the banded route; no plain version) and its peak
    device memory."""
    from microaligner_tpu_torch.features.tile_features import find_features
    from microaligner_tpu_torch.ops.affine_tiled import affine_warp_bands
    from microaligner_tpu_torch.ops.filters import minmax_normalize_u8
    from microaligner_tpu_torch.optflow.registrator import OptFlowRegistrator
    from microaligner_tpu_torch.optflow.warper import Warper
    from microaligner_tpu_torch.parallel import use_tile_mesh

    t0 = time.perf_counter()
    base = texture(rng, n, n, dev)
    dx, dy = displacement(n, n, 3.0, 0.3, dev, wavelength=2000.0)
    ref = minmax_normalize_u8(base)
    mov_f = remap_rows(base, dx, dy)
    mov = minmax_normalize_u8(mov_f)
    plane = torch.clamp(mov_f * 60000 + 1000, 0, 65535).round().to(torch.uint16)
    del base, mov_f, dx, dy
    feat = minmax_normalize_u8(texture(rng, n_feat, n_feat, dev))
    torch.cuda.synchronize()
    log(f"[mesh] {n}^2 pair, u16 plane and {n_feat}^2 feature image made in {time.perf_counter() - t0:.2f} s")

    def register():
        reg = OptFlowRegistrator(device=dev)
        reg.num_pyr_lvl, reg.num_iterations, reg.tile_size, reg.overlap = 3, 3, tile, overlap
        reg.use_full_res_img, reg.use_dog = True, False
        reg.ref_img, reg.mov_img = ref, mov
        return reg.register_device()

    def warp(flow):
        w = Warper(device=dev)
        w.tile_size, w.overlap = tile, overlap
        w.image, w.flow = plane, flow
        return w.warp_device()

    inv = np.array([[0.99998, -0.0052, 31.7], [0.0052, 0.99998, -22.4]])
    flows = {}
    cases = [("register banded", {}, register, ("K1", "K2", "K3", "K4", "K5")),
             ("register per-tile", {"FLOW_DENSE": "0"}, register, ("K1", "K2", "K3", "K4")),
             ("Warper.warp_device", {}, lambda: warp(flows["register banded"]), ("K5",)),
             ("affine_warp_bands", {}, lambda: affine_warp_bands(plane, inv, n, n), ("K1",)),
             ("find_features banded", {"FEATURE_DENSE_MAX_MPIX": "0"},
              lambda: vars(find_features(feat, tile)), ()),
             ("find_features per-tile", {"FEATURE_DENSE": "0"}, lambda: vars(find_features(feat, tile)), ())]
    meshes = {"one": (dev,), "other": tuple(other or (dev,) * 2)}
    names = {k: mesh_label(v) for k, v in meshes.items()}
    res, launches = {}, {}
    for label, variables, fn, kernels in cases:
        outs, secs = {}, {"one": [], "other": []}
        for k in ("one", "other", "other", "one"):  # in turns; each mesh's first run counts launches and memory
            first = k not in outs
            with routes(**variables), use_tile_mesh(meshes[k]):
                for d in set(meshes[k]):
                    torch.cuda.empty_cache()
                    torch.cuda.synchronize(d)
                    torch.cuda.reset_peak_memory_stats(d)
                base_bytes = {d: torch.cuda.memory_allocated(d) for d in set(meshes[k])}
                if first:
                    counters.reset()
                t0 = time.perf_counter()
                out = fn()
                for d in set(meshes[k]):
                    torch.cuda.synchronize(d)
                secs[k].append(time.perf_counter() - t0)
                if first:
                    got = counters.read(f"mesh {label} {names[k]}", kernels)
            if not first:
                del out
                continue
            outs[k] = out
            peak = max(torch.cuda.max_memory_allocated(d) - base_bytes[d] for d in set(meshes[k])) / 2**30
            if label == "register per-tile":
                require(got["K5"] == 0, f"mesh {label} {names[k]}: K5 launched on the per-tile route")
            launches = {key: launches.get(key, 0) + v for key, v in got.items()}
            res[f"{label} {names[k]}"] = dict(peak_gib=peak, launches=got, s=secs[k])
        a, b = outs["one"], outs["other"]
        if isinstance(a, dict):
            a = [v for v in a.values() if isinstance(v, torch.Tensor)]
            b = [v for v in b.values() if isinstance(v, torch.Tensor)]
        else:
            a, b = [a], [b]
        same = len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
        peaks = [res[f"{label} {names[k]}"]["peak_gib"] for k in ("one", "other")]
        log(f"[mesh] {label}: {names['one']} {secs['one'][0]:.4f}, {secs['one'][1]:.4f} s, peak {peaks[0]:.2f} GiB; "
            f"{names['other']} {secs['other'][0]:.4f}, {secs['other'][1]:.4f} s, peak {peaks[1]:.2f} GiB "
            f"(in turns); bit-equal: {same}")
        require(same, f"mesh {label}: the result on {names['other']} differs from the one on {names['one']}")
        if label.startswith("register"):
            flows[label] = outs["one"]
            require(bool(torch.isfinite(outs["one"]).all()), f"mesh {label}: non-finite flow")
    res["launches"] = launches
    return res


def run_mesh_workers(mode: str, backend: str, nproc: int, work: Path, card_per_rank: bool = False) -> list:
    """``nproc`` ranks of ``MESH_WORKER`` in ``mode`` over ``backend``
    (with ``card_per_rank``, rank i sees only card i), each killed if it has
    not finished within ``MESH_WORKER_TIMEOUT_S``; their reports."""
    import socket

    script = work / "mesh_worker.py"
    script.write_text(MESH_WORKER)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        coord = f"localhost:{s.getsockname()[1]}"
    procs = []
    for pid in range(nproc):
        env = dict(os.environ, **({"CUDA_VISIBLE_DEVICES": str(pid)} if card_per_rank else {}))
        procs.append(subprocess.Popen(
            [sys.executable, str(script), mode, backend, str(pid), str(nproc), coord, str(ROOT), str(work)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=MESH_WORKER_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    reports = []
    for pid, (p, out) in enumerate(zip(procs, outs)):
        line = [ln for ln in out.splitlines() if ln.startswith("MESH_WORKER ")]
        require(p.returncode == 0 and line, f"mesh {mode} rank {pid} failed (rc {p.returncode}):\n{out[-4000:]}")
        reports.append(json.loads(line[-1][len("MESH_WORKER "):]))
    return reports


def group_collectives(backend: str, nproc: int, work: Path, card_per_rank: bool = False) -> dict:
    """``tile_map`` (gathered across the ranks) and an ``all_reduce`` in a
    group of ``nproc`` ranks over ``backend``."""
    t0 = time.perf_counter()
    reports = run_mesh_workers("collectives", backend, nproc, work, card_per_rank)
    secs = time.perf_counter() - t0
    for r in reports:
        log(f"[mesh] {backend} rank {r['rank']} of {r['world']}: tile_map {r['tile_map_ok']}, all_reduce "
            f"{r['all_reduce_ok']} ({secs:.1f} s with the process starts)")
        require(r["backend"] == backend and r["world"] == nproc and r["tile_map_ok"] and r["all_reduce_ok"], r)
    return dict(s=secs, ranks=reports)


def group_step(step_report: dict, backend: str, nproc: int, work: Path, card_per_rank: bool = False) -> dict:
    """(a)'s step in a group of ``nproc`` ranks over ``backend``: each
    rank's outputs bit-equal (by SHA-256) to the one-process result, the
    histogram at exactly 4096^2, K1-K4 launched and no plain version."""
    ref, mov = step_report["pair"]
    torch.save({"ref": ref.cpu(), "mov": mov.cpu(),
                "params": (STEP_N, STEP_TILE, STEP_OVERLAP, STEP_WIN, STEP_ITERS)}, work / "pair.pt")
    t0 = time.perf_counter()
    ranks = run_mesh_workers("step", backend, nproc, work, card_per_rank)
    secs = time.perf_counter() - t0
    launches = {}
    for r in ranks:
        same = r["digest"] == step_report["digest"]
        log(f"[mesh] {backend} rank {r['rank']} of {r['world']} ({r['shards']} shards): step outputs bit-equal to "
            f"the one-process result: {same}; histogram sum {r['hist_sum']}; launches {r['launches']}, plain calls "
            f"{r['plain_calls']} ({secs:.1f} s for the group with the process starts)")
        require(r["backend"] == backend and r["world"] == nproc and same and r["hist_sum"] == STEP_N**2, r)
        require(all(v > 0 for v in r["launches"].values()) and r["plain_calls"] == 0, r)
        launches = {k: launches.get(k, 0) + v for k, v in r["launches"].items()}
    return dict(s=secs, digest=ranks[0]["digest"], launches=launches)


def mesh_groups(step_report: dict) -> dict:
    """(d) process groups formed by ``init_distributed_from_env``, each rank
    a subprocess on the one card: a 1-rank NCCL group running ``tile_map``
    (gathered through NCCL) and an ``all_reduce``, then 2 gloo ranks
    running (a)'s step."""
    work = Path(tempfile.mkdtemp(prefix="ma_chip_smoke_mesh_"))
    try:
        nccl = group_collectives("nccl", 1, work)
        gloo = group_step(step_report, "gloo", 2, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return dict(nccl=nccl, gloo=gloo, launches=gloo["launches"])


def mesh_phase(dev, rng, counters: "Counters") -> dict:
    """Phase 11: the tile mesh.  Returns one report entry a part, each with
    the launches counted from 0 around it."""
    t0 = time.perf_counter()
    step = mesh_step(dev, rng, counters)
    out = {"mesh_step": step,
           "mesh_step_parity": mesh_step_parity(dev, rng, counters),
           "mesh_engines": mesh_engines(dev, rng, counters),
           "mesh_groups": mesh_groups(step)}
    del step["pair"]
    log(f"[mesh] phase 11 in {time.perf_counter() - t0:.1f} s")
    return out


def mesh_cards() -> int:
    """``python3 chip_smoke.py --cards``, on a machine with two or more
    cards: phase 11 with a mesh of every visible card where that phase
    repeats one card: (a) the step on (cuda:0,) and on every card, (c) the
    engines on every card against (cuda:0,), and (d) NCCL groups of one
    rank a card (each rank sees one card through ``CUDA_VISIBLE_DEVICES``)
    running ``tile_map`` with an ``all_reduce`` and (a)'s step; every result
    bit-equal to the one-device one.  Writes
    ``chiprun_out/mesh_cards_report.json``; ends with the cards' names and
    power limits and ``{"ok": true, ...}``."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        raise SystemExit("chip_smoke --cards: this run needs two or more NVIDIA GPUs")
    from microaligner_tpu_torch.ops import cuda_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    dev = cards[0]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    t0 = time.perf_counter()
    cuda_lib.build()
    cuda_lib.library()
    log(f"[cards] {len(cards)} cards; kernels built in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(20261017)
    counters = Counters()
    report = {"cards": len(cards), "nvidia_smi": smi.splitlines()}
    step = mesh_step(dev, rng, counters, meshes=[(dev,), tuple(cards)])
    report["step"] = {k: v for k, v in step.items() if k != "pair"}
    report["engines"] = mesh_engines(dev, rng, counters, other=cards)
    work = Path(tempfile.mkdtemp(prefix="ma_chip_smoke_cards_"))
    try:
        report["nccl_collectives"] = group_collectives("nccl", len(cards), work, card_per_rank=True)
        report["nccl_step"] = group_step(step, "nccl", len(cards), work, card_per_rank=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "mesh_cards_report.json").write_text(json.dumps(report, indent=1, default=str))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


def k3_build_lines(ptxas: str) -> dict:
    """Registers, spill bytes, shared memory a block and blocks an SM of the
    two K3 kernels from ``nvcc -Xptxas -v``'s output (empty when the library
    was already built); raises if either kernel spills."""
    from microaligner_tpu_torch.ops import kernel_agg

    out = {}
    lines = ptxas.splitlines()
    props = torch.cuda.get_device_properties(0)
    threads = kernel_agg.BLOCK_THREADS
    for i, line in enumerate(lines):
        found = re.search(r"Compiling entry function '\w*?(smooth_rows_kernel|smooth_cols_solve_kernel)", line)
        if not found:
            continue
        text = " ".join(lines[i + 1 : i + 4])
        spills = [int(v) for v in re.findall(r"(\d+) bytes spill", text)]
        regs = int(re.search(r"Used (\d+) registers", text).group(1))
        smem = kernel_agg.block_shared_bytes(found.group(1), 99 // 2)
        blocks = min(getattr(props, "regs_per_multiprocessor", 65536) // (regs * threads),
                     getattr(props, "shared_memory_per_multiprocessor", 233472) // (smem + 1024),
                     props.max_threads_per_multi_processor // threads)
        out[found.group(1)] = {"registers": regs, "spill_bytes": sum(spills), "shared_bytes_window_99": smem,
                               "blocks_per_sm": blocks}
        log(f"[build] K3 {found.group(1)}: {regs} registers, {sum(spills)} spill bytes, {threads} threads and "
            f"{smem} B of shared memory a block at window 99, {blocks} block(s) an SM")
        require(len(spills) == 2 and sum(spills) == 0, f"K3 {found.group(1)} spills: {text}")
    if ptxas:
        require(len(out) == 2, f"ptxas named {sorted(out)} of the two K3 kernels")
    return out


# the Itanium mangling of K5's dtype (its template arguments Tin = Tout)
K5_MANGLED = {"h": "u8", "a": "i8", "t": "u16", "s": "i16", "i": "i32", "f": "f32"}


def k1_build_lines(ptxas: str) -> dict:
    """Registers and spill bytes of K1's kernel (``k1::sample_kernel``) from
    ``nvcc -Xptxas -v``'s output (empty when the library was already
    built); raises if it spills or takes more than 64 registers."""
    out = {}
    lines = ptxas.splitlines()
    for i, line in enumerate(lines):
        if not re.search(r"Compiling entry function '\w*?k113sample_kernelE", line):
            continue
        text = " ".join(lines[i + 1 : i + 4])
        spills = [int(v) for v in re.findall(r"(\d+) bytes spill", text)]
        out = {"registers": int(re.search(r"Used (\d+) registers", text).group(1)), "spill_bytes": sum(spills)}
        log(f"[build] K1: {out['registers']} registers, {out['spill_bytes']} spill bytes")
        require(len(spills) == 2 and sum(spills) == 0 and out["registers"] <= 64, f"K1: {text}")
    if ptxas:
        require(out, "ptxas named no K1 kernel")
    return out


def k5_build_lines(ptxas: str) -> dict:
    """Registers, spill bytes and shared memory a block of K5's
    instantiations (``k5::sample_multi_kernel<Tin, Tout>``) from ``nvcc
    -Xptxas -v``'s output (empty when the library was already built);
    raises if one spills."""
    out = {}
    lines = ptxas.splitlines()
    for i, line in enumerate(lines):
        found = re.search(r"Compiling entry function '\w*?sample_multi_kernelI(\w)(\w)E", line)
        if not found:
            continue
        text = " ".join(lines[i + 1 : i + 4])
        spills = [int(v) for v in re.findall(r"(\d+) bytes spill", text)]
        regs = int(re.search(r"Used (\d+) registers", text).group(1))
        smem = int(re.search(r"(\d+) bytes smem", text).group(1))
        name = K5_MANGLED[found.group(1)]
        out[name] = {"registers": regs, "spill_bytes": sum(spills), "shared_bytes": smem}
        log(f"[build] K5 {name}: {regs} registers, {sum(spills)} spill bytes, {smem} B of shared memory a block")
        require(len(spills) == 2 and sum(spills) == 0, f"K5 {name} spills: {text}")
    if ptxas:
        require(len(out) == 6, f"ptxas named {len(out)} K5 instantiations, not 6: {sorted(out)}")
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this run needs an NVIDIA GPU")
    from microaligner_tpu_torch.ops import cuda_lib  # fails outside a checkout of the repo

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(20261016)
    smi = nvidia_smi()
    report = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
              "torch": torch.__version__, "cuda": torch.version.cuda}
    t_start = time.perf_counter()

    t0 = time.perf_counter()
    lib_path, ptxas = cuda_lib.build(verbose=True)
    cuda_lib.library()
    report["build_s"] = time.perf_counter() - t0
    log(f"[build] {lib_path.name} in {report['build_s']:.1f} s on {smi} "
        f"(torch {torch.__version__}, CUDA {torch.version.cuda})")
    for line in ptxas.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"[build] {line.strip()}")
    report["k1_build"] = k1_build_lines(ptxas)
    report["k3_build"] = k3_build_lines(ptxas)
    report["k5_build"] = k5_build_lines(ptxas)

    kernels = check_kernels(dev, rng)
    kernels["K5"] = check_k5(dev, rng)
    kernels["K6"] = check_k6(dev, rng)
    report["parity"] = parity_run(dev, rng)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    counters = Counters()
    report["main"], stack_planes = main_path(dev, rng, out_dir, counters)
    report["unpaired"] = unpaired_route(dev, rng, counters, stack_planes)
    report["zstack"] = zstack_apply(dev, rng, counters)
    # every K5 launch of the paths is the band entry's: its line reports that wrapper (u16, the bench's
    # stack), and the float32 entry's numbers stay in the report
    kernels["K5"] = {"f32_entry": kernels["K5"], "one_plane": check_one_plane_band(dev, rng),
                     **report["zstack"]["band_entry"]}
    work = Path(tempfile.mkdtemp(prefix="ma_chip_smoke_4k_"))
    try:
        report["cli_4096"] = cli_4096(dev, stack_planes, counters, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    report.update(alternate_routes(dev, rng, counters, stack_planes))
    del stack_planes
    report["cli_20480"] = cli_20480(dev, rng, counters)
    report["feature"] = feature_pairs(dev, rng, counters)
    report["chained_4096"] = chained_cli(dev, rng, counters, 4096, big=False)
    report["chained_20480"] = chained_cli(dev, rng, counters, 20480, big=True)
    report["auto"] = auto_feature_pass(dev, rng, counters)
    report.update(mesh_phase(dev, rng, counters))

    report["kernels"] = kernels
    report["total_s"] = time.perf_counter() - t_start
    (out_dir / "chip_smoke_report.json").write_text(json.dumps(report, indent=1, default=str))
    log(f"[done] all phases in {report['total_s']:.1f} s")

    log(smi)
    sources = {"K1": ("sample_displaced", "sample.cu", "microaligner_tpu/ops/pallas_sample.py:53"),
               "K2": ("poly_pair_m", "poly.cu", "microaligner_tpu/ops/pallas_poly.py:172"),
               "K3": ("smooth5_solve", "agg.cu", "microaligner_tpu/ops/pallas_agg.py:160"),
               "K4": ("update_matrices", "matrices.cu", "microaligner_tpu/ops/pallas_matrices.py:63"),
               "K5": ("sample_band_multi", "sample.cu", "microaligner_tpu/ops/pallas_sample.py:183"),
               "K6": ("poly_exp5", "poly.cu", "microaligner_tpu/ops/pallas_poly.py:83")}
    # each path's launches, counted from 0 just before it and read just after
    paths = ("main", "unpaired", "zstack", "cli_4096", "routes_parity", "routes_per_tile_20480", "routes_drivers",
             "routes_cli_4096", "routes_feature", "routes_strict", "cli_20480", "feature", "chained_4096", "chained_20480", "auto",
             "mesh_step", "mesh_step_parity", "mesh_engines", "mesh_groups")
    launches = {k: sum(report[path]["launches"].get(k, 0) for path in paths) for k in sources}
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": f"microaligner_tpu_torch/csrc/{src}",
         "replaces": replaces, "launches": launches[k],
         "max_abs_err": kernels[k]["max_abs_err"], "ms": kernels[k]["ms"],
         "plain_ms": kernels[k]["plain_ms"], "bound_ms": kernels[k]["bound_ms"],
         "bound_by": kernels[k]["bound_by"], "library_ms": kernels[k]["library_ms"]}
        for k, (name, src, replaces) in sources.items()
    ]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(mesh_cards() if sys.argv[1:] == ["--cards"] else main())
