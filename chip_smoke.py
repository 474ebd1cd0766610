#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``microaligner_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

Run it from the repository root; it needs one card and takes no arguments.  Phases, each printing its own lines:

1. build: compile ``microaligner_tpu_torch/csrc/*.cu`` with nvcc for sm_90a;
2. kernels: K1-K4 against their plain PyTorch versions on the card, at the
   main path's band shapes (4296 x 4296, 1256 x 20680) and edge cases, with
   CUDA-event times of kernel and plain version; K5 (N planes, one flow)
   against its plain version and against N K1 launches, bit for bit, at 8
   planes of a 4096^2 band slab, 2 of a 20480^2 one and the edge shapes;
3. parity: a 1024^2 pair through ``OptFlowRegistrator.register_device`` on
   the card against the same pair through the plain versions on the CPU;
4. main path: the CLI's cycle loop (z-max projection, ``register_device``,
   ``warp_device``, per-plane apply) over a synthetic 3-cycle x 2-channel x
   3-z u16 4096^2 stack, then a 2-cycle 20480^2 u8 register and a one-plane
   apply, with stage times, peak device memory and the kernels' launch counts,
   and one 4096^2 register under torch.profiler (device time by kernel and
   the device's busy share; the table goes to ``chiprun_out/``);
5. z-stack apply: 8 u16 4096^2 planes warped by one flow through
   ``_apply_flow_planes`` (K5), which must agree bit for bit with
   ``_apply_flow_plane`` on each plane (K1);
6. the CLI: that 4096^2 stack written as an OME CycleStack and run through
   ``microaligner_tpu_torch.__main__.main`` in process and once more as
   ``python -m microaligner_tpu_torch``; then a 2-cycle x 2-channel 20480^2
   u16 CycleStack through the CLI in process.  Each output is checked: its
   TCZYX shape and OME sizes, the reference cycle bit for bit, and the
   registered planes' interior MSE to cycle 1 below a quarter of the
   unregistered MSE.

Every path of phases 4-6 runs with the kernels' launch counters set to 0
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
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
TOL = {"K1": "atol 1e-5", "K2": "1e-5*max|plain|+1e-6", "K3": "atol 1e-4 px", "K4": "1e-5*max|plain|+1e-6",
       "K5": "0: bit-equal to its plain version and to one K1 launch a plane"}


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
    after it."""

    def __init__(self):
        from microaligner_tpu_torch.ops import kernel_agg, kernel_matrices, kernel_poly, kernel_sample

        self.wrappers = {"K1": kernel_sample.sample_displaced, "K2": kernel_poly.poly_pair_m,
                         "K3": kernel_agg.smooth5_solve, "K4": kernel_matrices.update_matrices,
                         "K5": kernel_sample.sample_displaced_multi}
        self.plains = {"K1": kernel_sample.sample_displaced_plain, "K2": kernel_poly.poly_pair_m_plain,
                       "K3": kernel_agg.smooth5_solve_plain, "K4": kernel_matrices.update_matrices_plain,
                       "K5": kernel_sample.sample_displaced_multi_plain}

    def reset(self) -> None:
        for fn in (*self.wrappers.values(), *self.plains.values()):
            if hasattr(fn, "launches"):
                fn.launches = 0
            if hasattr(fn, "calls"):
                fn.calls = 0

    def read(self, path: str, kernels) -> dict:
        """Launches of every kernel since ``reset``; raises unless each of
        ``kernels`` launched and no plain version ran."""
        launches = {k: w.launches for k, w in self.wrappers.items()}
        plain = {k: f.calls for k, f in self.plains.items()}
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

BAND_SHAPES = ((4296, 4296, "4096^2 band slab"), (1256, 20680, "20480^2 band slab"))
EDGE_SHAPES = ((9, 45, "H<16"), (37, 1001, "ragged width"))


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
        # K4 at the flow K3 found
        got = kernel_matrices.update_matrices(r0, r1, rx, ry)
        line["K4"] = rel_ok("K4", got, kernel_matrices.update_matrices_plain(r0, r1, rx, ry))
        del got
        # K1: the band image pulled by that flow, and by +-20 px
        img = (mov / 255).contiguous()
        nfx, nfy = -rx, -ry
        line["K1"] = abs_ok("K1", kernel_sample.sample_displaced(img, nfx, nfy),
                            kernel_sample.sample_displaced_plain(img, nfx, nfy), 1e-5)
        big = torch.from_numpy(((rng.random((2, h, w)) - 0.5) * 40).astype(np.float32)).to(dev)
        line["K1"] = max(line["K1"], abs_ok(
            "K1", kernel_sample.sample_displaced(img, big[0:1].contiguous(), big[1:2].contiguous()),
            kernel_sample.sample_displaced_plain(img, big[0:1].contiguous(), big[1:2].contiguous()), 1e-5))
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
                times[k] = (min(k1, k2), min(p1, p2))
        for k in ("K1", "K2", "K3", "K4"):
            t = f" kernel {times[k][0]:.4f} ms plain {times[k][1]:.4f} ms" if k in times else ""
            log(f"[kernels] {k} {label} {h}x{w}: max_abs_err {line[k]:.3e} ({TOL[k]}){t}")
        return times

    t4k, t20k = (case(h, w, label, timed=True) for h, w, label in BAND_SHAPES)
    for h, w, label in EDGE_SHAPES:
        case(h, w, label, timed=False)
    for k in results:
        results[k]["ms"], results[k]["plain_ms"] = t4k[k]
        results[k]["ms_20k_band"], results[k]["plain_ms_20k_band"] = t20k[k]
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


def check_k5(dev, rng, planes=((8,) + BAND_SHAPES[0], (2,) + BAND_SHAPES[1])) -> dict:
    """K5 against its plain version and against N K1 launches (one a plane,
    the per-plane apply's path), bit for bit, under a +-20 px random flow."""
    from microaligner_tpu_torch.ops import kernel_sample as ks

    res = {"max_abs_err": 0.0}
    cases = [(n, h, w, label, True) for n, h, w, label in planes]
    cases += [(3, h, w, label, False) for h, w, label in EDGE_SHAPES]
    for n, h, w, label, timed in cases:
        imgs = torch.from_numpy(rng.random((n, h, w), dtype=np.float32)).to(dev)
        flow = torch.from_numpy(((rng.random((2, h, w)) - 0.5) * 40).astype(np.float32)).to(dev)
        fx, fy = flow[0].contiguous(), flow[1].contiguous()
        got = ks.sample_displaced_multi(imgs, fx, fy)
        want = ks.sample_displaced_multi_plain(imgs, fx, fy)
        per_plane = torch.stack([ks.sample_displaced(imgs[i : i + 1], fx[None], fy[None])[0]
                                 for i in range(n)])
        err = max(float((got - want).abs().max()), float((got - per_plane).abs().max()))
        res["max_abs_err"] = max(res["max_abs_err"], err)
        require(torch.equal(got, want) and torch.equal(got, per_plane),
                f"K5 {label}: not bit-equal to its plain version and to {n} K1 launches (err {err})")
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
            key = "" if label.startswith("4096") else "_20k_band"
            res["ms" + key], res["k1_x%d_ms" % n + key], res["plain_ms" + key] = (
                min(k_1, k_2), min(n1, n2), min(p1, p2))
            t = (f" kernel {min(k_1, k_2):.4f} ms, {n} x K1 {min(n1, n2):.4f} ms, "
                 f"plain {min(p1, p2):.4f} ms")
        log(f"[kernels] K5 {label} {n}x{h}x{w}: max_abs_err {err:.3e} ({TOL['K5']}){t}")
        del imgs, flow, fx, fy, got, want, per_plane
    for bad in (lambda: ks.sample_displaced_multi(torch.zeros((2, 4, 4), device=dev),
                                                  torch.zeros((2, 4, 4), device=dev),
                                                  torch.zeros((2, 4, 4), device=dev)),
                lambda: ks.sample_displaced_multi(torch.zeros((2, 4, 4), device=dev, dtype=torch.float16),
                                                  torch.zeros((4, 4), device=dev),
                                                  torch.zeros((4, 4), device=dev))):
        try:
            bad()
        except (TypeError, ValueError):
            pass
        else:
            raise CheckFailed("K5's wrapper accepted an input its kernel does not take")
    return res


# -- phase 3 ---------------------------------------------------------------

def parity_run(dev, rng, n=1024) -> dict:
    from microaligner_tpu_torch.ops.filters import minmax_normalize_u8
    from microaligner_tpu_torch.optflow.registrator import OptFlowRegistrator

    base = texture(rng, n, n, torch.device("cpu"))
    dx, dy = displacement(n, n, 3.0, 0.4, torch.device("cpu"), wavelength=400.0)
    ref = minmax_normalize_u8(base).numpy()
    mov = minmax_normalize_u8(remap_rows(base, dx, dy)).numpy()
    flows, scores, secs = {}, {}, {}
    for name, device in (("cuda", dev), ("cpu", torch.device("cpu"))):
        reg = OptFlowRegistrator(device=device)
        reg.num_pyr_lvl, reg.num_iterations = 3, 3
        reg.tile_size, reg.overlap, reg.band_rows = 500, 100, 256
        reg.use_full_res_img = True
        reg.ref_img, reg.mov_img = ref, mov
        t0 = time.perf_counter()
        flows[name] = reg.register_device().cpu()
        secs[name] = time.perf_counter() - t0
        scores[name] = reg.last_scores
    decisions = {k: [a > b for _, a, b in v] for k, v in scores.items()}
    require(decisions["cuda"] == decisions["cpu"], f"accept/reject differ: {decisions}")
    err = (flows["cuda"] - flows["cpu"]).abs()
    mean, mx = float(err.mean()), float(err.max())
    log(f"[parity] {n}^2 register_device: card {secs['cuda']:.2f} s, cpu plain {secs['cpu']:.2f} s; "
        f"accept/reject {decisions['cuda']} on both; flow diff mean {mean:.3e} max {mx:.3e} px")
    require(bool(torch.isfinite(flows["cuda"]).all()), "non-finite flow")
    require(mean < 1e-4 and mx < 1e-2, f"flow diff mean {mean} max {mx}")
    return {"flow_diff_mean": mean, "flow_diff_max": mx, "decisions": decisions["cuda"],
            "card_s": secs["cuda"], "cpu_s": secs["cpu"]}


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

    report["launches"] = counters.read("main", ("K1", "K2", "K3", "K4"))
    return report, planes


# -- phase 5 ---------------------------------------------------------------

def zstack_apply(dev, rng, counters: Counters, n=4096, n_planes=8, tile=1000, overlap=100) -> dict:
    """Config 4 of the JAX package's bench (``bench.py::bench_zstack_apply``):
    8 u16 planes on the card warped by one flow through ``_apply_flow_planes``
    (K5), held bit for bit against ``_apply_flow_plane`` on each plane (K1)."""
    from microaligner_tpu_torch.pipeline.runner import _apply_flow_plane, _apply_flow_planes
    from microaligner_tpu_torch.tiles import TileGrid

    planes = torch.from_numpy(rng.integers(0, 65535, (n_planes, n, n)).astype(np.uint16)).to(dev)
    ys = torch.arange(n, device=dev, dtype=torch.float32).view(n, 1).expand(n, n)
    xs = torch.arange(n, device=dev, dtype=torch.float32).view(1, n).expand(n, n)
    flow = torch.stack([2.0 * torch.sin(ys / 50), 1.5 * torch.cos(xs / 45)], dim=-1).contiguous()
    grid = TileGrid.for_image((n, n), tile, overlap)

    def per_plane():
        return torch.stack([_apply_flow_plane(p, flow, grid, torch.uint16) for p in planes])

    counters.reset()
    multi = _apply_flow_planes(planes, flow, grid, torch.uint16)
    torch.cuda.synchronize()
    launches = counters.read("zstack", ("K5",))
    require(launches["K1"] == 0, f"zstack: the z-stack apply launched K1 {launches['K1']} times")
    require(multi.dtype == torch.uint16 and multi.shape == planes.shape, f"{multi.dtype} {tuple(multi.shape)}")
    require(torch.equal(multi, per_plane()), "z-stack apply: K5 and K1 a plane differ")
    # order per-plane, K5, K5, per-plane
    t1 = cuda_ms(per_plane, 5)
    m1 = cuda_ms(lambda: _apply_flow_planes(planes, flow, grid, torch.uint16), 5)
    m2 = cuda_ms(lambda: _apply_flow_planes(planes, flow, grid, torch.uint16), 5)
    t2 = cuda_ms(per_plane, 5)
    res = {"multi_ms": min(m1, m2), "per_plane_ms": min(t1, t2), "launches": launches}
    log(f"[zstack] {n_planes} u16 {n}^2 planes, one flow, tile {tile} overlap {overlap}: "
        f"_apply_flow_planes (K5) {res['multi_ms']:.3f} ms, _apply_flow_plane a plane (K1) "
        f"{res['per_plane_ms']:.3f} ms; outputs bit-equal")
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


def write_config(path: Path, stack: Path, out_dir: Path) -> None:
    """The parameters of ``config_examples/config_cycle_stack_optflow_only.yaml``."""
    import yaml

    cfg = yaml.safe_load((ROOT / "config_examples" / "config_cycle_stack_optflow_only.yaml").read_text())
    cfg["Input"]["InputImagePaths"] = {"CycleStack": str(stack)}
    cfg["Output"]["OutputDir"] = str(out_dir)
    path.write_text(yaml.dump(cfg, sort_keys=False))


def run_cli_in_process(cfg: Path, dev) -> tuple:
    """``__main__.main([cfg])`` on ``dev`` with the stage timers on; returns
    (wall seconds, {stage: seconds})."""
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
    stages = {}
    for name, secs in re.findall(r"^\[profile\] (.+): ([0-9.]+)s$", buf.getvalue(), re.M):
        stages[name] = round(stages.get(name, 0.0) + float(secs), 4)
    return wall, stages


def check_cli_output(out: Path, planes, margin: int, label: str, dev) -> dict:
    """The TCZYX stack the CLI wrote: shape and OME sizes, the reference
    cycle bit for bit, and every registered plane's interior MSE to cycle 1
    below a quarter of the unregistered MSE."""
    from microaligner_tpu_torch.io import TiffFile
    from microaligner_tpu_torch.io.ome import extract_pixels_info, str_to_xml

    cycles, channels, nz = len(planes), len(planes[0]), len(planes[0][0])
    h, w = planes[0][0][0].shape
    res = {"mse_before": [], "mse_after": []}

    def mse(a, b):
        return interior_mse(torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev), margin)

    with TiffFile(out) as tf:
        s = tf.series[0]
        info = extract_pixels_info(str_to_xml(tf.ome_metadata))
        want_shape = (cycles * channels, nz, h, w) if nz > 1 else (cycles * channels, h, w)
        require(s.shape == want_shape and s.dtype == np.uint16, f"{label}: {s.shape} {s.dtype}")
        require((int(info["SizeC"]), int(info["SizeZ"]), int(info["SizeT"])) == (cycles * channels, nz, 1),
                f"{label}: OME sizes {info}")
        for c in range(cycles):
            for ch in range(channels):
                for z in range(nz):
                    page = tf.read_page((c * channels + ch) * nz + z)
                    ref = planes[0][ch][z]
                    if c == 0:
                        require(np.array_equal(page, ref), f"{label}: reference plane {ch},{z} changed")
                        continue
                    before, after = mse(planes[c][ch][z], ref), mse(page, ref)
                    res["mse_before"].append(before)
                    res["mse_after"].append(after)
                    require(after < 0.25 * before, f"{label}: cycle {c + 1} ch {ch} z {z} mse {before} -> {after}")
    res["mse_ratio_max"] = max(a / b for a, b in zip(res["mse_after"], res["mse_before"]))
    res["tczyx"] = (1, cycles * channels, nz, h, w)
    return res


def cli_4096(dev, planes, counters: Counters, work: Path) -> dict:
    stack, out1, out2 = work / "stack_4096.ome.tif", work / "out_4096", work / "out_4096_subprocess"
    write_cycle_stack(stack, planes)
    write_config(work / "cfg_4096.yaml", stack, out1)
    write_config(work / "cfg_4096_subprocess.yaml", stack, out2)
    torch.cuda.reset_peak_memory_stats(dev)
    counters.reset()
    wall, stages = run_cli_in_process(work / "cfg_4096.yaml", dev)
    launches = counters.read("cli_4096", ("K1", "K2", "K3", "K4"))
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    res = check_cli_output(out1 / "optflow_reg_result_stack.tif", planes, 200, "cli 4096", dev)
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
        write_config(work / "cfg.yaml", stack, work / "out")
        log(f"[cli] {n}^2 2 cycles x 2 ch x 1 z u16 CycleStack made and written in "
            f"{time.perf_counter() - t0:.2f} s")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        counters.reset()
        wall, stages = run_cli_in_process(work / "cfg.yaml", dev)
        launches = counters.read("cli_20480", ("K1", "K2", "K3", "K4"))
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        pinned = torch.cuda.host_memory_stats().get("allocated_bytes.peak", 0)
        margin = max(64, n // 40)  # 512 px at 20480^2, as bench.py's config 5b
        res = check_cli_output(work / "out" / "optflow_reg_result_stack.tif", planes, margin, "cli 20480", dev)
        res.update(wall_s=wall, stages_s=stages, peak_gib=peak, pinned_host_bytes=pinned,
                   launches=launches)
        log(f"[cli] {n}^2 CLI in process {wall:.2f} s (stage timers on), peak device memory {peak:.2f} GiB, "
            f"pinned host bytes {pinned}; stages {stages}; registered mse / unregistered mse <= "
            f"{res['mse_ratio_max']:.4f}")
        return res
    finally:
        shutil.rmtree(work, ignore_errors=True)


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

    kernels = check_kernels(dev, rng)
    kernels["K5"] = check_k5(dev, rng)
    report["parity"] = parity_run(dev, rng)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    counters = Counters()
    report["main"], stack_planes = main_path(dev, rng, out_dir, counters)
    report["zstack"] = zstack_apply(dev, rng, counters)
    work = Path(tempfile.mkdtemp(prefix="ma_chip_smoke_4k_"))
    try:
        report["cli_4096"] = cli_4096(dev, stack_planes, counters, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    del stack_planes
    report["cli_20480"] = cli_20480(dev, rng, counters)

    report["kernels"] = kernels
    report["total_s"] = time.perf_counter() - t_start
    (out_dir / "chip_smoke_report.json").write_text(json.dumps(report, indent=1, default=str))
    log(f"[done] all phases in {report['total_s']:.1f} s")

    log(smi)
    sources = {"K1": ("sample_displaced", "sample.cu", "microaligner_tpu/ops/pallas_sample.py:53"),
               "K2": ("poly_pair_m", "poly.cu", "microaligner_tpu/ops/pallas_poly.py:172"),
               "K3": ("smooth5_solve", "agg.cu", "microaligner_tpu/ops/pallas_agg.py:160"),
               "K4": ("update_matrices", "matrices.cu", "microaligner_tpu/ops/pallas_matrices.py:63"),
               "K5": ("sample_displaced_multi", "sample.cu", "microaligner_tpu/ops/pallas_sample.py:183")}
    # each path's launches, counted from 0 just before it and read just after
    paths = (report["main"], report["zstack"], report["cli_4096"], report["cli_20480"])
    launches = {k: sum(path["launches"][k] for path in paths) for k in sources}
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": f"microaligner_tpu_torch/csrc/{src}",
         "replaces": replaces, "launches": launches[k],
         "max_abs_err": kernels[k]["max_abs_err"], "ms": kernels[k]["ms"],
         "plain_ms": kernels[k]["plain_ms"]}
        for k, (name, src, replaces) in sources.items()
    ]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
