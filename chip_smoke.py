#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``microaligner_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

Run it from the repository root; it needs one card and takes no arguments.  Phases, each printing its own lines:

1. build: compile ``microaligner_tpu_torch/csrc/*.cu`` with nvcc for sm_90a;
2. kernels: K1-K4 against their plain PyTorch versions on the card, at the
   main path's band shapes (4296 x 4296, 1256 x 20680) and edge cases, with
   CUDA-event times of kernel and plain version;
3. parity: a 1024^2 pair through ``OptFlowRegistrator.register_device`` on
   the card against the same pair through the plain versions on the CPU;
4. main path: the CLI's cycle loop (z-max projection, ``register_device``,
   ``warp_device``, per-plane apply) over a synthetic 3-cycle x 2-channel x
   3-z u16 4096^2 stack, then a 2-cycle 20480^2 u8 register and a one-plane
   apply, with stage times, peak device memory and the kernels' launch counts,
   and one 4096^2 register under torch.profiler (device time by kernel and
   the device's busy share; the table goes to ``chiprun_out/``).

The last lines are the card's name and power limit as nvidia-smi prints
them, a JSON object with one entry per kernel, and ``{"ok": true, ...}``.
Any failed check raises and the script exits non-zero.  Without a CUDA
device it exits non-zero before printing anything.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
TOL = {"K1": "atol 1e-5", "K2": "1e-5*max|plain|+1e-6", "K3": "atol 1e-4 px", "K4": "1e-5*max|plain|+1e-6"}


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


def main_path(dev, rng, out_dir: Path, n_stack=4096, n_big=20480, tile=1000,
              overlap=100) -> dict:
    from microaligner_tpu_torch.ops import kernel_agg, kernel_matrices, kernel_poly, kernel_sample
    from microaligner_tpu_torch.ops.filters import minmax_normalize_u8
    from microaligner_tpu_torch.optflow.registrator import OptFlowRegistrator
    from microaligner_tpu_torch.optflow.warper import Warper
    from microaligner_tpu_torch.pipeline.runner import _apply_flow_plane
    from microaligner_tpu_torch.tiles import TileGrid
    from microaligner_tpu_torch.utils.pages import max_project_u8

    wrappers = {"K1": kernel_sample.sample_displaced, "K2": kernel_poly.poly_pair_m,
                "K3": kernel_agg.smooth5_solve, "K4": kernel_matrices.update_matrices}
    plains = [kernel_sample.sample_displaced_plain, kernel_poly.poly_pair_m_plain,
              kernel_agg.smooth5_solve_plain, kernel_matrices.update_matrices_plain]
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

    for w in wrappers.values():
        w.launches = 0
    plain_calls = [p.calls for p in plains]
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
    del planes, applied, ref_img, ref0, flow

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

    report["launches"] = {k: w.launches for k, w in wrappers.items()}
    report["plain_calls"] = [p.calls - c for p, c in zip(plains, plain_calls)]
    log(f"[main] kernel launches {report['launches']}; plain versions called {report['plain_calls']}")
    require(all(v > 0 for v in report["launches"].values()), "a kernel of the path was never launched")
    require(not any(report["plain_calls"]), "a plain version ran on the main path")
    return report


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
    report["parity"] = parity_run(dev, rng)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    report["main"] = main_path(dev, rng, out_dir)

    report["kernels"] = kernels
    (out_dir / "chip_smoke_report.json").write_text(json.dumps(report, indent=1, default=str))

    log(smi)
    sources = {"K1": ("sample_displaced", "sample.cu", "microaligner_tpu/ops/pallas_sample.py:53"),
               "K2": ("poly_pair_m", "poly.cu", "microaligner_tpu/ops/pallas_poly.py:172"),
               "K3": ("smooth5_solve", "agg.cu", "microaligner_tpu/ops/pallas_agg.py:160"),
               "K4": ("update_matrices", "matrices.cu", "microaligner_tpu/ops/pallas_matrices.py:63")}
    launches = report["main"]["launches"]
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
