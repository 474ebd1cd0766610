"""One run of one cell: set-up, the measured window, the check, the result.

Everything a cell needs is found by name: the cell in ``BENCHMARK.json``,
its configuration in ``configs/<config>.json``, its traffic mix in
``traffic/<traffic>.json``, its limits in ``limits/<cell>.json`` and each
per-layer metric's reader in ``metrics/<metric>.py`` (a ``read(trace)``
that returns a number, or None where it finds nothing to read).

A configuration states its route and its precision as data.  ``route``
maps the port's route variables (``MICROALIGNER_TPU_*``) to the values it
runs with; the run sets them before it imports the port and unsets them at
its end, and refuses an environment that sets any such variable otherwise.
``precision`` names, stage by stage, what that route computes in; the
reference computes in it and the control one step below
(``check.precision``).

The window walks the cell's moving cycles, each through the port's
per-cycle path (``port_entry.Cycles.run``), from the cycle after the
warm-up on, back to back until ``seconds`` have passed; the cycle running
at that moment finishes, and the window ends with it.  ``cycle_s`` is the
window's length over its cycles, ``cycle_p95_s`` the 95th percentile of the
cycles' own walls, ``peak_gib`` the device's peak allocation in the window.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import io
import json
import os
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from benchmark import check, inputs, trace

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "microaligner_tpu")
ROUTE_PREFIX = "MICROALIGNER_TPU_"


def load_cell(root: Path, name: str) -> tuple[dict, dict, dict, dict, dict]:
    """(BENCHMARK.json, cell, configuration, traffic mix, limits) of cell
    ``name``."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {c["name"]: c for c in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[name]
    config = json.loads((HERE / "configs" / f"{cell['config']}.json").read_text())
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    limits = json.loads((HERE / "limits" / f"{name}.json").read_text())
    return bench, cell, config, traffic, limits


def check_config(config: dict) -> None:
    """Raise where the configuration's route or precision is not one a run
    can take: a route variable outside the port's prefix or not a string,
    or a precision the reference or its control does not compute in."""
    for key, value in config["route"].items():
        if not key.startswith(ROUTE_PREFIX) or not isinstance(value, str):
            raise ValueError(f"route: {key}={value!r} is not a {ROUTE_PREFIX}* variable with a string value")
    check.precision(config)
    check.precision(config, control=True)


@contextlib.contextmanager
def route_environment(route: dict):
    """The configuration's ``route`` set in the environment for the block,
    unset after it.  Refuses an environment that sets a ``MICROALIGNER_TPU_``
    variable the route does not, or to another value (the stage timers'
    too: the traced run alone sets them)."""
    stray = {k: v for k, v in os.environ.items() if k.startswith(ROUTE_PREFIX) and route.get(k) != v}
    if stray:
        raise SystemExit(f"the environment sets {stray}; the configuration's route is {route}: "
                         f"unset them to run this configuration")
    os.environ.update(route)
    try:
        yield
    finally:
        for key in route:
            os.environ.pop(key, None)


def read_metric(name: str, t) -> float | None:
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", HERE / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(t)


def walk(traffic: dict, seed: int) -> list:
    """The moving cycles in the order a run walks them, drawn from the
    seed: the first warms up, the window walks them all again and again
    from the second on."""
    rng = np.random.default_rng(seed)
    return [int(c) for c in rng.permutation(np.arange(1, traffic["cycles"]))]


def percentile(values, q: float) -> float:
    """Linear interpolation between the closest ranks (numpy's default)."""
    xs = sorted(values)
    pos = (len(xs) - 1) * q
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def run(root: Path, workload: str, seed: int, seconds: float, traced: bool, device, t_start: float,
        cycles_cls=None, config_override=None) -> dict:
    """One run; returns the result line's object.  ``cycles_cls`` and
    ``config_override`` let the tests drive a run on the CPU at a small
    size, with the timed path broken where they choose, and ``control.py``
    put the control in the program's place."""
    bench, _, config, traffic, limits = load_cell(root, workload)
    if config_override:
        config = {**config, **config_override}
    check_config(config)
    with route_environment(config["route"]):
        return _run(bench, workload, config, traffic, limits, seed, seconds, traced, torch.device(device), t_start,
                    cycles_cls)


def _run(bench, workload, config, traffic, limits, seed, seconds, traced, device, t_start, cycles_cls) -> dict:
    from benchmark.port_entry import PROFILE_VARIABLE, Cycles, build_kernels

    on_card = device.type == "cuda"
    if on_card:
        t0 = time.perf_counter()
        build_kernels()
        log(f"set-up: kernels built or found in {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    planes = inputs.make_planes(config, traffic, seed, device)
    log(f"set-up: inputs {planes.shape} u16 made in {time.perf_counter() - t0:.3f} s")
    order = walk(traffic, seed)
    ref_ch = traffic["reference_channel"]
    out_shape = planes.shape[1:]
    affine_out = np.zeros(out_shape, np.uint16) if config.get("FeatureReg") is not None else None
    flow_out = np.zeros(out_shape, np.uint16)
    for buf in (affine_out, flow_out):  # touch every page before the window
        if buf is not None:
            buf.fill(1)
    program_log = io.StringIO()
    with contextlib.redirect_stdout(program_log):
        cycles = (cycles_cls or Cycles)(config, planes[0], device, ref_ch)
        cycles.run(planes[order[0]], affine_out, flow_out)
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    spans = trace.Spans(device) if traced else None
    span = spans if traced else (lambda _name: contextlib.nullcontext())
    program_log = io.StringIO()
    if traced:
        os.environ[PROFILE_VARIABLE] = "1"
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]
                                      + ([torch.profiler.ProfilerActivity.CUDA] if on_card else []))
        prof.__enter__()
    setup_s = time.perf_counter() - t_start
    walls, judged_cycle, prev_cycle = [], order[0], None
    w0 = time.perf_counter()
    with contextlib.redirect_stdout(program_log):
        k = 1
        while True:
            c = order[k % len(order)]
            t = time.perf_counter()
            with span("cycle"):
                cycles.run(planes[c], affine_out, flow_out, span)
            walls.append(time.perf_counter() - t)
            prev_cycle, judged_cycle = judged_cycle, c
            k += 1
            if time.perf_counter() - w0 >= seconds:
                break
    window_s = time.perf_counter() - w0
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    if traced:
        prof.__exit__(None, None, None)
        os.environ.pop(PROFILE_VARIABLE, None)
    n = len(walls)
    log(f"window: {n} cycles in {window_s:.4f} s (cycle walls {', '.join(f'{x:.4f}' for x in walls)})")

    judged = dict(cycles.last, flow_out=flow_out, affine_out=affine_out)
    cycles.release()
    del cycles
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    values = check.readings(config, planes[0], planes[judged_cycle], planes[prev_cycle], judged, device, ref_ch)
    ok, checks = check.verdict(values, limits)
    log(f"check: cycle {judged_cycle} against the reference in {time.perf_counter() - t0:.3f} s; readings {values}")

    result = {"correct": ok, "attempted": n, "failed": 0}
    dev_info = {"platform": "gpu" if on_card else "cpu",
                "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
                "count": 1, "memory_peak_bytes": int(peak)}
    if not traced:
        metrics = {"cycle_s": window_s / n, "cycle_p95_s": percentile(walls, 0.95), "peak_gib": peak / 2**30,
                   "setup_s": setup_s}
        units = {"cycle_s": "s", "cycle_p95_s": "s", "peak_gib": "GiB", "setup_s": "s"}
        result["metrics"] = {k: {"value": v, "unit": units[k]} for k, v in metrics.items()}
    else:
        ops, marks = trace.timeline(prof) if on_card else ([], [])
        t = SimpleNamespace(spans=spans, cycles=n, planes_applied=spans.count("pipeline.apply") * int(np.prod(out_shape[:2])),
                            log=program_log.getvalue(), ops=ops, marks=marks, config=config)
        result["metrics"] = {}
        for m in bench["per_layer"]:
            if "workloads" in m and workload not in m["workloads"]:
                continue
            value = read_metric(m["name"], t) if (on_card or m["source"] != "device_trace") else None
            if value is not None:
                result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
        if on_card:
            lo, hi = trace.stretch(marks)
            dev_info.update(busy_s=trace.busy_ns(ops, lo, hi) / 1e9, window_s=(hi - lo) / 1e9)
            result["breakdown"] = trace.breakdown(ops, marks, lo, hi)
    result["device"] = dev_info
    result["checks"] = checks
    for name, c in checks.items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    return result
