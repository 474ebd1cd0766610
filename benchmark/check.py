"""The comparison that decides ``correct``: the last cycle of the window
against the plain reference (``benchmark/reference/``).

The judged cycle is the window's last: its flow is still on the device when
the window closes, so keeping it costs the window no time and no memory,
and the program cannot tell which cycle will be last.  What it produced is
compared with what the reference computes from the same inputs:

* ``matrix_px`` (FeatureReg only): the largest distance at the plane's four
  corners between the program's 2x3 matrix and the reference's register of
  the reference's own projections of the input planes;
* ``flow_mean_px``: the mean over the pixels of |program flow - reference
  flow| (both components), the reference registering its own projection of
  the cycle's OptFlowReg input against its own rebuild of the chain's
  state: the cycle before's reference channel (through the program's
  matrix of that cycle, under FeatureReg) warped by the program's flow of
  that cycle;
* ``planes_max``: the largest |difference| in intensity units over every
  plane the cycle applied (FeatureReg's affine apply by the program's
  matrix, OptFlowReg's apply by the program's flow), the warped reference
  channel and the chain's state the cycle registered against, each against
  the reference's warp of the same input by the same transform.

The reference computes in the precision that the configuration's
``precision`` block states for each stage (:func:`precision`), which is
what its ``route`` variables make the port compute in.  The control
(``control.py``) is the reference one step below each stage
(``CONTROL_STEP``): TF32 significands below float32, fp8 e4m3's below bf16.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import features as ref_features
from benchmark.reference import optflow as ref_optflow
from benchmark.reference.filters import FP8, TF32, minmax_normalize_u8
from benchmark.reference.kernels import FlowPrecision
from benchmark.reference.tiles import calculate_padding_size, zero_pad
from benchmark.reference.warps import affine_warp_bands, inverse_of

_OPERANDS = {"float32": torch.float32, "tf32": TF32, "bfloat16": torch.bfloat16, "fp8": FP8}
# what each stage of a configuration's ``precision`` block may name, as the reference computes it
STAGES = {
    "daisy": _OPERANDS,  # the operands of DAISY's ring-blur products
    "match": _OPERANDS,  # the operands of the knn cross term
    "flow": {  # Farneback: R and M stored in bf16, or M alone (``_m``), or float32
        "float32": FlowPrecision(), "tf32": FlowPrecision(ops_bits=10),
        "bfloat16": FlowPrecision(r_bits=7, m_bits=7), "bfloat16_m": FlowPrecision(m_bits=7),
        "fp8": FlowPrecision(r_bits=3, m_bits=3), "fp8_m": FlowPrecision(m_bits=3),
    },
    "warp": {"float32": None, "tf32": 10},  # the warps' taps and fractions: significand bits
}
CONTROL_STEP = {"float32": "tf32", "bfloat16": "fp8", "bfloat16_m": "fp8_m"}


def precision(config: dict, control: bool = False) -> dict:
    """The reference's precision for each stage of the configuration's
    ``precision`` block; with ``control``, one step below each.  Raises
    where a stage or a name is not one the reference computes in."""
    names = dict(config["precision"])
    stages = {"flow", "warp"} | ({"daisy", "match"} if config.get("FeatureReg") is not None else set())
    if set(names) != stages:
        raise ValueError(f"precision: the configuration's stages are {sorted(stages)}, got {sorted(names)}")
    out = {}
    for stage, name in names.items():
        if control:
            if name not in CONTROL_STEP:
                raise ValueError(f"precision: {stage} {name!r} has no step below it")
            name = CONTROL_STEP[name]
        if name not in STAGES[stage]:
            raise ValueError(f"precision: {stage} {name!r} is none of {sorted(STAGES[stage])}")
        out[stage] = STAGES[stage][name]
    return out


def project(planes: np.ndarray, ref_channel: int, device) -> torch.Tensor:
    """z-max of the reference channel's planes, min-max normalised to u8."""
    proj = None
    for p in planes[ref_channel]:
        t = torch.from_numpy(np.ascontiguousarray(p)).to(device).to(torch.float32)
        proj = t if proj is None else torch.maximum(proj, t)
    return minmax_normalize_u8(proj)


def affine_plane(plane: np.ndarray, tmat: np.ndarray, shape, device, bits=None) -> torch.Tensor:
    """Pad to ``shape`` and warp by the forward matrix, truncating back to
    the plane's dtype (the CLI's FeatureReg apply)."""
    img = torch.from_numpy(np.ascontiguousarray(plane)).to(device)
    h, w = shape
    left, right = calculate_padding_size(w, img.shape[1])
    top, bottom = calculate_padding_size(h, img.shape[0])
    padded = zero_pad(img, top, bottom, left, right)
    if np.array_equal(np.asarray(tmat, np.float64), np.eye(2, 3)):
        return padded
    return affine_warp_bands(padded, inverse_of(tmat), h, w, bits).to(padded.dtype)


def affine_planes(planes: np.ndarray, tmat: np.ndarray, shape, device, bits=None) -> np.ndarray:
    """:func:`affine_plane` of every (channel, z) plane, on the host."""
    return np.stack([np.stack([affine_plane(p, tmat, shape, device, bits).cpu().numpy() for p in ch])
                     for ch in planes])


def corner_gap(a: np.ndarray, b: np.ndarray, shape) -> float:
    h, w = shape
    pts = np.array([[0, 0, 1], [w - 1, 0, 1], [0, h - 1, 1], [w - 1, h - 1, 1]], float).T
    return float(np.abs(np.asarray(a) @ pts - np.asarray(b) @ pts).max())


def chain_state(config: dict, ref_cycle: np.ndarray, prev_planes: np.ndarray, prev: dict, device, prec: dict,
                ref_channel: int) -> torch.Tensor:
    """The u8 image a cycle registers against: the reference cycle's
    projection where no cycle came before (``prev`` empty), else the cycle
    before's reference channel (through its matrix ``prev["tmat"]`` under
    FeatureReg) projected and warped by its flow ``prev["flow"]``."""
    if "flow" not in prev:
        return project(ref_cycle, ref_channel, device)
    src = prev_planes[ref_channel : ref_channel + 1]
    if "tmat" in prev:
        src = affine_planes(src, prev["tmat"], tuple(config["plane"]), device, prec["warp"])
    return ref_optflow.warp(project(src, 0, device), prev["flow"].to(device), config["OptFlowReg"], prec["warp"])


def in_place_of_program(config: dict, ref_cycle: np.ndarray, planes: np.ndarray, ref_in: torch.Tensor,
                        device, prec: dict, ref_channel: int) -> dict:
    """What the program produces on one cycle, registered against the
    chain's state ``ref_in``, computed by the reference at ``prec``
    (:func:`precision`): the keys of ``port_entry.Cycles.last`` but
    ``prev``, with ``affine_out`` (under FeatureReg) and ``flow_out``."""
    shape = tuple(config["plane"])
    out = {}
    src = planes
    if config.get("FeatureReg") is not None:
        tmat = ref_features.register(project(ref_cycle, ref_channel, device), project(planes, ref_channel, device),
                                     config["FeatureReg"], prec["daisy"], prec["match"])
        src = affine_planes(planes, tmat, shape, device, prec["warp"])
        out.update(tmat=tmat, affine_out=src)
    params = config["OptFlowReg"]
    mov = project(src, ref_channel, device)
    flow = ref_optflow.register(ref_in, mov, params, prec["flow"], prec["warp"])
    out.update(ref_in=ref_in, mov=mov, flow=flow, warped=ref_optflow.warp(mov, flow, params, prec["warp"]))
    out["flow_out"] = np.stack([np.stack([
        ref_optflow.warp(torch.from_numpy(p).to(device), flow, params, prec["warp"]).cpu().numpy() for p in ch])
        for ch in src])
    return out


def readings(config: dict, ref_cycle: np.ndarray, planes: np.ndarray, prev_planes: np.ndarray, judged: dict,
             device, ref_channel: int) -> dict:
    """The numbers compared, for the judged outputs of one cycle (keys of
    ``port_entry.Cycles.last`` plus ``affine_out`` and ``flow_out``);
    ``prev_planes`` are the input planes of the cycle before it."""
    shape = tuple(config["plane"])
    params = config["OptFlowReg"]
    prec = precision(config)
    out = {}
    gaps = []
    src = planes
    if config.get("FeatureReg") is not None:
        ref_tmat = ref_features.register(project(ref_cycle, ref_channel, device),
                                         project(planes, ref_channel, device), config["FeatureReg"],
                                         prec["daisy"], prec["match"])
        out["matrix_px"] = corner_gap(judged["tmat"], ref_tmat, shape)
        for ch in range(planes.shape[0]):
            for z in range(planes.shape[1]):
                want = affine_plane(planes[ch, z], judged["tmat"], shape, device, prec["warp"])
                got = torch.from_numpy(np.ascontiguousarray(judged["affine_out"][ch, z])).to(device)
                gaps.append(_max_gap(got, want))
        src = judged["affine_out"]
    ref_in = chain_state(config, ref_cycle, prev_planes, judged["prev"], device, prec, ref_channel)
    gaps.append(_max_gap(judged["ref_in"].to(device), ref_in))
    mov = project(src, ref_channel, device)
    flow = judged["flow"].to(device)
    want_flow = ref_optflow.register(ref_in, mov, params, prec["flow"], prec["warp"])
    gap = (flow - want_flow).abs()
    out["flow_mean_px"], out["flow_max_px"] = float(gap.mean()), float(gap.max())
    del want_flow, gap, ref_in
    gaps.append(_max_gap(judged["warped"].to(device), ref_optflow.warp(mov, flow, params, prec["warp"])))
    for ch in range(src.shape[0]):
        for z in range(src.shape[1]):
            want = ref_optflow.warp(torch.from_numpy(np.ascontiguousarray(src[ch, z])).to(device), flow, params,
                                    prec["warp"])
            got = torch.from_numpy(np.ascontiguousarray(judged["flow_out"][ch, z])).to(device)
            gaps.append(_max_gap(got, want))
    out["planes_max"] = max(gaps)
    return out


def _max_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.shape != b.shape:
        return float("inf")
    return float((a.to(torch.float64) - b.to(torch.float64)).abs().max())


def verdict(values: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {"value", "limit"}}); a
    missing or non-finite number fails."""
    checks = {}
    ok = True
    for name, limit in limits.items():
        value = values.get(name, float("nan"))
        checks[name] = {"value": value, "limit": limit}
        ok = ok and bool(np.isfinite(value)) and value <= limit
    return ok, checks
