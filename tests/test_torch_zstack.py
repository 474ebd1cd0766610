"""A z-stack cycle through the port's projection and applies on the CPU: a
six-plane u16 stack projected by ``max_project_u8``, and a (4, 6, H, W)
stack streamed through ``stream_apply`` with the runner's affine and flow
plane functions, each held bit for bit against a plain computation and
against itself with ``MICROALIGNER_TPU_PROFILE`` set, where it records one
``pages.copy`` a page and one ``apply.fetch`` a plane.

Every ``stream_apply`` call goes through ``tests/_bounds.py::bounded_call``.
"""

import numpy as np
import pytest
import torch
from _bounds import bounded_call

from microaligner_tpu_torch.ops.warp import inverse_of
from microaligner_tpu_torch.pipeline import runner
from microaligner_tpu_torch.pipeline.apply import stream_apply
from microaligner_tpu_torch.tiles import TileGrid
from microaligner_tpu_torch.utils import logging as plog
from microaligner_tpu_torch.utils.pages import max_project_u8

torch.set_num_threads(1)

PROFILE = "MICROALIGNER_TPU_PROFILE"
CHANNELS, Z = 4, 6
PLANE = (90, 100)  # the input planes; the affine apply pads them to OUT
OUT = (96, 104)
TILE, OVERLAP = 40, 8

_bounded = bounded_call(stream_apply)


def _stack(seed: int, shape=(CHANNELS, Z) + PLANE) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 65536, size=shape, dtype=np.uint16)


def _new_spans(before: int) -> list:
    return [s for s in plog.spans() if s.id > before]


def _last_id() -> int:
    return max((s.id for s in plog.spans()), default=0)


def _plain_projection(stack: np.ndarray) -> torch.Tensor:
    """The z-max in int32, then min-max to u8 with one float32 true
    division, rounded half to even."""
    top = torch.from_numpy(stack.astype(np.int32)).amax(dim=0).to(torch.float32)
    lo, hi = top.min(), top.max()
    scaled = (top - lo) * (torch.tensor(255.0) / (hi - lo))
    return torch.clamp(torch.round(scaled), 0, 255).to(torch.uint8)


@pytest.mark.parametrize("profile", [False, True], ids=["off", "on"])
def test_projection_of_six_planes(monkeypatch, profile):
    stack = _stack(3, (Z,) + PLANE)
    monkeypatch.delenv(PROFILE, raising=False)
    plain = max_project_u8(iter(stack), "cpu")
    assert torch.equal(plain, _plain_projection(stack))
    if profile:
        monkeypatch.setenv(PROFILE, "1")
    before = _last_id()
    got = max_project_u8(iter(stack), "cpu")
    assert torch.equal(got, plain)
    spans = _new_spans(before)
    if not profile:
        assert spans == []
        return
    (project,) = [s for s in spans if s.name == "pages.project"]
    copies = [s for s in spans if s.name == "pages.copy"]
    assert project.attrs["planes"] == len(copies) == Z
    assert all(s.parent == project.id for s in copies)
    assert sum(s.attrs["bytes"] for s in copies) == stack.nbytes


def _flow(seed: int) -> torch.Tensor:
    """A smooth flow of a few px over ``OUT``."""
    h, w = OUT
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    a, b = rng.uniform(0, 2 * np.pi, 2)
    flow = np.stack([2.5 * np.sin(ys / 23.0 + a), 1.7 * np.cos(xs / 31.0 - b)], axis=-1)
    return torch.from_numpy(flow.astype(np.float32))


def _applies():
    """{name: (input plane shape, device_fn)} of the runner's affine apply
    (which pads its plane) and flow apply (of a padded plane)."""
    h, w = OUT
    tmat = np.array([[np.cos(0.01), -np.sin(0.01), 3.5], [np.sin(0.01), np.cos(0.01), -2.25]])
    inv = inverse_of(tmat)
    flow = _flow(5)
    grid = TileGrid.for_image(OUT, TILE, OVERLAP)
    return {"affine": (PLANE, lambda img: runner._apply_affine_plane(img, inv, h, w, torch.uint16, True)),
            "flow": (OUT, lambda img: runner._apply_flow_plane(img, flow, grid, torch.uint16))}


def _stream(stack: np.ndarray, device_fn) -> np.ndarray:
    out = np.zeros((CHANNELS, Z) + OUT, np.uint16)
    items = (((c, z), stack[c, z]) for c in range(CHANNELS) for z in range(Z))
    err, _ = _bounded(items, device_fn, lambda key, plane: np.copyto(out[key], plane), device="cpu")
    assert err is None
    return out


@pytest.mark.parametrize("which", ["affine", "flow"])
def test_stream_apply_over_a_zstack(monkeypatch, which):
    """Streamed, each of the 24 planes equals its own apply alone, with
    profiling off and on; on, one ``apply.fetch`` a plane under its
    ``apply.write``."""
    shape, device_fn = _applies()[which]
    stack = _stack(11, (CHANNELS, Z) + shape)
    monkeypatch.delenv(PROFILE, raising=False)
    alone = np.stack([np.stack([device_fn(torch.from_numpy(stack[c, z])).numpy() for z in range(Z)])
                      for c in range(CHANNELS)])
    padded = runner._pad_plane(torch.from_numpy(stack[0, 0]), *OUT).numpy()
    assert alone.shape == (CHANNELS, Z) + OUT and not np.array_equal(alone[0, 0], padded)
    before = _last_id()
    off = _stream(stack, device_fn)
    assert np.array_equal(off, alone)
    assert _new_spans(before) == []
    monkeypatch.setenv(PROFILE, "1")
    on = _stream(stack, device_fn)
    assert np.array_equal(on, alone)
    spans = _new_spans(before)
    writes = {s.id: s for s in spans if s.name == "apply.write"}
    fetches = [s for s in spans if s.name == "apply.fetch"]
    keys = [(c, z) for c in range(CHANNELS) for z in range(Z)]
    assert sorted(s.attrs["key"] for s in fetches) == keys and len(writes) == len(keys)
    assert all(writes[s.parent].attrs["key"] == s.attrs["key"] for s in fetches)
    assert all(s.attrs["bytes"] == OUT[0] * OUT[1] * 2 for s in fetches)
