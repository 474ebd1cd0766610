"""The port's spans and counters (``utils/logging.py``) on a tiny chained
registration on the CPU: FeatureReg, the streamed affine apply, OptFlowReg,
the Warper and the streamed flow apply, once with
``MICROALIGNER_TPU_PROFILE`` unset and once with it set.

Off, nothing is recorded and no ``record_function``, CUDA event or
synchronise is taken.  On, the span tree carries the stage names and their
attributes, every child lies inside its parent, the apply's worker threads
hang under the call's ``pipeline.apply`` span, the ``[profile]`` lines are
as before, the ``features.knn`` counter agrees with the features and with
``match.near_ties``, the ``features.keypoints`` counter with each call's
keypoint rows, and every result is bit-identical to the run with
profiling off.  Each projected page is a ``pages.copy`` span under its
``pages.project``, and each applied plane's device-to-host copy an
``apply.fetch`` span under its ``apply.write``.  On a half-blank image, on
each of the three feature paths, the keypoint counter counts the tiles with
no keypoint.
"""

import contextlib
import io
import os
import re
import threading
from unittest import mock

import cv2 as cv
import numpy as np
import pytest
import torch

from microaligner_tpu_torch import FeatureRegistrator, OptFlowRegistrator, Warper
from microaligner_tpu_torch.features import match as tmatch
from microaligner_tpu_torch.features import registrator as tregistrator
from microaligner_tpu_torch.features import tile_features as ttf
from microaligner_tpu_torch.ops.warp import inverse_of
from microaligner_tpu_torch.pipeline import runner
from microaligner_tpu_torch.pipeline.apply import stream_apply
from microaligner_tpu_torch.tiles import TileGrid
from microaligner_tpu_torch.utils import logging as plog
from microaligner_tpu_torch.utils.pages import max_project_u8

torch.set_num_threads(1)

PROFILE = "MICROALIGNER_TPU_PROFILE"
SHAPE = (480, 480)
CHANNELS, Z = 2, 2
FEATURE_FACTORS = [4, 2]
FEATURE_ROUNDS = 2
FLOW_FACTORS = [4, 2, 1]
MATCH_LINE = re.compile(r"^\[profile\] feature lvl\d+ match: ([0-9.]+)s$", re.M)  # features.match_s's


def _planes(seed: int):
    """(reference, moving) u16 cycles of (CHANNELS, Z, H, W): a texture and
    its copy moved by an affine of a few pixels."""
    rng = np.random.default_rng(seed)
    h, w = SHAPE
    ref = np.empty((CHANNELS, Z, h, w), np.uint16)
    for c in range(CHANNELS):
        for z in range(Z):
            img = cv.GaussianBlur(rng.random((h, w), dtype=np.float32), (0, 0), 2.0)
            ref[c, z] = cv.normalize(img, None, 200, 60000, cv.NORM_MINMAX).astype(np.uint16)
    t = cv.getRotationMatrix2D((w / 2, h / 2), 0.8, 1.0)
    t[:, 2] += (6.0, -4.0)
    mov = np.stack([[cv.warpAffine(ref[c, z], t, (w, h)) for z in range(Z)] for c in range(CHANNELS)])
    return ref, mov


def _items(planes):
    for c in range(planes.shape[0]):
        for z in range(planes.shape[1]):
            yield (c, z), planes[c, z]


def _chain(ref, mov) -> dict:
    """The CLI's per-cycle steps on the CPU, as the benchmark drives them."""
    dev = torch.device("cpu")
    h, w = SHAPE
    freg = FeatureRegistrator(device=dev)
    freg.num_pyr_lvl, freg.num_iterations, freg.tile_size = 2, FEATURE_ROUNDS, 500
    freg.use_full_res_img, freg.use_dog = False, True
    freg.ref_img = ref_img = max_project_u8(iter(ref[0]), dev)
    freg.mov_img = max_project_u8(iter(mov[0]), dev)
    tmat = freg.register()
    inv = inverse_of(tmat)
    affine_out = np.zeros_like(mov)
    stream_apply(_items(mov), lambda img: runner._apply_affine_plane(img, inv, h, w, torch.uint16, True),
                 lambda key, plane: np.copyto(affine_out[key], plane), device=dev)
    ofreg = OptFlowRegistrator(device=dev)
    ofreg.num_pyr_lvl, ofreg.num_iterations, ofreg.tile_size, ofreg.overlap = 2, 2, 100, 16
    ofreg.use_full_res_img = True
    ofreg.ref_img = ref_img
    ofreg.mov_img = moved = max_project_u8(iter(affine_out[0]), dev)
    flow = ofreg.register_device()
    warper = Warper(device=dev)
    warper.tile_size, warper.overlap = 100, 16
    warper.image, warper.flow = moved, flow
    warped = warper.warp_device()
    grid = TileGrid.for_image(tuple(flow.shape[:2]), 100, 16)
    flow_out = np.zeros_like(mov)
    stream_apply(_items(affine_out), lambda img: runner._apply_flow_plane(img, flow, grid, torch.uint16),
                 lambda key, plane: np.copyto(flow_out[key], plane), device=dev)
    return {"tmat": np.asarray(tmat), "flow": flow.numpy(), "warped": warped.numpy(), "affine_out": affine_out,
            "flow_out": flow_out, "ref_valid": [int(f.valid.sum()) for f in freg._ref_pyr_features]}


class _Spy:
    """Counts calls of the torch entry points a span would take."""

    def __init__(self):
        self.calls = {}

    def wrap(self, name, fn):
        def spy(*args, **kwargs):
            self.calls[name] = self.calls.get(name, 0) + 1
            return fn(*args, **kwargs)
        return spy


def _keeping_valid(found: list):
    """``find_features_tiled`` that appends (tiles, k, valid) of each call
    to ``found``."""
    inner = ttf.find_features_tiled

    def find(img, grid, k, *args, **kwargs):
        out = inner(img, grid, k, *args, **kwargs)
        found.append((grid.num_tiles, k, out[2].clone()))
        return out
    return find


def _run(profile: bool, spy=None) -> dict:
    ref, mov = _planes(19)
    before_spans = max((s.id for s in plog.spans()), default=0)
    before_counters = len(plog.counters())
    ties = dict(tmatch.near_ties)
    out = io.StringIO()
    patches = contextlib.ExitStack()
    if spy is not None:
        for owner, attr in ((torch.profiler, "record_function"), (torch.cuda, "Event"), (torch.cuda, "synchronize")):
            patches.enter_context(mock.patch.object(owner, attr, spy.wrap(attr, getattr(owner, attr))))
    found = []
    find = _keeping_valid(found)
    for owner in (ttf, tregistrator):
        patches.enter_context(mock.patch.object(owner, "find_features_tiled", find))
    old = os.environ.pop(PROFILE, None)
    if profile:
        os.environ[PROFILE] = "1"
    try:
        with patches, contextlib.redirect_stdout(out):
            result = _chain(ref, mov)
    finally:
        os.environ.pop(PROFILE, None)
        if old is not None:
            os.environ[PROFILE] = old
    result["spans"] = [s for s in plog.spans() if s.id > before_spans]
    result["counters"] = plog.counters()[before_counters:]
    result["log"] = out.getvalue()
    result["ties"] = {k: tmatch.near_ties[k] - ties[k] for k in ("calls", "rows")}
    result["found"] = found
    return result


@pytest.fixture(scope="module")
def runs():
    spy = _Spy()
    off = _run(False, spy)
    off["spy"] = spy.calls
    return {"off": off, "on": _run(True)}


def _named(spans, name):
    return [s for s in spans if s.name == name]


def test_off_records_nothing(runs):
    off = runs["off"]
    assert off["spans"] == [] and off["counters"] == []
    assert "[profile]" not in off["log"]
    assert plog.current_span() is None


def test_off_takes_no_record_function_event_or_synchronise(runs):
    assert runs["off"]["spy"] == {}


def test_span_tree_names_and_attributes(runs):
    spans = runs["on"]["spans"]
    names = {s.name for s in spans}
    assert names >= {"features.register", "features.reference_pyramid", "features.level", "features.find",
                     "features.match", "features.ransac", "features.gate", "optflow.register", "optflow.pyramid",
                     "optflow.level", "optflow.dog", "optflow.flow", "optflow.gate", "optflow.carry",
                     "optflow.prewarp", "optflow.warp", "pages.project", "pages.copy", "pipeline.apply",
                     "apply.read", "apply.stage", "apply.wait_plane", "apply.warp", "apply.write", "apply.fetch"}
    assert [s.attrs["factor"] for s in _named(spans, "features.level")] == FEATURE_FACTORS
    rounds = [(f, i) for f in FEATURE_FACTORS for i in range(FEATURE_ROUNDS)]
    for name in ("features.find", "features.match", "features.ransac", "features.gate"):
        assert [(s.attrs["factor"], s.attrs["iteration"]) for s in _named(spans, name)] == rounds, name
    for name in ("optflow.level", "optflow.dog", "optflow.flow", "optflow.gate", "optflow.carry"):
        assert [s.attrs["factor"] for s in _named(spans, name)] == FLOW_FACTORS, name
    assert [s.attrs["factor"] for s in _named(spans, "optflow.prewarp")] == FLOW_FACTORS[1:]
    assert [s.attrs["planes"] for s in _named(spans, "pages.project")] == [Z, Z, Z]
    keys = [(c, z) for c in range(CHANNELS) for z in range(Z)]
    assert [s.attrs["planes"] for s in _named(spans, "pipeline.apply")] == [len(keys), len(keys)]
    for name in ("apply.stage", "apply.warp"):
        assert [s.attrs["key"] for s in _named(spans, name)] == keys + keys, name
    # the writers write in no fixed order: each apply writes every key once
    for name in ("apply.write", "apply.fetch"):
        for a in _named(spans, "pipeline.apply"):
            assert sorted(s.attrs["key"] for s in _named(spans, name) if s.root == a.id) == keys, name
        assert len(_named(spans, name)) == 2 * len(keys), name
    for s in _named(spans, "apply.stage") + _named(spans, "apply.write") + _named(spans, "apply.fetch"):
        assert s.attrs["bytes"] == SHAPE[0] * SHAPE[1] * 2
    # a read span a plane, and one that finds the iterable exhausted
    assert [s.attrs.get("key") for s in _named(spans, "apply.read")] == keys + [None] + keys + [None]
    roots = {s.name: s for s in spans if s.parent is None}
    assert set(roots) == {"features.register", "pages.project", "pipeline.apply", "optflow.register",
                          "optflow.warp"}


def test_every_child_inside_its_parent(runs):
    spans = runs["on"]["spans"]
    by_id = {s.id: s for s in spans}
    children = [s for s in spans if s.parent is not None]
    assert len(children) > 50
    for s in children:
        p = by_id[s.parent]
        assert p.t0_ns <= s.t0_ns <= s.t1_ns <= p.t1_ns, (s.name, p.name)
        assert s.root == p.root
    for s in spans:
        if s.parent is None:
            assert s.root == s.id


def test_page_copies_under_the_projection(runs):
    """One ``pages.copy`` a projected page, each a child of its
    ``pages.project``, their bytes the pages' bytes; no timing events."""
    spans = runs["on"]["spans"]
    projections = _named(spans, "pages.project")
    copies = _named(spans, "pages.copy")
    assert len(projections) == 3 and len(copies) == 3 * Z
    for p in projections:
        mine = [s for s in copies if s.parent == p.id]
        assert len(mine) == p.attrs["planes"] == Z
        assert sum(s.attrs["bytes"] for s in mine) == Z * SHAPE[0] * SHAPE[1] * 2
        assert all(s.thread == p.thread and s.root == p.root for s in mine)
    assert {s.parent for s in copies} == {p.id for p in projections}
    assert all(s.events is None for s in copies)


def test_fetch_under_the_write(runs):
    """One ``apply.fetch`` a plane, each the child of that plane's
    ``apply.write`` on the writer thread, inside it."""
    spans = runs["on"]["spans"]
    writes = {s.id: s for s in _named(spans, "apply.write")}
    fetches = _named(spans, "apply.fetch")
    assert len(fetches) == len(writes) == 2 * CHANNELS * Z
    for s in fetches:
        w = writes[s.parent]
        assert s.attrs == {"key": w.attrs["key"], "bytes": w.attrs["bytes"]}
        assert s.thread == w.thread == "stream_apply_writer" and s.events is None
    assert len({s.parent for s in fetches}) == len(writes)


def test_worker_thread_spans_under_the_apply(runs):
    spans = runs["on"]["spans"]
    applies = {s.id: s for s in _named(spans, "pipeline.apply")}
    threads = {"apply.read": "stream_apply_reader", "apply.stage": "stream_apply_reader",
               "apply.write": "stream_apply_writer", "apply.wait_plane": threading.main_thread().name,
               "apply.warp": threading.main_thread().name}
    for name, thread in threads.items():
        found = _named(spans, name)
        assert found, name
        for s in found:
            assert s.parent in applies and s.root == applies[s.parent].root, name
            assert s.thread == thread, name


def test_reading_does_not_consume(runs):
    a, b = plog.spans(), plog.spans()
    assert a == b and set(runs["on"]["spans"]) <= set(a)
    assert plog.counters() == plog.counters()
    assert len(plog.counters()) >= len(runs["on"]["counters"])


def test_profile_lines_as_before(runs):
    on = runs["on"]["log"]
    n_rounds = len(FEATURE_FACTORS) * FEATURE_ROUNDS
    assert len(MATCH_LINE.findall(on)) == n_rounds
    for step in ("find", "match", "ransac", "gate"):
        found = re.findall(rf"^\[profile\] feature lvl(\d+) {step}: [0-9]+\.[0-9]{{3}}s$", on, re.M)
        assert [int(f) for f in found] == [f for f in FEATURE_FACTORS for _ in range(FEATURE_ROUNDS)], step
    for label in ("feature reference pyramid", "whole register", "lvl4 fused level+carry",
                  "lvl2 fused level+carry", "lvl1 fused level+carry", "feature lvl4", "feature lvl2"):
        assert len(re.findall(rf"^\[profile\] {re.escape(label)}: [0-9]+\.[0-9]{{3}}s$", on, re.M)) == 1, label
    # the same lines as the rest of the log, and nothing else printed
    assert [ln for ln in on.splitlines() if not ln.startswith("[profile] ")] == runs["off"]["log"].splitlines()


def test_knn_counter(runs):
    on = runs["on"]
    knn = [c for c in on["counters"] if c.name == "features.knn"]
    n_rounds = len(FEATURE_FACTORS) * FEATURE_ROUNDS
    assert len(knn) == n_rounds == on["ties"]["calls"]
    # the moving side's valid rows: the log's "Good matches n / valid" of each round
    valid = [int(v) for v in re.findall(r"Good matches \d+ / (\d+)", on["log"])]
    assert [int(c.values["query_valid"]) for c in knn] == valid
    assert [int(c.values["train_valid"]) for c in knn] == [v for v in on["ref_valid"] for _ in range(FEATURE_ROUNDS)]
    assert sum(c.values["ties"] for c in knn) == on["ties"]["rows"]
    for c in knn:
        assert c.values["width"] == 200 and c.values["dtype"] == "float32"
        assert c.values["path"] == "plain"  # K8 runs only on the card's bf16 route
        assert c.values["query_rows"] >= int(c.values["query_valid"]) > 0
        assert c.values["train_rows"] >= int(c.values["train_valid"]) > 0
    by_id = {s.id: s for s in on["spans"]}
    assert all(by_id[c.span].name == "features.match" for c in knn)


def _check_keypoints(record, tiles: int, k: int, valid: torch.Tensor) -> None:
    v = record.values
    assert v["rows"] == tiles * k and v["tiles"] == tiles
    assert isinstance(v["valid"], torch.Tensor) and isinstance(v["empty_tiles"], torch.Tensor)
    assert int(v["valid"]) == int(valid.sum()) <= v["rows"]
    assert int(v["empty_tiles"]) == int((~valid.view(tiles, k).any(dim=1)).sum())


def test_keypoints_counter(runs):
    on, off = runs["on"], runs["off"]
    assert not [c for c in off["counters"] if c.name == "features.keypoints"]
    keypoints = [c for c in on["counters"] if c.name == "features.keypoints"]
    # one a call of find_features_tiled, the reference's levels and every round's
    assert len(keypoints) == len(on["found"]) == len(off["found"]) > 0
    for c, (tiles, k, valid) in zip(keypoints, on["found"]):
        _check_keypoints(c, tiles, k, valid)
    by_id = {s.id: s for s in on["spans"]}
    finds = _named(on["spans"], "features.find")
    in_find = [c for c in keypoints if c.span is not None and by_id[c.span].name == "features.find"]
    assert [c.span for c in in_find] == [s.id for s in finds]
    assert len(in_find) == len(FEATURE_FACTORS) * FEATURE_ROUNDS
    # a round's valid rows are the knn's query rows of that round
    knn = [c for c in on["counters"] if c.name == "features.knn"]
    assert [int(c.values["valid"]) for c in in_find] == [int(c.values["query_valid"]) for c in knn]
    assert [c.values["rows"] for c in in_find] == [c.values["query_rows"] for c in knn]


@pytest.mark.parametrize("path", ["dense", "banded", "per_tile"])
def test_keypoints_counter_counts_empty_tiles(monkeypatch, path):
    env = {"dense": {"MICROALIGNER_TPU_FEATURE_DENSE": "1"},
           "banded": {"MICROALIGNER_TPU_FEATURE_DENSE": "auto", "MICROALIGNER_TPU_FEATURE_DENSE_MAX_MPIX": "1e-9"},
           "per_tile": {"MICROALIGNER_TPU_FEATURE_DENSE": "0"}}[path]
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    rng = np.random.default_rng(23)
    img = cv.GaussianBlur(rng.random((240, 240), dtype=np.float32), (0, 0), 1.5)
    img = cv.normalize(img, None, 0, 255, cv.NORM_MINMAX).astype(np.uint8)
    img[:, 150:] = 0  # the last column of tiles and FAST's circle around it see only blank
    grid = TileGrid.for_image(img.shape, 80, ttf.HALO)
    k = ttf.features_per_tile(grid)
    x = torch.from_numpy(img)
    monkeypatch.delenv(PROFILE, raising=False)
    before = len(plog.counters())
    plain = ttf.find_features_tiled(x, grid, k)
    assert len(plog.counters()) == before
    monkeypatch.setenv(PROFILE, "1")
    traced = ttf.find_features_tiled(x, grid, k)
    new = plog.counters()[before:]
    assert [c.name for c in new] == ["features.keypoints"]
    for a, b in zip(plain, traced):
        assert torch.equal(a, b)
    _check_keypoints(new[0], grid.num_tiles, k, traced[2])
    assert grid.num_tiles == 9 and int(new[0].values["empty_tiles"]) == 3
    assert 0 < int(new[0].values["valid"]) < new[0].values["rows"]


def test_results_bit_identical_with_profiling(runs):
    on, off = runs["on"], runs["off"]
    for key in ("tmat", "flow", "warped", "affine_out", "flow_out"):
        assert np.array_equal(on[key], off[key]), key
    assert not np.array_equal(on["tmat"], np.eye(2, 3)) and np.abs(on["flow"]).max() > 0


def test_cpu_spans_take_no_device_time(runs):
    assert all(s.events is None and plog.device_s(s) is None for s in runs["on"]["spans"])


def test_parent_passed_to_a_thread_and_a_failing_block(monkeypatch, capsys):
    monkeypatch.setenv(PROFILE, "1")
    seen = {}
    with plog.span("outer", attr=1) as outer:
        parent = plog.current_span()

        def work():
            with plog.span("inner", parent=parent) as s:
                seen["inner"] = s
        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
    assert seen["inner"].parent == outer.id and seen["inner"].root == outer.root == outer.id
    with pytest.raises(ValueError):
        with plog.stage_timer("a failing stage", name="test.fail"):
            raise ValueError
    assert plog.current_span() is None
    assert plog.spans()[-1].name == "test.fail" and plog.spans()[-1].t1_ns is not None
    with plog.stage_timer("a stage", name="test.stage", level=3):
        pass
    assert re.fullmatch(r"\[profile\] a stage: [0-9]+\.[0-9]{3}s\n", capsys.readouterr().out)
    assert plog.spans()[-1].attrs == {"level": 3}
