"""The port's ``utils`` surface against the JAX package's on the same files
and path lists: the same names exported, the same checks passing and the
same exception types raised, the worker knob under its reference name, and
``logging.debug``."""

import contextlib
import io

import numpy as np
import pytest

import microaligner_tpu.utils as jutils
import microaligner_tpu_torch.utils as tutils
from microaligner_tpu.io import MemmapWriter
from microaligner_tpu.utils import logging as jlogging
from microaligner_tpu_torch.utils import logging as tlogging
from microaligner_tpu_torch.utils import workers as tworkers

from test_torch_pipeline import _ome


def test_same_names_exported():
    assert tutils.__all__ == jutils.__all__
    for name in tutils.__all__:
        assert callable(getattr(tutils, name)), name


@pytest.fixture(scope="module")
def tiffs(tmp_path_factory):
    d = tmp_path_factory.mktemp("utils")
    rng = np.random.default_rng(3)
    stack = d / "stack.ome.tif"  # 4-D CZYX: 2 channels x 2 z
    mm = MemmapWriter(stack, (1, 2, 2, 30, 40), np.uint16, description=_ome(["DAPI", "Cy5"], h=30, w=40))
    for c in range(2):
        for z in range(2):
            mm[0, c, z] = rng.integers(0, 60000, (30, 40), dtype=np.uint16)
    mm.close()
    plane = d / "plane.ome.tif"  # a lone plane: no OME Pixels, a 2-D series
    mm = MemmapWriter(plane, (1, 1, 1, 30, 40), np.uint16, description="")
    mm[0, 0, 0] = rng.integers(0, 60000, (30, 40), dtype=np.uint16)
    mm.close()
    three = d / "three.tif"  # three pages, no OME: a 3-D series
    mm = MemmapWriter(three, (1, 3, 1, 30, 40), np.uint16, description="")
    for i in range(3):
        mm[0, i, 0] = rng.integers(0, 60000, (30, 40), dtype=np.uint16)
    mm.close()
    return {"stack": stack, "plane": plane, "three": three}


def _outcome(fn, *args):
    try:
        fn(*args)
    except Exception as exc:  # the outcome compared is the exception's type
        return type(exc)
    return None


@pytest.mark.parametrize("name", ["stack", "plane", "three"])
def test_check_input_has_proper_dimensions(tiffs, name):
    got = _outcome(tutils.check_input_has_proper_dimensions, tiffs[name])
    assert got == _outcome(jutils.check_input_has_proper_dimensions, tiffs[name])
    assert got is (None if name == "stack" else ValueError)


@pytest.mark.parametrize("paths,is_stack", [(["a"], True), (["a", "b"], True), (["a"], False),
                                            (["a", "b"], False), ([], False), ([], True)],
                         ids=["stack-one", "stack-two", "cycles-one", "cycles-two", "none", "stack-none"])
def test_check_number_of_input_img_paths(paths, is_stack):
    got = _outcome(tutils.check_number_of_input_img_paths, paths, is_stack)
    assert got == _outcome(jutils.check_number_of_input_img_paths, paths, is_stack)


def test_set_number_of_dask_workers():
    assert tutils.set_number_of_dask_workers is tutils.set_number_of_workers
    try:
        tutils.set_number_of_dask_workers(3)
        assert len(tworkers.get_worker_devices("cpu")) == 3
        assert _outcome(tutils.set_number_of_dask_workers, -1) == _outcome(jutils.set_number_of_dask_workers, -1)
    finally:
        tutils.set_number_of_dask_workers(0)


@pytest.mark.parametrize("level", ["quiet", "info", "debug"])
def test_debug_prints_as_the_jax_package(level, monkeypatch):
    monkeypatch.setenv("MICROALIGNER_TPU_LOG", level)
    outs = []
    for mod in (tlogging, jlogging):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            mod.debug("detail", 3)
            mod.log("line", 4)
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    assert ("detail 3" in outs[0]) == (level == "debug")
