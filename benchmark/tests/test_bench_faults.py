"""A run whose timed path is broken underneath comes out not correct, and
so does the control (the reference one precision below the
configuration's, in the program's place).  The run skips its look for a
card and runs on the CPU at a tiny size, where the program is its plain
path and equals the reference."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.control import Control
from benchmark.port_entry import Cycles
from benchmark.tests import tiny


class StateUnchanged(Cycles):
    """Each register returns its starting state: the identity matrix, a
    zero flow."""

    def run(self, planes, affine_out, flow_out, span=None):
        h, w = self.shape
        self.ofreg.register_device = lambda: torch.zeros((h, w, 2), dtype=torch.float32, device=self.device)
        if self.freg is not None:
            self.freg.register = lambda reuse_ref_img=False: np.eye(2, 3)
        super().run(planes, affine_out, flow_out, *([span] if span else []))


class ChainUnchanged(Cycles):
    """The chain's state never moves on: every cycle registers against the
    reference cycle's projection instead of the cycle before's warp."""

    def run(self, planes, affine_out, flow_out, span=None):
        start = getattr(self, "_start", None)
        if start is None:
            start = self._start = self.ref_img
        self.ref_img = start
        super().run(planes, affine_out, flow_out, *([span] if span else []))


class HalfLeftOut(Cycles):
    """The applies drop half of the cycle's channels."""

    def _apply(self, planes, out, device_fn):
        super()._apply(planes[: planes.shape[0] // 2], out, device_fn)


class AnswerAltered(Cycles):
    """One applied plane leaves with one pixel wrong by 1024 units."""

    def _apply(self, planes, out, device_fn):
        def altered(img):
            res = device_fn(img).clone()
            res[7, 9] = (res[7, 9].to(torch.int32) ^ 1024).to(res.dtype)
            return res

        super()._apply(planes, out, altered)


FAULTS = {"state_unchanged": StateUnchanged, "chain_unchanged": ChainUnchanged, "half_left_out": HalfLeftOut,
          "answer_altered": AnswerAltered}


@pytest.mark.parametrize("cell", tiny.CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(cell, fault):
    result = tiny.run(cell, cycles_cls=FAULTS[fault])
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_control_is_not_correct(cell):
    result = tiny.run(cell, cycles_cls=Control)
    assert result["correct"] is False, result["checks"]
