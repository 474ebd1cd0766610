"""The port's ``stream_apply`` on CPU tensors: the cases of the JAX package's
``tests/test_parallel.py::TestStreamApply``, plus the deadlock the JAX
package's ``_STOP`` put can hit (a writer that dies while the queue is full)
and a stress run with a short thread switch interval.

Every call goes through ``tests/_bounds.py::bounded_call`` (a thread joined
after 30 s), so no case here can hang the suite: a call that does not return
in time fails the test.  The pinned-buffer path needs a card
(``tests/test_torch_kernels_cuda.py``).
"""

import sys
import threading
import time

import numpy as np
import pytest
import torch
from _bounds import bounded_call

from microaligner_tpu_torch.pipeline.apply import stream_apply

torch.set_num_threads(1)

_bounded = bounded_call(stream_apply)


def test_order_and_content(rng):
    planes = [(i, rng.random((8, 8)).astype(np.float32)) for i in range(7)]
    got = {}
    err, _ = _bounded(iter(planes), lambda p: p * 3.0, lambda k, v: got.__setitem__(k, v.copy()))
    assert err is None
    assert set(got) == set(range(7))
    for k, p in planes:
        np.testing.assert_allclose(got[k], p * 3.0, rtol=1e-6)


def test_writers_write_planes_at_once(rng):
    """Each plane is written once, by one of the writer threads, and two
    writers run ``write_fn`` at the same time: the first two planes' writes
    wait for each other, which one writer would never get past."""
    planes = [(i, rng.random((8, 8)).astype(np.float32)) for i in range(7)]
    both = threading.Barrier(2, timeout=10)
    writes = []

    def write_fn(k, v):
        if k < 2:
            both.wait()  # raises BrokenBarrierError after 10 s alone
        writes.append((k, threading.current_thread().name, float(v[0, 0])))

    err, _ = _bounded(iter(planes), lambda p: p + 1.0, write_fn, writers=2)
    assert err is None
    assert sorted(k for k, _, _ in writes) == list(range(7))
    assert {name for _, name, _ in writes} == {"stream_apply_writer"}
    assert all(x == float(planes[k][1][0, 0] + np.float32(1.0)) for k, _, x in writes)


def test_device_fn_gets_tensors_on_the_device(rng):
    seen = []

    def device_fn(t):
        seen.append((type(t), t.device.type, t.dtype))
        return t

    err, _ = _bounded(iter([(0, rng.integers(0, 9, (4, 4)).astype(np.uint16))]), device_fn,
                      lambda k, v: None, device="cpu")
    assert err is None and seen == [(torch.Tensor, "cpu", torch.uint16)]


def test_writer_error_propagates():
    def bad_write(k, v):
        raise RuntimeError("disk full")

    err, _ = _bounded(iter([(0, np.zeros((4, 4), np.float32))] * 3), lambda p: p, bad_write)
    assert isinstance(err, RuntimeError) and "disk full" in str(err)


def test_reader_error_propagates():
    def planes():
        yield (0, np.zeros((4, 4), np.float32))
        raise ValueError("decode failed")

    got = {}
    err, _ = _bounded(planes(), lambda p: p, got.__setitem__)
    assert isinstance(err, ValueError) and "decode failed" in str(err)
    assert 0 in got  # planes before the failure were still written


def test_writer_hang_raises():
    release = threading.Event()
    try:
        err, _ = _bounded(iter([(0, np.zeros((4, 4), np.float32))]), lambda p: p,
                          lambda k, v: release.wait(30),  # hung sink, well past the join timeout
                          join_timeout_s=0.5)
    finally:
        release.set()
    assert isinstance(err, RuntimeError) and "made no progress" in str(err)


@pytest.mark.parametrize("writers", [1, 3])
def test_writer_dies_while_queue_is_full(writers):
    """Each writer takes a plane (the one writer plane 0) and waits until the
    reader has run dry, so the calling thread has put the next plane into
    the queue (depth 1, now full) and gone on to put ``_STOP``; only then do
    the writers fail.  A plain blocking put of ``_STOP`` would wait forever
    on that full queue; the port's returns and raises a writer's error."""
    exhausted = threading.Event()

    def planes():
        for i in range(writers + 1):
            yield i, np.full((4, 4), i, np.float32)
        exhausted.set()

    def write(k, v):
        exhausted.wait(10)
        time.sleep(0.3)  # let the calling thread reach the put of _STOP
        raise RuntimeError("disk full")

    err, secs = _bounded(planes(), lambda p: p, write, depth=1, prefetch=1, writers=writers)
    assert isinstance(err, RuntimeError) and "disk full" in str(err)
    assert secs < 10.0


def test_stress_short_switch_interval(rng):
    """Many small planes with a thread switch every microsecond: every plane
    arrives once, with its own content."""
    planes = [(i, np.full((3, 5), i, np.float32)) for i in range(300)]
    got = {}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        err, _ = _bounded(iter(planes), lambda p: p + 1.0,
                          lambda k, v: got.__setitem__(k, v.copy()), depth=3, prefetch=3)
    finally:
        sys.setswitchinterval(old)
    assert err is None
    assert sorted(got) == list(range(300))
    assert all(float(v[0, 0]) == k + 1.0 for k, v in got.items())
