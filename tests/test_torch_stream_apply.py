"""The port's ``stream_apply`` on CPU tensors: the cases of the JAX package's
``tests/test_parallel.py::TestStreamApply``, plus the deadlock the JAX
package's ``_STOP`` put can hit (a writer that dies while the queue is full)
and a stress run with a short thread switch interval.

Every call runs in a thread joined with its own timeout, so no case here can
hang the suite: a call that does not return in time fails the test.  The
pinned-buffer path needs a card (``tests/test_torch_kernels_cuda.py``).
"""

import sys
import threading
import time

import numpy as np
import torch

from microaligner_tpu_torch.pipeline.apply import stream_apply

torch.set_num_threads(1)

BOUND_S = 30.0


def _bounded(*args, **kwargs):
    """Run ``stream_apply`` in a thread; return (exception or None, seconds).
    Fails the test if the call is still running after ``BOUND_S``."""
    result = {}

    def run():
        try:
            stream_apply(*args, **kwargs)
        except Exception as e:  # handed to the test
            result["error"] = e

    t0 = time.monotonic()
    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout=BOUND_S)
    assert not t.is_alive(), f"stream_apply did not return within {BOUND_S} s"
    return result.get("error"), time.monotonic() - t0


def test_order_and_content(rng):
    planes = [(i, rng.random((8, 8)).astype(np.float32)) for i in range(7)]
    got = {}
    err, _ = _bounded(iter(planes), lambda p: p * 3.0, lambda k, v: got.__setitem__(k, v.copy()))
    assert err is None
    assert set(got) == set(range(7))
    for k, p in planes:
        np.testing.assert_allclose(got[k], p * 3.0, rtol=1e-6)


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


def test_writer_dies_while_queue_is_full():
    """The writer takes plane 0 and waits until the reader has run dry, so the
    calling thread has put plane 1 into the queue (depth 1, now full) and gone
    on to put ``_STOP``; only then does the writer fail.  A plain blocking put
    of ``_STOP`` would wait forever on that full queue; the port's returns and
    raises the writer's error."""
    exhausted = threading.Event()

    def planes():
        for i in range(2):
            yield i, np.full((4, 4), i, np.float32)
        exhausted.set()

    def write(k, v):
        exhausted.wait(10)
        time.sleep(0.3)  # let the calling thread reach the put of _STOP
        raise RuntimeError("disk full")

    err, secs = _bounded(planes(), lambda p: p, write, depth=1, prefetch=1)
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
