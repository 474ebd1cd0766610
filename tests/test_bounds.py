"""The time limits of ``tests/_bounds.py``: a call or a worker that hangs
fails the test within its limit, and no worker outlives it."""

import threading
import time

import pytest
from _bounds import bounded_call, run_workers


def test_hung_call_fails_within_its_bound():
    release = threading.Event()
    t0 = time.monotonic()
    try:
        with pytest.raises(pytest.fail.Exception, match="did not return within 0.5 s"):
            bounded_call(release.wait, bound_s=0.5)(30)
    finally:
        release.set()
    assert time.monotonic() - t0 < 5.0
    err, secs = bounded_call(int)("x")
    assert isinstance(err, ValueError) and secs < 5.0


def test_hung_worker_is_killed_at_the_deadline(tmp_path):
    script = tmp_path / "w.py"
    script.write_text("import sys, time\n"
                      "print('up', sys.argv[1], flush=True)\n"
                      "time.sleep(float(sys.argv[2]))\n")
    (rc, out), = run_workers(script, lambda i: [str(i), "0"], 1, 30)
    assert rc == 0 and "up 0" in out
    t0 = time.monotonic()
    with pytest.raises(pytest.fail.Exception, match=r"workers \[1\] still running after 1.0 s") as info:
        run_workers(script, lambda i: [str(i), ["0", "60"][i]], 2, 1.0)
    assert time.monotonic() - t0 < 10.0
    assert "up 1" in str(info.value)
