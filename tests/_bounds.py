"""Time limits for tests that start threads or processes.

A test that calls a threaded or multi-process entry point goes through one
of these, so a call or a worker that hangs fails that one test within its
limit instead of holding the whole run.  It imports neither package, so the
card's tests, which run where JAX is not installed, use it too.
"""

import contextlib
import os
import subprocess
import sys
import tempfile
import threading
import time

import pytest

BOUND_S = 30.0


def bounded_call(fn, bound_s: float = BOUND_S):
    """Wrap ``fn`` so that each call runs in a daemon thread and returns
    (the exception it raised or None, seconds).  A call still running after
    ``bound_s`` fails the test; its thread is left blocked, as a daemon, and
    does not hold the process."""

    def call(*args, **kwargs):
        result = {}

        def run():
            try:
                fn(*args, **kwargs)
            except Exception as e:  # handed to the test
                result["error"] = e

        t0 = time.monotonic()
        t = threading.Thread(target=run, daemon=True)
        t.start()
        t.join(timeout=bound_s)
        if t.is_alive():
            pytest.fail(f"{fn.__name__} did not return within {bound_s} s")
        return result.get("error"), time.monotonic() - t0

    return call


def run_workers(script, args_of, n: int, timeout_s: float, drop_env=()) -> list:
    """Run ``n`` Python processes of ``script``, worker ``i`` with arguments
    ``args_of(i)`` and the environment less ``drop_env``; wait for all of
    them within one ``timeout_s``, and return each one's (return code,
    output).  Every worker still running at the deadline is killed and
    reaped, and the test fails with the outputs."""
    env = {k: v for k, v in os.environ.items() if k not in drop_env}
    with contextlib.ExitStack() as stack:
        # files, not pipes: a worker that fills a pipe nobody reads yet would block
        logs = [stack.enter_context(tempfile.TemporaryFile()) for _ in range(n)]
        procs = [subprocess.Popen([sys.executable, str(script), *args_of(i)], stdout=log,
                                  stderr=subprocess.STDOUT, env=env) for i, log in enumerate(logs)]
        deadline = time.monotonic() + timeout_s
        try:
            for p in procs:
                p.wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            pass
        finally:
            late = [i for i, p in enumerate(procs) if p.poll() is None]
            for i in late:
                procs[i].kill()
                procs[i].wait()
        outs = []
        for log in logs:
            log.seek(0)
            outs.append(log.read().decode(errors="replace"))
    if late:
        pytest.fail(f"workers {late} still running after {timeout_s} s, killed:\n"
                    + "\n".join(f"--- worker {i}:\n{out}" for i, out in enumerate(outs)))
    return [(p.returncode, out) for p, out in zip(procs, outs)]
