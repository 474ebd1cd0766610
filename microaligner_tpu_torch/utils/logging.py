"""Lightweight logging + stage timing.

The reference's only observability is ~30 bare prints (SURVEY §5).  This
module keeps those exact lines (tests and users rely on them) but routes them
through a leveled logger, and adds opt-in stage timers:

* ``MICROALIGNER_TPU_LOG=quiet|info|debug``  — default info (print parity)
* ``MICROALIGNER_TPU_PROFILE=1``             — per-stage wall-clock lines

Both variables are the JAX package's, so one setting drives either package.
PyTorch returns before the device finishes, so a timed stage that wants its
device time synchronizes before it leaves the timer (see ``stage_timer``).
"""

from __future__ import annotations

import contextlib
import os
import sys
import time

__all__ = ["log", "debug", "stage_timer", "profiling_enabled"]

_LEVELS = {"quiet": 0, "info": 1, "debug": 2}


def _level() -> int:
    return _LEVELS.get(os.environ.get("MICROALIGNER_TPU_LOG", "info"), 1)


def profiling_enabled() -> bool:
    return os.environ.get("MICROALIGNER_TPU_PROFILE", "") not in ("", "0")


def log(*args):
    if _level() >= 1:
        print(*args)
        sys.stdout.flush()


def debug(*args):
    if _level() >= 2:
        print(*args)
        sys.stdout.flush()


@contextlib.contextmanager
def stage_timer(name: str, device=None):
    """Wall-clock a pipeline stage when MICROALIGNER_TPU_PROFILE is set;
    with a CUDA ``device``, wait for its queued work before reading the clock."""
    if not profiling_enabled():
        yield
        return
    import torch

    def sync():
        if device is not None and torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)

    sync()
    t0 = time.perf_counter()
    yield
    sync()
    print(f"[profile] {name}: {time.perf_counter() - t0:.3f}s")
    sys.stdout.flush()
