"""Streamed transform application: overlap TIFF I/O with device compute.

PyTorch counterpart of ``microaligner_tpu/pipeline/apply.py``.  The apply
phase warps every channel/z-plane with the cycle's transform and writes
BigTIFF planes.  Three threads keep the card busy on both sides:

* a reader thread pulls planes from the (possibly lazy, TIFF-decoding)
  iterable, copies each into a reused ring of pinned host buffers and issues
  the host->device copy on a side CUDA stream, recording an event;
* the calling thread makes its own (per-thread) current stream wait for that
  event, marks the tensor as used there (``record_stream``, so the caching
  allocator cannot hand its memory out while the copy or the warp still
  runs), and dispatches ``device_fn``;
* a writer thread waits for the warp's event on a second side stream, copies
  the result into a reused pinned buffer and hands it to ``write_fn``.

Pinned buffers are used only when the ``device`` passed in is a CUDA device;
on the CPU the planes go through as host tensors.  Both worker threads
propagate failures to the caller.  Every put into a queue checks its peer
(the JAX package's plain ``put`` of ``_STOP`` can block forever on a full
queue when the writer dies after the check), and a writer that is still
alive with no progress after the join timeout (dead NFS mount, hung
filesystem) raises rather than silently returning with planes unwritten.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from typing import Callable, Iterable, Optional, Tuple

import numpy as np
import torch

__all__ = ["stream_apply"]

_STOP = object()


def _checked_put(q: "queue.Queue", item, failed: Callable[[], bool]) -> bool:
    """Bounded put that keeps checking the peer thread — a plain blocking put
    deadlocks if the consumer exits with a full queue."""
    while True:
        if failed():
            return False
        try:
            q.put(item, timeout=0.5)
            return True
        except queue.Full:
            continue


class _PinnedRing:
    """``n`` page-locked host buffers handed out round robin.  A buffer is
    handed out again only after the copy last recorded on it has finished,
    so a ring of two lets one copy run while the next plane is staged."""

    def __init__(self, n: int):
        self._bufs: list = [None] * n
        self._events: list = [None] * n
        self._next = 0

    def stage(self, shape, dtype: torch.dtype) -> Tuple[int, torch.Tensor]:
        """(slot, pinned host tensor of ``shape`` and ``dtype``)."""
        i = self._next
        self._next = (i + 1) % len(self._bufs)
        if self._events[i] is not None:
            self._events[i].synchronize()
            self._events[i] = None
        nbytes = int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()
        buf = self._bufs[i]
        if buf is None or buf.numel() < nbytes:
            buf = self._bufs[i] = torch.empty(max(nbytes, 1), dtype=torch.uint8, pin_memory=True)
        return i, buf[:nbytes].view(dtype).view(shape)

    def in_use_until(self, slot: int, event: torch.cuda.Event) -> None:
        self._events[slot] = event


def stream_apply(
    planes: Iterable[Tuple[object, np.ndarray]],
    device_fn: Callable[[torch.Tensor], torch.Tensor],
    write_fn: Callable[[object, np.ndarray], None],
    device="cpu",
    depth: int = 2,
    prefetch: int = 2,
    join_timeout_s: Optional[float] = None,
):
    """For each ``(key, plane)``: write ``device_fn(plane on device)`` via
    ``write_fn``.

    ``device_fn`` takes the plane as a tensor on ``device`` and returns a
    tensor (dispatched asynchronously on a CUDA device).  Up to ``depth``
    results stay in flight while the reader thread stages the next
    ``prefetch`` planes and the writer thread drains finished ones.

    ``write_fn(key, array)`` gets a host array that is valid until it
    returns: on a CUDA device it is a view of a reused pinned buffer, so a
    ``write_fn`` that keeps the array must copy it.
    """
    if join_timeout_s is None:
        join_timeout_s = float(os.environ.get("MICROALIGNER_TPU_WRITER_TIMEOUT_S", "600"))
    device = torch.device(device)
    pinned = device.type == "cuda"
    if pinned:
        h2d = torch.cuda.Stream(device=device)
        d2h = torch.cuda.Stream(device=device)
        in_ring, out_ring = _PinnedRing(2), _PinnedRing(1)
    rq: "queue.Queue" = queue.Queue(maxsize=max(1, prefetch))
    wq: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
    read_errors: list = []
    write_errors: list = []
    done = threading.Event()
    progress = [time.monotonic()]  # last time the writer started or finished an item

    def to_device(plane: np.ndarray):
        host = torch.from_numpy(np.ascontiguousarray(plane))
        if not pinned:
            return host.to(device), None
        slot, staged = in_ring.stage(host.shape, host.dtype)
        staged.copy_(host)
        with torch.cuda.stream(h2d):
            dev = torch.empty(host.shape, dtype=host.dtype, device=device)
            dev.copy_(staged, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(h2d)
        in_ring.in_use_until(slot, ready)
        return dev, ready

    def to_host(out: torch.Tensor, ready) -> np.ndarray:
        if not pinned:
            return out.cpu().numpy()
        _, staged = out_ring.stage(out.shape, out.dtype)
        with torch.cuda.stream(d2h):
            d2h.wait_event(ready)
            out.record_stream(d2h)
            staged.copy_(out, non_blocking=True)
            fetched = torch.cuda.Event()
            fetched.record(d2h)
        fetched.synchronize()
        return staged.numpy()

    def reader():
        try:
            for key, plane in planes:
                if not _checked_put(rq, (key, *to_device(plane)), done.is_set):
                    return
        except Exception as e:  # decode/H2D failure -> caller
            read_errors.append(e)
        finally:
            _checked_put(rq, _STOP, done.is_set)

    def writer():
        while True:
            item = wq.get()
            if item is _STOP:
                return
            key, out, ready = item
            try:
                progress[0] = time.monotonic()  # starting an item is progress
                write_fn(key, to_host(out, ready))
                progress[0] = time.monotonic()
            except Exception as e:  # propagate to the caller
                write_errors.append(e)
                return

    def writer_gone() -> bool:
        return (bool(write_errors) or not wt.is_alive()
                or time.monotonic() - progress[0] > join_timeout_s)

    rt = threading.Thread(target=reader, daemon=True, name="stream_apply_reader")
    wt = threading.Thread(target=writer, daemon=True, name="stream_apply_writer")
    rt.start()
    wt.start()
    try:
        while True:
            item = rq.get()
            if item is _STOP:
                break
            key, plane, ready = item
            if ready is not None:
                stream = torch.cuda.current_stream(device)
                stream.wait_event(ready)
                plane.record_stream(stream)
            out = device_fn(plane)
            done_ev = None
            if pinned:
                done_ev = torch.cuda.Event()
                done_ev.record(torch.cuda.current_stream(device))
            if not _checked_put(wq, (key, out, done_ev), writer_gone):
                break
    finally:
        done.set()  # unblocks a reader stuck on a full rq
        _checked_put(wq, _STOP, writer_gone)
        # Join in slices and only give up when the writer has made NO progress
        # for ``join_timeout_s`` — a big plane to a slow disk is "slow", a dead
        # NFS mount is "hung"; a fixed-length join can't tell them apart.
        while True:
            wt.join(timeout=min(30.0, join_timeout_s))
            if not wt.is_alive():
                break
            if time.monotonic() - progress[0] > join_timeout_s:
                break
        rt.join(timeout=join_timeout_s)
    if write_errors:
        raise write_errors[0]
    if read_errors:
        raise read_errors[0]
    if wt.is_alive():
        raise RuntimeError(
            f"stream_apply: writer thread made no progress for {join_timeout_s}s "
            "— output sink appears hung; planes may be unwritten"
        )
