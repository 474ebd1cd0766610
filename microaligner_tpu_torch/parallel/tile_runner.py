"""Mesh-sharded, memory-bounded map over a tile or band axis.

PyTorch counterpart of ``microaligner_tpu/parallel/tile_runner.py``.  Every
tiled op of the engines has one shape: cut the image into N halo tiles (or
row bands), run a batched function over the tile axis in bounded chunks,
stitch the interiors back.  :func:`tile_map` runs that loop; over a mesh of
several devices (``parallel/mesh.py``) it first pads the tile axis to a
multiple of the mesh and splits it into contiguous shards, as the JAX
package's ``P("tiles")`` splits it, and each shard runs its own bounded loop
on its device.  ``NumberOfWorkers`` caps the mesh (``utils/workers.py``).

Where the mesh is the inputs' one device and no process group is up, the
map is the plain loop: no copy, no padding, nothing allocated but the
outputs.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from microaligner_tpu_torch.parallel.mesh import (
    TileMesh,
    collective_device,
    get_tile_mesh,
    override_mesh,
    shard_tiles_round_up,
)

__all__ = ["tile_map", "current_tile_mesh", "mesh_num_devices", "mesh_is_local"]


def current_tile_mesh(device=None) -> TileMesh:
    """The mesh the engines shard over for inputs on ``device``: the one
    ``use_tile_mesh`` set, else the worker devices of ``device``'s type,
    capped by ``set_number_of_workers`` (the reference's NumberOfWorkers)."""
    mesh = override_mesh()
    if mesh is not None:
        return mesh
    from microaligner_tpu_torch.utils.workers import get_worker_devices

    return get_tile_mesh(get_worker_devices(device))


def mesh_num_devices(mesh: Optional[TileMesh]) -> int:
    """Shards of ``mesh`` over every process; 1 for None."""
    return 1 if mesh is None else mesh.size


def mesh_is_local(mesh: Optional[TileMesh], device) -> bool:
    """True where :func:`tile_map` over ``mesh`` is the plain loop on
    ``device``: no mesh, or no process group and the mesh is that one
    device."""
    return mesh is None or (mesh.world_size is None and mesh.devices == (torch.device(device),))


def home_device(tensors: Sequence[torch.Tensor]) -> torch.device:
    """The device the outputs are gathered onto: the first of ``tensors``
    that does not lie on the CPU, else the CPU.  Index tensors on the host
    (band numbers, tile origins) beside device images stay on the host."""
    for t in tensors:
        if t.device.type != "cpu":
            return t.device
    return torch.device("cpu")


def _bounded_map(fn_batch: Callable, inputs, batch: int, broadcast, unbatched: bool):
    """``fn_batch`` over the leading axis of ``inputs``, ``batch`` items a
    call (one item, without its leading axis, when ``unbatched``), every
    output written in order into tensors allocated once."""
    n = len(inputs[0])
    step = 1 if unbatched else batch
    outs = None
    single = False
    for s in range(0, n, step):
        if unbatched:
            res = fn_batch(*(x[s] for x in inputs), *broadcast)
        else:
            res = fn_batch(*(x[s : s + batch] for x in inputs), *broadcast)
        if isinstance(res, torch.Tensor):
            res, single = (res,), True
        if unbatched:
            res = tuple(r[None] for r in res)
        if outs is None:
            outs = tuple(r.new_empty((n,) + tuple(r.shape[1:])) for r in res)
        for o, r in zip(outs, res):
            o[s : s + r.shape[0]] = r
    return outs[0] if single else outs


def check_mesh(mesh: TileMesh, home: torch.device) -> None:
    """Raise unless ``mesh``'s devices are of ``home``'s type: a mesh never
    moves work to another kind of device."""
    if mesh.devices[0].type != home.type:
        raise RuntimeError(f"tile mesh on {mesh.devices[0].type} for inputs on {home}: "
                           "the mesh's devices must be of the inputs' type")


def run_shards(fn: Callable, inputs: Sequence[torch.Tensor], mesh: TileMesh,
               broadcast: Sequence[torch.Tensor] = ()) -> list:
    """``fn(start, n_real, *shard_inputs, *broadcast)`` on each of this
    process's shards, on the shard's device: the inputs' axis is zero-padded
    to a multiple of ``mesh.size`` and shard ``g`` (global, rank-major)
    holds rows ``[g * per, (g + 1) * per)``, ``n_real`` of them unpadded.
    Inputs on the home device and ``broadcast`` are copied to each shard
    device (the broadcast once a device); inputs on the CPU beside device
    images stay there.  Returns the shards' results in order."""
    home = home_device(tuple(broadcast) + tuple(inputs))
    check_mesh(mesh, home)
    n = len(inputs[0])
    padded = [shard_tiles_round_up(x, mesh.size) for x in inputs]
    per = len(padded[0]) // mesh.size
    first = (mesh.rank or 0) * len(mesh.devices)
    copies, results = {}, []
    for j, dev in enumerate(mesh.devices):
        start = (first + j) * per
        if dev not in copies:
            copies[dev] = tuple(b.to(dev) for b in broadcast)
        shard = tuple(x[start : start + per] if x.device.type == "cpu" and home.type != "cpu"
                      else x[start : start + per].to(dev) for x in padded)
        results.append(fn(start, max(0, min(per, n - start)), *shard, *copies[dev]))
    return results


def _all_gather(t: torch.Tensor, mesh: TileMesh) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes) concatenated along the leading axis
    in rank order, on ``t``'s device.  Sent as bytes, so any dtype goes
    (NCCL and gloo take no uint16)."""
    x = t.contiguous().to(collective_device(mesh))
    b = x.view(torch.uint8)
    parts = [torch.empty_like(b) for _ in range(mesh.world_size)]
    dist.all_gather(parts, b)
    return torch.cat(parts).view(t.dtype).reshape((-1,) + tuple(t.shape[1:])).to(t.device)


def gather_shards(results: list, mesh: TileMesh, home: torch.device, n: int):
    """The shards' outputs (tensors, or tuples of them, with the shard's rows
    on the leading axis) concatenated in shard order onto ``home``,
    all-gathered across the process group, and cut to the ``n`` real rows."""
    single = isinstance(results[0], torch.Tensor)
    parts = [(r,) if single else tuple(r) for r in results]
    outs = []
    for k in range(len(parts[0])):
        o = torch.cat([p[k].to(home) for p in parts])
        if mesh.world_size is not None:
            o = _all_gather(o, mesh)
        outs.append(o[:n])
    return outs[0] if single else tuple(outs)


def tile_map(fn_batch: Callable, inputs: Sequence[torch.Tensor], batch: int,
             mesh: Optional[TileMesh] = None, broadcast: Sequence[torch.Tensor] = (),
             unbatched: bool = False):
    """Apply ``fn_batch(*chunks, *broadcast)`` over the leading axis of every
    tensor in ``inputs``, ``batch`` items at a time, sharded over ``mesh``.

    * ``fn_batch`` returns a tensor or a tuple of tensors whose leading axis
      is the chunk's length; the results come back in order, each of the
      whole axis's length.
    * ``broadcast`` tensors are passed whole to every call (a canvas that
      the chunks' windows slice), copied once to each shard's device.
    * ``unbatched=True``: ``fn_batch`` takes one item at a time, without
      its leading axis, and returns one item's outputs (``batch`` is not
      read).
    * Over a mesh of several devices, or with a process group up, the axis
      is zero-padded to a multiple of the mesh and split into contiguous
      shards; each shard runs its own bounded loop on its device, padded
      rows are dropped from every output, and the outputs are gathered onto
      the inputs' device (``all_gather`` ed across ranks, so every rank holds
      the whole axis).  ``fn_batch`` may give anything on all-zero rows.
    """
    inputs, broadcast = tuple(inputs), tuple(broadcast)
    if batch < 1:
        raise ValueError(f"tile_map: batch must be >= 1, got {batch}")
    n = len(inputs[0])
    if n == 0:
        raise ValueError("tile_map: empty tile axis")
    home = home_device(broadcast + inputs)
    if mesh_is_local(mesh, home):
        return _bounded_map(fn_batch, inputs, batch, broadcast, unbatched)

    def shard(start, n_real, *args):
        return _bounded_map(fn_batch, args[: len(inputs)], batch, args[len(inputs):], unbatched)

    return gather_shards(run_shards(shard, inputs, mesh, broadcast), mesh, home, n)
