"""1-D tile mesh, its override and the multi-process init.

PyTorch counterpart of ``microaligner_tpu/parallel/mesh.py``.  Tiles (and
row bands) carry their own halo, so the layout is the JAX package's: one
axis of devices, the tile axis split into contiguous shards across it,
everything else copied whole to each device.  A mesh is this process's
ordered devices plus, when a ``torch.distributed`` process group is up, the
process's rank and the group's size: the global mesh is then
``world_size`` copies of the local layout, rank-major, as
``jax.devices()`` orders a multi-process mesh.  A device may repeat (a
mesh ``(cuda:0, cuda:0)`` runs two shards on one card).
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
from typing import Iterator, Optional, Sequence

import torch
import torch.distributed as dist

__all__ = [
    "TileMesh",
    "get_tile_mesh",
    "use_tile_mesh",
    "init_distributed_from_env",
    "shard_tiles_round_up",
    "sharded_tile_map",
]


@dataclasses.dataclass(frozen=True)
class TileMesh:
    """``devices``: this process's shards' devices, in shard order;
    ``rank`` and ``world_size``: the process group's, None without one."""

    devices: tuple
    rank: Optional[int] = None
    world_size: Optional[int] = None

    @property
    def size(self) -> int:
        """Shards over every process."""
        return len(self.devices) * (self.world_size or 1)


_override: Optional[TileMesh] = None


def _normalized(devices: Sequence) -> tuple:
    """``devices`` as ``torch.device`` s with explicit card indices; raises
    for an empty list, mixed types, or a card that is not visible."""
    devs = tuple(torch.device(d) for d in devices)
    if not devs:
        raise ValueError("a tile mesh needs at least one device")
    if len({d.type for d in devs}) != 1:
        raise ValueError(f"a tile mesh's devices must be of one type, got {devs}")
    if devs[0].type == "cpu":
        return (torch.device("cpu"),) * len(devs)  # "cpu:0" is the one CPU device tensors report as "cpu"
    if devs[0].type != "cuda":
        return devs
    if not torch.cuda.is_available():
        raise RuntimeError(f"tile mesh {devs}: no CUDA device (torch.cuda.is_available() is False)")
    count = torch.cuda.device_count()
    devs = tuple(torch.device("cuda", torch.cuda.current_device() if d.index is None else d.index)
                 for d in devs)
    for d in devs:
        if d.index >= count:
            raise RuntimeError(f"tile mesh: {d} is not visible ({count} CUDA devices)")
    return devs


def collective_device(mesh: TileMesh) -> torch.device:
    """Where this process's tensors meet the process group: the CPU under
    gloo, the mesh's first card otherwise (NCCL)."""
    return torch.device("cpu") if dist.get_backend() == "gloo" else mesh.devices[0]


def get_tile_mesh(devices=None) -> TileMesh:
    """The mesh over ``devices``, by default the worker devices of the first
    CUDA device (``utils.workers.get_worker_devices``).  With a process
    group up, every rank must hold as many devices; this is checked with
    one ``all_gather``, so every rank must call it."""
    if devices is None:
        from microaligner_tpu_torch.utils.workers import get_worker_devices

        devices = get_worker_devices()
    devs = _normalized(devices)
    if not (dist.is_available() and dist.is_initialized()):
        return TileMesh(devs)
    mesh = TileMesh(devs, dist.get_rank(), dist.get_world_size())
    cdev = collective_device(mesh)
    counts = [torch.zeros(1, dtype=torch.int64, device=cdev) for _ in range(mesh.world_size)]
    dist.all_gather(counts, torch.full((1,), len(devs), dtype=torch.int64, device=cdev))
    counts = [int(c) for c in counts]
    if len(set(counts)) != 1:
        raise RuntimeError(f"tile mesh: the ranks hold {counts} devices; each must hold as many")
    return mesh


@contextlib.contextmanager
def use_tile_mesh(devices) -> Iterator[TileMesh]:
    """Within the block, ``current_tile_mesh`` is the mesh over ``devices``
    (which may repeat a device) whatever the worker cap says; the previous
    override comes back after it."""
    global _override
    saved = _override
    _override = get_tile_mesh(devices)
    try:
        yield _override
    finally:
        _override = saved


def override_mesh() -> Optional[TileMesh]:
    """The mesh :func:`use_tile_mesh` set, or None."""
    return _override


def init_distributed_from_env(backend: Optional[str] = None, timeout_s: float = 300.0) -> bool:
    """Multi-process initialization from environment variables.

    Set ``MICROALIGNER_TPU_DIST=1`` plus ``MICROALIGNER_TPU_DIST_COORD``
    (host:port of rank 0), ``..._NPROC`` and ``..._PID`` (this process's
    rank); the tile mesh then spans every process's devices and the tile
    axis shards across processes, each rank running the shards of its own
    devices.  The backend is NCCL where a card is visible and gloo
    otherwise, unless ``backend`` names one.  A group that has not formed
    within ``timeout_s`` seconds raises.  Returns True when the group was
    initialized, False when ``MICROALIGNER_TPU_DIST`` is not ``1``.
    """
    if os.environ.get("MICROALIGNER_TPU_DIST", "0") != "1":
        return False
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(
        backend=backend,
        init_method=f"tcp://{os.environ['MICROALIGNER_TPU_DIST_COORD']}",
        world_size=int(os.environ["MICROALIGNER_TPU_DIST_NPROC"]),
        rank=int(os.environ["MICROALIGNER_TPU_DIST_PID"]),
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    return True


def shard_tiles_round_up(tiles: torch.Tensor, n_devices: int) -> torch.Tensor:
    """Zero-pad the leading (tile) axis to a multiple of ``n_devices``."""
    pad = (-tiles.shape[0]) % n_devices
    if pad:
        tiles = torch.cat([tiles, tiles.new_zeros((pad,) + tuple(tiles.shape[1:]))])
    return tiles


def sharded_tile_map(fn, mesh: Optional[TileMesh] = None):
    """Lift a batched per-tile function ``fn(*stacks) -> out`` (every
    output's leading axis the stacks') to a map sharded over ``mesh`` (by
    default :func:`get_tile_mesh`'s): the tile axis is padded to a multiple
    of the mesh, each shard runs ``fn`` once on its device, the padded rows
    are dropped and the outputs gathered onto the inputs' device.  Where the
    mesh is the inputs' one device, this is a plain call of ``fn``."""
    from microaligner_tpu_torch.parallel.tile_runner import home_device, mesh_is_local, tile_map

    mesh = mesh if mesh is not None else get_tile_mesh()

    def run(*tile_arrays):
        if mesh_is_local(mesh, home_device(tile_arrays)):
            return fn(*tile_arrays)
        per_shard = -(-tile_arrays[0].shape[0] // mesh.size)
        return tile_map(fn, tile_arrays, batch=max(per_shard, 1), mesh=mesh)

    return run
