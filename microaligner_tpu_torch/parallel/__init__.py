"""Device-mesh tile parallelism (counterpart of ``microaligner_tpu.parallel``).

Tiles and row bands are a leading tensor axis split into contiguous shards
across a 1-D mesh of devices; each shard runs the engines' batched
functions on its own device, and the outputs are gathered onto the inputs'
device (and ``all_gather`` ed across a ``torch.distributed`` process group).
Halos come from overlapped slicing, so no neighbour exchange is needed.
"""

from microaligner_tpu_torch.parallel.mesh import (
    TileMesh,
    get_tile_mesh,
    init_distributed_from_env,
    shard_tiles_round_up,
    sharded_tile_map,
    use_tile_mesh,
)
from microaligner_tpu_torch.parallel.tile_runner import current_tile_mesh, mesh_num_devices, tile_map

__all__ = [
    "TileMesh",
    "get_tile_mesh",
    "init_distributed_from_env",
    "use_tile_mesh",
    "sharded_tile_map",
    "shard_tiles_round_up",
    "current_tile_mesh",
    "mesh_num_devices",
    "tile_map",
]
