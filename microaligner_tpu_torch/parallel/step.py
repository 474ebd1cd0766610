"""One sharded registration step (optical-flow path).

PyTorch counterpart of ``microaligner_tpu/parallel/step.py``: given a
ref/mov pair, per-tile Farneback flow (K2, K3, K4), the moving tiles warped
by it (K1), and an NMI joint histogram of the result, over a tile mesh:

* the tile axis is split into contiguous shards (``parallel/tile_runner.py``);
* each shard's joint histogram is summed onto the mesh's first device and
  ``all_reduce`` d across the process group, where the JAX package
  ``psum`` s it;
* the warped tiles and the flow are gathered and stitched.

The histogram counts each image pixel once, whatever the mesh: a shard
counts only the interiors of its real tiles, cut to the image.  The JAX
package's step counts the interiors of the zero tiles that pad the tile
axis, and of the grid's padding past the image, too, so its total depends
on the mesh size (H * W + 7 * 32^2 for 25 tiles of 32 on 8 devices).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from microaligner_tpu_torch.ops.mutual_info import _hists
from microaligner_tpu_torch.ops.warp import warp_with_flow_parts_batched
from microaligner_tpu_torch.optflow.farneback import _farneback_core_parts
from microaligner_tpu_torch.parallel.mesh import TileMesh, collective_device
from microaligner_tpu_torch.parallel.tile_runner import gather_shards, home_device, run_shards
from microaligner_tpu_torch.tiles import TileGrid, split_into_tiles, stitch_tiles

__all__ = ["make_sharded_register_step"]


def _interior_mask(grid: TileGrid, start: int, n_real: int, n_local: int, device) -> torch.Tensor:
    """(n_local, tile_h, tile_w) bool: the pixels of tiles ``start ..
    start + n_real`` whose interior lies inside the image; padding tiles
    and the grid's padding past the image are False."""
    tid = torch.arange(start, start + n_local, device=device)
    rows = (grid.height - (tid // grid.nx) * grid.tile_h).clamp(0, grid.tile_h)
    cols = (grid.width - (tid % grid.nx) * grid.tile_w).clamp(0, grid.tile_w)
    rows = torch.where(tid < start + n_real, rows, 0)
    return ((torch.arange(grid.tile_h, device=device).view(1, -1, 1) < rows.view(-1, 1, 1))
            & (torch.arange(grid.tile_w, device=device).view(1, 1, -1) < cols.view(-1, 1, 1)))


def make_sharded_register_step(mesh: TileMesh, grid: TileGrid, win_size: int, num_iter: int,
                               with_hist: bool = True):
    """Build a step: (ref (H, W), mov (H, W)) -> (warped (H, W) f32, flow
    (H, W, 2) f32[, joint_hist (256, 256) int64 on the mesh's first
    device]).

    ``with_hist=False`` skips the NMI joint histogram, so a comparison with
    a flow-and-remap baseline does not bill the scoring stage.  The inputs
    lie on a device of the mesh's type; the outputs come back to it.
    """
    o, th, tw = grid.overlap, grid.tile_h, grid.tile_w

    def per_shard(start, n_real, ref_tiles, mov_tiles):
        fx, fy = _farneback_core_parts(mov_tiles, ref_tiles, win_size, num_iter, 1, 1.7)
        warped = warp_with_flow_parts_batched(mov_tiles, fx, fy)
        if not with_hist:
            return (warped, fx, fy), None
        mask = _interior_mask(grid, start, n_real, len(ref_tiles), ref_tiles.device)
        a = ref_tiles[:, o : o + th, o : o + tw][mask].clamp(0, 255).to(torch.uint8)
        b = warped[:, o : o + th, o : o + tw][mask].clamp(0, 255).to(torch.uint8)
        return (warped, fx, fy), _hists(a.view(1, -1), b.view(1, -1))[0]

    def step(ref_img: torch.Tensor, mov_img: torch.Tensor):
        home = home_device((ref_img, mov_img))
        ref_tiles = split_into_tiles(ref_img.to(torch.float32), grid)
        mov_tiles = split_into_tiles(mov_img.to(torch.float32), grid)
        results = run_shards(per_shard, (ref_tiles, mov_tiles), mesh)
        warped, fx, fy = gather_shards([r[0] for r in results], mesh, home, grid.num_tiles)
        warped = stitch_tiles(warped, grid)
        flow = torch.stack([stitch_tiles(fx, grid), stitch_tiles(fy, grid)], dim=-1)
        if not with_hist:
            return warped, flow
        first = mesh.devices[0]
        hist = sum(r[1].to(first) for r in results[1:]) + results[0][1]
        if mesh.world_size is not None:
            h = hist.to(collective_device(mesh))
            dist.all_reduce(h, op=dist.ReduceOp.SUM)
            hist = h.to(first)
        return warped, flow, hist

    return step
