"""The port's tile mesh across processes, against one process (mirror of
tests/test_multihost.py).

Two fresh Python processes form a gloo group through
``init_distributed_from_env`` (the JAX package's ``MICROALIGNER_TPU_DIST*``
variables), each with a mesh of two CPU entries, so the global mesh has 4
shards.  Each runs the port's ``tile_map`` (11 tiles, so the axis is
padded; float32, uint16 and bool outputs), an ``all_reduce``, and the
sharded register step on 25 tiles (padded to 28), and writes the step's
outputs; this process runs the step on a one-device mesh and holds both
ranks' outputs to it bit for bit, the histogram at exactly H * W.

Every wait is bounded: ``init_process_group`` gets a finite timeout, and the
workers are killed if they have not all finished within ``_TIMEOUT_S``
(``tests/_bounds.py::run_workers``), so a hang fails the test instead of
holding the run.
"""

import socket
from pathlib import Path

import numpy as np
import pytest
import torch
from _bounds import run_workers

from microaligner_tpu_torch.parallel import get_tile_mesh, init_distributed_from_env
from microaligner_tpu_torch.parallel.step import make_sharded_register_step
from microaligner_tpu_torch.tiles import TileGrid

_REPO = str(Path(__file__).resolve().parent.parent)
_TIMEOUT_S = 120
_DIST_VARS = ("MICROALIGNER_TPU_DIST", "MICROALIGNER_TPU_DIST_COORD", "MICROALIGNER_TPU_DIST_NPROC",
              "MICROALIGNER_TPU_DIST_PID")

_WORKER = """
import os, sys
sys.path.insert(0, sys.argv[3])
os.environ["MICROALIGNER_TPU_DIST"] = "1"
os.environ["MICROALIGNER_TPU_DIST_COORD"] = sys.argv[2]
os.environ["MICROALIGNER_TPU_DIST_NPROC"] = "2"
os.environ["MICROALIGNER_TPU_DIST_PID"] = sys.argv[1]

import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
from microaligner_tpu_torch.parallel import get_tile_mesh, init_distributed_from_env, tile_map
from microaligner_tpu_torch.parallel.step import make_sharded_register_step
from microaligner_tpu_torch.tiles import TileGrid

pid = int(sys.argv[1])
assert init_distributed_from_env(timeout_s=60)
cpu = torch.device("cpu")
mesh = get_tile_mesh([cpu, cpu])
assert (mesh.size, mesh.rank, mesh.world_size) == (4, pid, 2), mesh

tiles = torch.arange(11 * 16 * 16, dtype=torch.float32).reshape(11, 16, 16)
out = tile_map(lambda t: t * 2.0 + 1.0, (tiles,), batch=2, mesh=mesh)
assert torch.equal(out, tiles * 2.0 + 1.0), "tile_map mismatch"
u16, flag = tile_map(lambda t, s: ((t + s).to(torch.uint16), (t > 1000).all()), (tiles,), batch=1,
                     mesh=mesh, broadcast=(torch.tensor(3.0),), unbatched=True)
assert torch.equal(u16, (tiles + 3.0).to(torch.uint16)) and torch.equal(flag, (tiles > 1000).flatten(1).all(1))

total = tiles.sum((1, 2))
dist.all_reduce(total, op=dist.ReduceOp.SUM)
assert torch.equal(total, 2 * tiles.sum((1, 2))), "all_reduce mismatch"

pair = np.load(sys.argv[4])
step = make_sharded_register_step(mesh, TileGrid.for_image(pair["ref"].shape, 32, 8), 9, 1)
warped, flow, hist = step(torch.from_numpy(pair["ref"]), torch.from_numpy(pair["mov"]))
np.savez(sys.argv[5], warped=warped.numpy(), flow=flow.numpy(), hist=hist.numpy())
dist.destroy_process_group()
print("MULTIHOST_OK", pid, flush=True)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_tile_mesh(tmp_path, rng):
    h = w = 160  # 25 tiles of 32: the 4-shard axis is padded to 28
    ref = (rng.random((h, w)) * 255).astype(np.float32)
    mov = np.roll(ref, (1, 2), (0, 1))
    np.savez(tmp_path / "pair.npz", ref=ref, mov=mov)
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    coord = f"localhost:{_free_port()}"
    results = run_workers(script, lambda pid: [str(pid), coord, _REPO, str(tmp_path / "pair.npz"),
                                               str(tmp_path / f"out{pid}.npz")], 2, _TIMEOUT_S,
                          drop_env=_DIST_VARS)
    for pid, (rc, out) in enumerate(results):
        assert rc == 0 and f"MULTIHOST_OK {pid}" in out, f"worker {pid} failed:\n{out}"

    step1 = make_sharded_register_step(get_tile_mesh([torch.device("cpu")]),
                                       TileGrid.for_image((h, w), 32, 8), 9, 1)
    want = [t.numpy() for t in step1(torch.from_numpy(ref), torch.from_numpy(mov))]
    assert want[2].sum() == h * w
    for pid in range(2):
        got = np.load(tmp_path / f"out{pid}.npz")
        for name, x in zip(("warped", "flow", "hist"), want):
            np.testing.assert_array_equal(got[name], x, err_msg=f"rank {pid}: {name}")


def test_group_that_cannot_form_raises(tmp_path):
    """Rank 0 of a group of 2 whose peer never comes raises after its
    timeout instead of waiting."""
    script = tmp_path / "alone.py"
    script.write_text(
        "import os, sys\n"
        f"sys.path.insert(0, {_REPO!r})\n"
        "os.environ.update(MICROALIGNER_TPU_DIST='1', MICROALIGNER_TPU_DIST_COORD=sys.argv[1],\n"
        "                  MICROALIGNER_TPU_DIST_NPROC='2', MICROALIGNER_TPU_DIST_PID='0')\n"
        "from microaligner_tpu_torch.parallel import init_distributed_from_env\n"
        "init_distributed_from_env(timeout_s=2)\n"
        "print('FORMED', flush=True)\n")
    (rc, out), = run_workers(script, lambda pid: [f"localhost:{_free_port()}"], 1, _TIMEOUT_S,
                             drop_env=_DIST_VARS)
    assert rc != 0 and "FORMED" not in out, out
    assert "Timed out" in out or "timed out" in out, out


def test_dist_off_leaves_one_process(monkeypatch):
    for var in _DIST_VARS:
        monkeypatch.delenv(var, raising=False)
    assert init_distributed_from_env() is False
    monkeypatch.setenv("MICROALIGNER_TPU_DIST", "0")
    assert init_distributed_from_env() is False
    assert get_tile_mesh([torch.device("cpu")]).world_size is None


@pytest.mark.parametrize("devices", [["cpu", "cuda"], []], ids=["mixed", "empty"])
def test_mesh_refuses_bad_device_lists(devices):
    with pytest.raises(ValueError):
        get_tile_mesh([torch.device(d) for d in devices])
