"""The sharded ISL step on torch.distributed (DistComm) with the gloo
backend: two CPU processes, bitwise equal to the same step under LocalComm
in one process, through both entry points (step on the global state,
step_blocks on each rank's block). The process group starts from a file
under the test's tmp_path, never a fixed TCP port."""

import pathlib
import subprocess
import sys

import pytest
import torch

from compose_tpu_torch import driver
from compose_tpu_torch.mesh import cubed_sphere
from compose_tpu_torch.parallel.comm import DistComm
from compose_tpu_torch.parallel.sharded import ShardedIsl
from compose_tpu_torch.transport import gallery
from compose_tpu_torch.transport.isl import IslConfig, IslTransport

ROOT = pathlib.Path(__file__).resolve().parents[1]

DT = 86400.0 * 12 / 120
CONFIGS = (("caas", "caas"), ("qlt", "mn2"))

_RANK = r"""
import sys
import torch
import torch.distributed as dist
from compose_tpu_torch import driver
from compose_tpu_torch.mesh import cubed_sphere
from compose_tpu_torch.parallel.comm import DistComm
from compose_tpu_torch.parallel.sharded import ShardedIsl
from compose_tpu_torch.transport import gallery
from compose_tpu_torch.transport.isl import IslConfig, IslTransport

torch.set_num_threads(1)
rank, init, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method="file://" + init, rank=rank,
                        world_size=2)
comm = DistComm()
assert comm.device == torch.device("cpu") and comm.size == 2
dt = 86400.0 * 12 / 120
res = {}
for filt, lim in (("caas", "caas"), ("qlt", "mn2")):
    mesh = cubed_sphere.build(3, 4, device="cpu")
    model = IslTransport(mesh, gallery.create_wind("divergent"),
                         IslConfig(ne=3, nsub=2, filter=filt, limiter=lim))
    rho = torch.ones((mesh.ncell, 16), dtype=torch.float64)
    q = driver.init_tracers(mesh, ["gaussianhills", "slottedcylinders"])
    sh = ShardedIsl(model, 2, comm=comm)
    r, qq = rho, q
    rb, qb = sh.to_block(rho, rank), sh.to_block(q, rank)
    for s in range(2):
        r, qq = sh.step(r, qq, s * dt, (s + 1) * dt)
        rb, qb = sh.step_blocks(rb, qb, s * dt, (s + 1) * dt)
    res[filt] = (r, qq, rb, qb)
torch.save(res, out)
dist.destroy_process_group()
"""


def test_gloo_two_ranks_bitwise_equal_local_comm(tmp_path):
    init = tmp_path / "pg_init"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(r), str(init),
         str(tmp_path / f"rank{r}.pt")], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], logs
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    for filt, lim in CONFIGS:
        mesh = cubed_sphere.build(3, 4, device="cpu")
        model = IslTransport(mesh, gallery.create_wind("divergent"),
                             IslConfig(ne=3, nsub=2, filter=filt,
                                       limiter=lim))
        rho = torch.ones((mesh.ncell, 16), dtype=torch.float64)
        q = driver.init_tracers(mesh, ["gaussianhills", "slottedcylinders"])
        sh = ShardedIsl(model, 2)
        ref = (rho, q)
        for s in range(2):
            ref = sh.step(*ref, s * DT, (s + 1) * DT)
        assert all(torch.equal(a, b) for a, b in
                   zip(ref, model.step(*model.step(rho, q, 0.0, DT), DT,
                                       2 * DT)))
        for r in range(2):
            got_r, got_q, blk_r, blk_q = ranks[r][filt]
            assert torch.equal(got_r, ref[0]) and torch.equal(got_q, ref[1])
            assert torch.equal(blk_r, sh.to_block(ref[0], r))
            assert torch.equal(blk_q, sh.to_block(ref[1], r))


def test_dist_comm_nccl_needs_a_gpu(tmp_path, monkeypatch):
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        assert DistComm().size == 1
        monkeypatch.setattr(dist, "get_backend", lambda group=None: "nccl")
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError):
            DistComm()
    finally:
        monkeypatch.undo()
        dist.destroy_process_group()
    with pytest.raises(RuntimeError):
        DistComm()                       # no process group
