"""The DTensor cell-sharded step (compose_tpu_torch.parallel.sharding, the
port of compose_tpu/parallel/sharding.py) on 2 and 8 gloo CPU ranks: the
model's unchanged single-device step on rho and q placed Shard(0) and
Shard(1), within 1e-13 of the port's single-device step (the JAX test's
bar, tests/test_sharding.py; it comes out bitwise here) and within 1e-12
of the JAX single-device step on the same numpy inputs; the default
QLT/mn2 CDR, the local QLT limiter and caas-node/caas, whose tree fills
and bound expansion run on each rank's whole copy; the outputs back in
the input placements; the collectives DTensor inserts; and K2's
DTensor route, cell-sharded only where the shards end on cells. Each rank
is a `python -c` process whose process group starts from a file under the
test's tmp_path, never a fixed port."""

import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from compose_tpu import driver as driver_jax
from compose_tpu.mesh import build as build_jax
from compose_tpu.transport import IslConfig as CfgJ
from compose_tpu.transport import IslTransport as IslJ
from compose_tpu.transport import gallery as gallery_jax
from compose_tpu_torch.mesh import cubed_sphere
from compose_tpu_torch.parallel import cell_mesh, shard_state, sharded_step
from compose_tpu_torch.transport import gallery
from compose_tpu_torch.transport.isl import IslConfig, IslTransport

ROOT = pathlib.Path(__file__).resolve().parents[1]
DT = 86400.0
CFG = dict(ne=4, np_=4, filter="caas", limiter="caas", rho_isl=True, nsub=2)

_RANK = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from compose_tpu_torch import _native
from compose_tpu_torch.mesh import cubed_sphere
from compose_tpu_torch.parallel import cell_mesh, shard_state, sharded_step
from compose_tpu_torch.parallel.sharding import CommCounter
from compose_tpu_torch.transport import gallery
from compose_tpu_torch.transport.cdr_fused import (limit_caas,
                                                   limit_caas_placements,
                                                   limit_caas_plain)
from compose_tpu_torch.transport.isl import IslConfig, IslTransport

torch.set_num_threads(1)
CDRS = (("qlt", "mn2", "f"), ("qlt", "qlt", "f"), ("caas-node", "caas", "es"))
rank, world, init, inp, out = sys.argv[1:]
rank, world = int(rank), int(world)
dist.init_process_group("gloo", init_method="file://" + init, rank=rank,
                        world_size=world)
dm = cell_mesh(world, "cpu")
d = np.load(inp)
mesh = cubed_sphere.build(4, 4, device="cpu")
model = IslTransport(mesh, gallery.create_wind("divergent"),
                     IslConfig(ne=4, np_=4, filter="caas", limiter="caas",
                               rho_isl=True, nsub=2))
rho_s, q_s = shard_state(dm, torch.from_numpy(d["rho"]),
                         torch.from_numpy(d["q"]))
res = {"in": (rho_s.placements, q_s.placements,
              rho_s.to_local().shape, q_s.to_local().shape)}
cc = CommCounter()
with cc:
    r, q = sharded_step(model, dm)(rho_s, q_s, 0.0, 86400.0)
res["out"] = (r.placements, q.placements, r.to_local().shape,
              q.to_local().shape)
res["comms"] = cc.per_op()
res["triggers"] = cc.triggers
res["rho"], res["q"] = r.full_tensor(), q.full_tensor()

# The other CDRs: the QLT tree, the local QLT limiter and caas-node's
# bound expansion run on each rank's whole copy (no sharding strategy).
res["cdr"] = {}
for filt, lim, dmc in CDRS:
    m = IslTransport(mesh, gallery.create_wind("divergent"),
                     IslConfig(ne=4, np_=4, filter=filt, limiter=lim,
                               dmc=dmc, nsub=2))
    ref = m.step(torch.from_numpy(d["rho"]), torch.from_numpy(d["q"]), 0.0,
                 86400.0)
    got = sharded_step(m, dm)(rho_s, q_s, 0.0, 86400.0)
    res["cdr"][filt, lim] = max(float((a.full_tensor() - b).abs().max())
                                for a, b in zip(got, ref))

# K2's DTensor route: the operands, whole and placed.
g = torch.Generator().manual_seed(7)
def k2_args(ncell, nt=2, np2=16):
    rhom = torch.rand((ncell, np2), generator=g, dtype=torch.float64) + .5
    rho = torch.rand((ncell, np2), generator=g, dtype=torch.float64) + .5
    lo = torch.rand((nt, ncell, np2), generator=g, dtype=torch.float64)
    hi = lo + torch.rand((nt, ncell, np2), generator=g, dtype=torch.float64)
    Q = (lo + hi) * rho / 2 + 0.1 * torch.randn(
        (nt, ncell, np2), generator=g, dtype=torch.float64)
    b = torch.sum(rhom * (lo + hi) / 2, -1)
    return [rhom, rho, Q, lo, hi, b]
k2 = {}
for name, ncell, qpl in (("cells", 12 * world, Shard(1)),
                         ("np2", 12 * world, Shard(2)),
                         ("replicated", 12 * world, Replicate()),
                         ("uneven", 12 * world + 1, Shard(1))):
    a = k2_args(ncell)
    pl = [Shard(0), Shard(0), qpl, qpl, qpl, Shard(1) if qpl == Shard(1)
          else Replicate()]
    da = [distribute_tensor(x, dm, [p]) for x, p in zip(a, pl)]
    placements, out_pl = limit_caas_placements(da[2])
    got = _native.on_local(limit_caas_plain, da, placements, out_pl)
    # A CPU DTensor takes the plain version, DTensor propagating its ops
    # (not across a cell's nodes: gloo has no all-to-all).
    plain_ok = name == "np2" or torch.equal(limit_caas(*da).full_tensor(),
                                            limit_caas_plain(*a))
    k2[name] = (placements is not None, got.placements,
                tuple(got.to_local().shape),
                torch.equal(got.full_tensor(), limit_caas_plain(*a)),
                plain_ok)
res["k2"] = k2
if rank == 0:
    torch.save(res, out)
dist.destroy_process_group()
"""


def _inputs():
    """The JAX test's model (tests/test_sharding.py:_model) and its state
    as numpy: rho 1, the gaussianhills and slottedcylinders tracers."""
    mj = build_jax(4, 4)
    qj = driver_jax.init_tracers(mj, ("gaussianhills", "slottedcylinders"))
    return mj, np.ones((mj.ncell, mj.np2)), np.asarray(qj)


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module", params=[2, 8])
def ranks(request, inputs, tmp_path_factory):
    world = request.param
    tmp = tmp_path_factory.mktemp(f"dtensor{world}")
    _, rho, q = inputs
    np.savez(tmp / "in.npz", rho=rho, q=q)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(r), str(world),
         str(tmp / "pg_init"), str(tmp / "in.npz"), str(tmp / "out.pt")],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    assert [p.returncode for p in procs] == [0] * world, logs
    return world, torch.load(tmp / "out.pt", weights_only=False)


def _port_step(rho, q):
    mesh = cubed_sphere.build(4, 4, device="cpu")
    model = IslTransport(mesh, gallery.create_wind("divergent"),
                         IslConfig(**CFG))
    return model.step(torch.tensor(rho), torch.tensor(q), 0.0, DT)


def test_dtensor_step_matches_single_device(ranks, inputs):
    _, rho, q = inputs
    _, res = ranks
    ref_rho, ref_q = _port_step(rho, q)
    dr = float(torch.max(torch.abs(res["rho"] - ref_rho)))
    dq = float(torch.max(torch.abs(res["q"] - ref_q)))
    assert dr < 1e-13, dr
    assert dq < 1e-13, dq


def test_dtensor_step_matches_jax_single_device(ranks, inputs):
    mj, rho, q = inputs
    _, res = ranks
    model = IslJ(mj, gallery_jax.create_wind("divergent"), CfgJ(**CFG))
    rj, qj = model.step(jnp.asarray(rho), jnp.asarray(q), 0.0, DT)
    np.testing.assert_allclose(res["rho"].numpy(), np.asarray(rj), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(res["q"].numpy(), np.asarray(qj), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("filt,lim", [("qlt", "mn2"), ("qlt", "qlt"),
                                      ("caas-node", "caas")])
def test_dtensor_step_other_cdrs(ranks, filt, lim):
    # QLT/mn2 (the default CDR), the cell-local QLT limiter, and
    # caas-node/caas (dmc es) with its bound expansion.
    _, res = ranks
    assert res["cdr"][filt, lim] < 1e-13


def test_dtensor_step_placements(ranks):
    from torch.distributed.tensor import Shard

    world, res = ranks
    ncell = 96
    local = (ncell // world, 16), (2, ncell // world, 16)
    assert res["in"] == ((Shard(0),), (Shard(1),)) + local
    assert res["out"] == ((Shard(0),), (Shard(1),)) + local


def test_dtensor_step_collectives(ranks):
    # GSPMD's counterpart: DTensor all-gathers the state, six all-gathers
    # of 44,544 bytes in all at ne4 with 2 tracers whatever the rank count
    # (against the halo exchange's O(perimeter)): rho and q at the
    # departure-cell gather (index), the padding of bfb_sum's pair tree on
    # the cell axis (the rho masses, then the tracer masses), and the
    # cells' q range at each node's departure cell (index, min and max).
    # After them the step runs replicated, so no sum is split per rank.
    _, res = ranks
    assert res["comms"] == {"all_gather_into_tensor": (6, 44544)}
    assert res["triggers"] == [
        ("all_gather_into_tensor", "index", [(96, 16)]),
        ("all_gather_into_tensor", "index", [(2, 96, 16)]),
        ("all_gather_into_tensor", "constant_pad_nd", [(2, 96)]),
        ("all_gather_into_tensor", "constant_pad_nd", [(2, 2, 96)]),
        ("all_gather_into_tensor", "index", [(2, 96)]),
        ("all_gather_into_tensor", "index", [(2, 96)])]


def test_k2_dtensor_route_shards_only_on_cells(ranks):
    world, res = ranks
    k2 = res["k2"]
    from torch.distributed.tensor import Replicate, Shard

    # Sharded on the cell axis, evenly: each rank limits its own cells.
    assert k2["cells"] == (True, (Shard(1),), (2, 12, 16), True, True)
    # Sharded across nodes of a cell, replicated, or uneven: whole.
    for name, ncell in (("np2", 12 * world), ("replicated", 12 * world),
                        ("uneven", 12 * world + 1)):
        assert k2[name] == (False, (Replicate(),), (2, ncell, 16), True,
                            True), name


def test_cell_mesh_needs_a_process_group(tmp_path):
    import torch.distributed as dist

    with pytest.raises(RuntimeError):
        cell_mesh(1, "cpu")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        with pytest.raises(ValueError):
            cell_mesh(2, "cpu")
        mesh = cell_mesh(1, "cpu")
        assert mesh.mesh_dim_names == ("cells",) and mesh.size() == 1
        # One rank: the DTensor step is the single-device step, bitwise.
        _, rho, q = _inputs()
        ref = _port_step(rho, q)
        m = cubed_sphere.build(4, 4, device="cpu")
        model = IslTransport(m, gallery.create_wind("divergent"),
                             IslConfig(**CFG))
        out = sharded_step(model, mesh)(
            *shard_state(mesh, torch.tensor(rho), torch.tensor(q)),
            0.0, DT)
        assert all(torch.equal(a.full_tensor(), b) for a, b in zip(out, ref))
    finally:
        dist.destroy_process_group()
