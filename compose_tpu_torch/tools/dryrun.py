"""The single-device entry step, the multi-device dry run and the
comm-volume accounting of the sharded step: the port of the repo root's
entry module (`__graft_entry__.py`), with its names and semantics.

  entry(device)              - a forward ISL step on ne6 np4 with 4
                               tracers (qlt/caas, rho_isl, nsub 2) and
                               its arguments (`__graft_entry__.py:14-40`);
  comm_accounting(sh, ...)   - bytes received per shard and step, by
                               phase, for the dry run's layout and at the
                               flagship size in strips, in 2-D tiles with
                               the ring-2 halo and in tiles with the
                               measured-footprint halo (`:43-128`);
  dryrun_multichip(n, ...)   - one sharded step at ne4 (3 tracers, qlt/
                               caas) in strips and in tiles, each bitwise
                               equal to the single-device step, then the
                               sharded IR dry run and the accounting
                               (`:131-181`).

Any miss raises. The dry run writes its accounting as JSON only to the
path it is given (the JAX package's writes MULTICHIP_comm.json into the
working directory; that committed file is the JAX package's output at 8
devices, and the port's accounting equals it byte for byte).

    python -m compose_tpu_torch.tools.dryrun [--ndev 8] [--device cuda]
        [--out PATH] [--no-measured-halo] [--entry]

prints one JSON line: the accounting, the largest differences of the
sharded steps from the single-device step (all 0) and dryrun_ir's two,
and the measured leg's seconds.
"""

import argparse
import json
import math
import sys
import time

import torch

from .. import driver
from ..config import resolve_device
from ..mesh import cubed_sphere
from ..parallel.halo import DssSlotExchange, HaloMaps, tile_owner
from ..parallel.sharded import ShardedIsl, measured_need
from ..parallel.sharded_ir import dryrun_ir
from ..transport import gallery
from ..transport.isl import IslConfig, IslTransport

ICS = ("gaussianhills", "slottedcylinders", "cosinebells", "xyztrig")
DT = 86400.0 / 10


def make_model(ne, nt, device):
    """The ne`ne` np4 model, qlt/caas, rho_isl, nsub 2, the divergent
    wind; rho 1 and the first nt of ICS."""
    mesh = cubed_sphere.build(ne, 4, device=device)
    cfg = IslConfig(ne=ne, np_=4, filter="qlt", limiter="caas",
                    rho_isl=True, nsub=2)
    model = IslTransport(mesh, gallery.create_wind("divergent"), cfg)
    rho = torch.ones((mesh.ncell, mesh.np2), dtype=mesh.dtype,
                     device=mesh.device)
    q = driver.init_tracers(mesh, ICS[:nt])
    return model, mesh, rho, q


def entry(device=None):
    """(fn, (rho, q)): fn(rho, q) is one forward step from 0 to 86400/10 s
    (IslTransport._step_impl) on ne6 np4 with 4 tracers, qlt/caas; it
    leaves its arguments unchanged. On the card (default) its first call
    builds and loads the kernels (K2 once and K3 twice per call)."""
    model, _, rho, q = make_model(6, 4, resolve_device(device))

    def fn(rho, q):
        return model._step_impl(rho, q, 0.0, DT)

    return fn, (rho, q)


def _phases(mesh, maps, nt, n_shards):
    """Bytes received per shard and step by phase: the (rho, q) halo
    exchange, the DSS slot exchanges (rho; rho and q), the BFB tree sums
    (O(log2 n) partials of 2 + 2 nt scalars), the QLT frontier gather (4
    scalars x nt x 2 n frontier nodes); against them the all-gather
    layout's volume and the state one shard holds."""
    np2 = mesh.np2
    d2c = mesh.dgll2cgll.cpu().numpy().reshape(-1)
    slots4 = mesh.c2d_idx.cpu().numpy()[d2c]
    mask4 = mesh.c2d_mask.cpu().numpy()[d2c]
    dssx = DssSlotExchange(maps, slots4, mask4, np2)
    halo_state = int(maps.bytes_per_exchange(nt + 1, np2))
    dss_rho = int(dssx.bytes_per_exchange(1))
    dss_q = int(dssx.bytes_per_exchange(nt + 1))
    gsum = 8 * (2 + 2 * nt) * max(1, math.ceil(math.log2(n_shards)))
    frontier = 8 * 4 * nt * n_shards * 2
    out = {
        "halo_state_bytes": halo_state,
        "dss_rho_bytes": dss_rho,
        "dss_q_bytes": dss_q,
        "gsum_bytes": gsum,
        "qlt_frontier_bytes": frontier,
        "total_bytes": halo_state + dss_rho + dss_q + gsum + frontier,
        "allgather_layout_bytes": int(maps.max_send * maps.n_shards * np2
                                      * 8 * (nt + 1)),
        "state_bytes_per_chip": mesh.ncell // n_shards * np2 * 8 * (nt + 1),
    }
    out["comm_fraction_of_state"] = (out["total_bytes"]
                                     / out["state_bytes_per_chip"])
    return out


def _measured_model(mesh):
    """The model whose departure footprint makes the measured-footprint
    halo: pisl caas/caas, rho_isl, f32 geometry and interpolation, nsub 2
    (as the JAX package's accounting was built; the bench runs nsub 8)."""
    cfg = IslConfig(ne=mesh.ne, np_=4, filter="caas", limiter="caas",
                    rho_isl=True, nsub=2, geom_dtype="f32",
                    interp_dtype="f32")
    return IslTransport(mesh, gallery.create_wind("divergent"), cfg)


def comm_accounting(sh, nt, n_shards, ne_flagship=30, nt_flagship=40,
                    measured_halo=True, report=None):
    """Per-phase bytes received per shard and step (_phases) for the
    ShardedIsl `sh` with nt tracers ("dryrun"), and at the flagship size
    (ne_flagship np4, nt_flagship tracers) over the same shard count in
    strips, in tile_owner's 2-D tiles with the ring-2 halo, and, with
    `measured_halo`, in tiles with the measured-footprint halo: the
    departure cells of 120 windows of 12 days / 120 (_measured_model on
    sh's device) united with ring 1. The keys are the JAX package's,
    `ne30_nt40` whatever the flagship size. A `report` dict receives the
    measured leg's seconds as "measured_leg_s"."""
    acct = {"dryrun": _phases(sh.m, sh.maps, nt, n_shards)}
    mf = cubed_sphere.build(ne_flagship, 4, device=sh.m.device)
    ow = tile_owner(mf, n_shards)
    acct["flagship_ne30_nt40_strip"] = _phases(
        mf, HaloMaps(mf, n_shards, depth=sh.maps.depth), nt_flagship,
        n_shards)
    acct["flagship_ne30_nt40_tile_ring2"] = _phases(
        mf, HaloMaps(mf, n_shards, depth=sh.maps.depth, owner=ow),
        nt_flagship, n_shards)
    if measured_halo:
        w0 = time.perf_counter()
        dt = 86400.0 * 12 / 120
        need = measured_need(_measured_model(mf), ow, n_shards,
                             [(i * dt, (i + 1) * dt) for i in range(120)])
        if report is not None:
            report["measured_leg_s"] = time.perf_counter() - w0
        acct["flagship_ne30_nt40"] = _phases(
            mf, HaloMaps(mf, n_shards, owner=ow, need_sets=need),
            nt_flagship, n_shards)
        acct["flagship_ne30_nt40"]["halo"] = "tile + measured footprint"
    return acct


def _bitwise(label, got, ref):
    """The largest |got - ref| over (rho, q); raises unless bitwise."""
    d = max(float((a - b).abs().max()) for a, b in zip(got, ref))
    if not all(torch.equal(a, b) for a, b in zip(got, ref)):
        raise AssertionError(f"dry run: the {label} step differs from the "
                             f"single-device step by {d}")
    return d


def dryrun_multichip(n_shards, device=None, comm=None, out=None,
                     measured_halo=True, report=None):
    """One cell-sharded step over `n_shards` shards (ShardedIsl: halo
    exchange, BFB tree sums, the sharded QLT, K2 and K3 per shard) of the
    ne4 np4 model with 3 tracers, qlt/caas, from rho 1: inside its halo,
    finite, bitwise equal to IslTransport.step in contiguous strips and in
    tile_owner's 2-D tiles; then parallel.sharded_ir.dryrun_ir and the
    comm-volume accounting, returned (and written as JSON to `out` if
    given). `comm`: a LocalComm on `device` (default) or a DistComm of
    n_shards ranks, each of which runs every check on the global state.
    `measured_halo=False` leaves out the accounting's measured-footprint
    row and its 120 ne30 departure integrations. A `report` dict receives
    the largest differences from the single-device steps as "max_diff"
    ("strips", "tiles" and dryrun_ir's "ir" pair) and comm_accounting's
    "measured_leg_s". Raises on any miss."""
    dev = resolve_device(comm.device if device is None and comm is not None
                         else device)
    if comm is not None and comm.device != dev:
        raise ValueError(f"dry run: device {dev} but the communicator's is "
                         f"{comm.device}")
    model, mesh, rho, q = make_model(4, 3, dev)
    sh = ShardedIsl(model, n_shards, comm=comm)
    if not sh.coverage_ok(0.0, DT):
        raise AssertionError("dry run: the halo misses the step's departure "
                             "footprint")
    if not sh.maps.comm_fraction <= 1.0:
        raise AssertionError(f"dry run: the halo holds "
                             f"{sh.maps.comm_fraction} of the cells")
    got = sh.step(rho, q, 0.0, DT)
    if not all(bool(torch.isfinite(x).all()) for x in got):
        raise AssertionError("dry run: the sharded step is not finite")
    ref = model.step(rho, q, 0.0, DT)
    diffs = {"strips": _bitwise("strips", got, ref)}
    sht = ShardedIsl(model, n_shards, comm=comm,
                     owner=tile_owner(mesh, n_shards))
    diffs["tiles"] = _bitwise("tiles", sht.step(rho, q, 0.0, DT), ref)
    diffs["ir"] = dryrun_ir(n_shards, mesh.device, comm=comm)
    if report is not None:
        report["max_diff"] = diffs
    acct = comm_accounting(sh, q.shape[0], n_shards,
                           measured_halo=measured_halo, report=report)
    if out is not None:
        with open(out, "w") as f:
            json.dump(acct, f, indent=1)
    return acct


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ndev", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None,
                    help="also write the accounting as JSON to this path")
    ap.add_argument("--no-measured-halo", action="store_true",
                    help="leave out the measured-footprint row")
    ap.add_argument("--entry", action="store_true",
                    help="also run entry()'s step once")
    a = ap.parse_args(argv)
    report = {}
    acct = dryrun_multichip(a.ndev, a.device, out=a.out,
                            measured_halo=not a.no_measured_halo,
                            report=report)
    res = {"accounting": acct, **report}
    if a.entry:
        fn, (rho, q) = entry(a.device)
        rho2, q2 = fn(rho, q)
        w = cubed_sphere.build(6, 4, device=rho.device).dgbfi_gll
        m0 = torch.stack([(w * rho).sum()] + [(w * rho * x).sum()
                                             for x in q])
        m1 = torch.stack([(w * rho2).sum()] + [(w * rho2 * x).sum()
                                              for x in q2])
        res["entry_mass_change"] = float(((m1 - m0) / m0).abs().max())
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
