"""Phase timing of the flagship ISL step on the port (compose_tpu's
tools/profile_step.py, with tools/profile_step2.py's finer CDR split under
--fine).

Rows: the trajectories (nsub 8), cell location, sphere_to_ref, all of the
departure data, the interpolation of the tracers, the departure Jacobian,
the full step, the step with no filter or limiter, and the step at one
tracer; then the program's spans (trace.py) over the FULL STEP row's
calls: each phase's host seconds per step and share of the step. Each
row is the median of 20 calls (10 for the steps) after a warm-up, each
call timed by CUDA events on a card (the host clock on the CPU).
The configuration is the JAX tool's: ne30 np4, 40 tracers, pisl
caas/caas, rho_isl, nsub 8, f32 geometry.

    python -m compose_tpu_torch.tools.profile_step [--fine] [--ne 30]
        [--nt 40] [--device cuda]
"""

import argparse
import statistics
import sys
import time

import torch

from .. import driver, trace
from ..config import F64, resolve_device
from ..mesh import cubed_sphere
from ..ops import sqr
from ..transport import gallery, limiter as limmod, timeint
from ..transport.isl import IslConfig, IslTransport

ICS = ("gaussianhills", "slottedcylinders", "cosinebells", "xyztrig")


def median_ms(fn, n, device):
    """Median ms of n calls of fn after one warm-up; returns (ms, the last
    output)."""
    out = fn()
    cuda = device.type == "cuda"
    ms = []
    for _ in range(n):
        if cuda:
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            out = fn()
            b.record()
            b.synchronize()
            ms.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            out = fn()
            ms.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ms), out


def profile(ne=30, nt=40, device="cuda", fine=False):
    """Print the table; returns {row: ms}."""
    dev = resolve_device(device)
    mesh = cubed_sphere.build(ne, 4, device=dev, dtype=F64)
    wind = gallery.create_wind("divergent")
    cfg = dict(ne=ne, np_=4, rho_isl=True, nsub=8, geom_dtype="f32")
    model = IslTransport(mesh, wind, IslConfig(filter="caas",
                                               limiter="caas", **cfg))
    rho = torch.ones((mesh.ncell, mesh.np2), dtype=F64, device=dev)
    q1 = driver.init_tracers(mesh, ICS)
    q = q1.repeat(-(-nt // q1.shape[0]), 1, 1)[:nt].contiguous()
    dt = 86400.0 * 12 / 120
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"profile_step ne{ne} np4 {nt} tracers, device {name}")
    res = {}

    def row(label, fn, n=20):
        res[label], out = median_ms(fn, n, dev)
        print(f"{label:28s} {res[label]:8.3f} ms", flush=True)
        return out

    xyz = mesh.cgll_xyz.to(torch.float32)
    dep = row("trajectories (nsub=8)", lambda: timeint.integrate(
        wind.velocity, dt, 0.0, xyz, 8))
    ci, a0, b0 = row("locate", lambda: cubed_sphere.locate(mesh, dep))
    corners = mesh.corners[ci].to(torch.float32)
    tol = 1e1 * float(torch.finfo(torch.float32).eps)
    row("sphere_to_ref", lambda: sqr.sphere_to_ref(
        corners, dep, max_its=3, tol=tol, a0=a0, b0=b0))
    dep_, ci_, w = row("departure_data (all)",
                       lambda: model._departure_data(0.0, dt))
    row(f"interp {nt} tracers", lambda: model._interp(q, ci_, w))
    row("jacobian_departure", lambda: model._jacobian_departure(dep_))
    trace.enable()
    trace.reset()
    row("FULL STEP", lambda: model.step(rho, q, 0.0, dt), n=10)
    trace.disable()
    summ = trace.summary()
    bare = IslTransport(mesh, wind, IslConfig(filter="none", limiter="none",
                                              **cfg))
    row("step w/o CDR", lambda: bare.step(rho, q, 0.0, dt), n=10)
    row("step nt=1", lambda: model.step(rho, q[:1], 0.0, dt), n=10)
    if fine:
        _fine_rows(model, rho, q, dt, row)
    nstep = summ["spans"]["isl.step"]["count"]
    for k, d in summ["spans"].items():
        res[f"span {k}"] = d["s"] / nstep * 1e3
    for line in trace.step_table(summ):
        print(f"span {line}")
    return res


def _fine_rows(model, rho, q, dt, row):
    """tools/profile_step2.py: the post-interpolation region, piece by
    piece (its "rho path" row is the step at one tracer above)."""
    F = model.F
    nt = q.shape[0]
    dep, ci, w = model._departure_data(0.0, dt)
    _, q_tgt, nsc = row("interp+scatter", lambda: model._interp_phase(
        rho, q, dep, ci, w))

    def bounds():
        return (torch.amin(q, -1)[:, nsc], torch.amax(q, -1)[:, nsc])
    qmin_n, qmax_n = row("bounds gather", bounds)

    def records():
        rhom = F * rho
        return (torch.sum(rhom * qmin_n, -1), torch.sum(rhom * qmax_n, -1),
                torch.sum(F * q_tgt * rho, -1))
    Qc_min, Qc_max, Qc_mass = row("records", records)
    redist = row("redistribute (caas)", lambda: model.mrd.redistribute(
        torch.sum(F * rho, -1), Qc_min, Qc_mass, Qc_max,
        torch.zeros(nt, dtype=F64, device=q.device)))
    Q = q_tgt * rho
    lim = row("limit_tracer (caas)", lambda: limmod.limit_tracer(
        F, rho, Q, qmin_n, qmax_n, redist - Qc_mass, limiter="caas"))
    row("Q->q + clip", lambda: torch.minimum(torch.maximum(
        lim / torch.where(rho == 0, 1.0, rho), qmin_n), qmax_n))
    row("dss_q", lambda: model._dss_q(rho, q_tgt))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--fine", action="store_true",
                    help="also the CDR split of tools/profile_step2.py")
    ap.add_argument("--ne", type=int, default=30)
    ap.add_argument("--nt", type=int, default=40)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    profile(a.ne, a.nt, a.device, a.fine)
    return 0


if __name__ == "__main__":
    sys.exit(main())
