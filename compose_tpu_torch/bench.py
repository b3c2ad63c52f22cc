"""Benchmark of the port: tracer-DOF/s of the flagship ISL step on one
card (bench.py's configuration and JSON line).

    python -m compose_tpu_torch.bench [--device cuda]

Configuration (bench.py:37-50): ne30 np4, 40 tracers (the four ICs of
bench.py:44-47 tiled), pisl with CAAS property preservation and the CAAS
cell-local limiter, rho_isl, nsub 8, the divergent wind, f32 geometry and
interpolation under the f64 CDR (x64 on), dt = 12 days / 120; one warm-up
step, then 10 timed steps. The host clock reads around the timed steps
follow a device synchronize; each step is also timed by CUDA events.

Prints ONE JSON line with bench.py's keys (metric, value in tracer-DOF/s,
unit, detail with platform, x64, sec_per_step, ncell, np2, ntracer),
`detail` adding the device's name, the per-step times and their median,
and the Observer's mass and bounds errors over every step's state
(diagnostics.Observer, the bars of chip_smoke.py: mass < 1e-12 per step,
bounds < 5e-13). It exits non-zero when the state holds a NaN or either
bar is missed. There is no f32 retry and no fallback to another device.
"""

import argparse
import json
import statistics
import sys
import time

import torch

from . import driver
from .config import F64, resolve_device
from .diagnostics import Observer
from .mesh import cubed_sphere
from .transport import gallery
from .transport.isl import IslConfig, IslTransport

ICS = ("gaussianhills", "slottedcylinders", "cosinebells", "xyztrig")
MASS_BAR, BOUNDS_BAR = 1e-12, 5e-13


def run_bench(device="cuda", ne=30, np_=4, nt=40, nsteps_timed=10, nsub=8):
    """Time the flagship step; returns bench.py's dict (no vs_baseline)."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    mesh = cubed_sphere.build(ne, np_, device=dev, dtype=F64)
    cfg = IslConfig(ne=ne, np_=np_, filter="caas", limiter="caas",
                    rho_isl=True, nsub=nsub, geom_dtype="f32",
                    interp_dtype="f32")
    model = IslTransport(mesh, gallery.create_wind("divergent"), cfg)
    rho = torch.ones((mesh.ncell, mesh.np2), dtype=F64, device=dev)
    q1 = driver.init_tracers(mesh, ICS)
    q = q1.repeat(-(-nt // q1.shape[0]), 1, 1)[:nt].contiguous()
    dt = 86400.0 * 12 / 120

    states = [(rho, q)]
    states.append(model.step(rho, q, 0.0, dt))          # warm-up
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    marks = []
    sync()
    t0 = time.perf_counter()
    for i in range(1, nsteps_timed + 1):
        marks.append(_mark(cuda))
        states.append(model.step(*states[-1], i * dt, (i + 1) * dt))
    marks.append(_mark(cuda))
    sync()
    el = time.perf_counter() - t0
    step_ms = [_elapsed_ms(a, b) for a, b in zip(marks[:-1], marks[1:])]

    obs = Observer(mesh.dgbfi_gll, mesh.dgbfi_sphere,
                   ["rho"] + [f"q{i}" for i in range(nt)])
    for k, (r, qq) in enumerate(states):
        obs.add_obs(k * dt, r, list(qq))
    _, mass_err, bounds_err = obs.check(MASS_BAR, BOUNDS_BAR)
    r, qq = states[-1]
    dof_per_step = mesh.ncell * mesh.np2 * nt
    return {
        "metric": (f"tracer-DOF/s per chip (ne{ne}, np{np_}, {nt} tracers, "
                   f"pisl+caas)"),
        "value": dof_per_step * nsteps_timed / el,
        "unit": "DOF/s",
        "detail": {
            "platform": "gpu" if cuda else "cpu",
            "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
            "x64": True,
            "sec_per_step": el / nsteps_timed,
            "step_ms": step_ms,
            "step_ms_median": statistics.median(step_ms),
            "step_ms_from": "CUDA events" if cuda else "host clock",
            "ncell": mesh.ncell, "np2": mesh.np2, "ntracer": nt,
            "finite": bool(torch.isfinite(r).all())
            and bool(torch.isfinite(qq).all()),
            "mass_rel_err": mass_err,
            "bounds_violation": bounds_err,
        },
    }


def _mark(cuda):
    if not cuda:
        return time.perf_counter()
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _elapsed_ms(a, b):
    if isinstance(a, float):
        return (b - a) * 1e3
    return a.elapsed_time(b)


def failures(out):
    """The invariants `out` misses: a NaN in the state, or mass or bounds
    over their bars."""
    d = out["detail"]
    bad = [] if d["finite"] else ["non-finite state"]
    if not d["mass_rel_err"] < MASS_BAR:
        bad.append(f"mass_rel_err {d['mass_rel_err']:.3e} >= {MASS_BAR:g}")
    if not d["bounds_violation"] < BOUNDS_BAR:
        bad.append(f"bounds_violation {d['bounds_violation']:.3e} >= "
                   f"{BOUNDS_BAR:g}")
    return bad


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    out = run_bench(device=a.device)
    print(json.dumps(out), flush=True)
    bad = failures(out)
    if bad:
        sys.stderr.write("bench: " + "; ".join(bad) + "\n")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
