"""End-to-end transport runs (compose_tpu.driver), for the ISL methods pisl
and pislu (pisl with the plain GLL interpolant) with every ISL option:
mesh + wind + initial conditions, the time loop with the reference's
per-step checks on tracer 0 (mass in the measure the model conserves:
sphere for dmc es, else GLL; bounds, or nonnegativity alone for a
positive-only filter), and the final error norms of the reference's
`print_error`. The mixed `isl` method, IR/CDG, p-refinement and subcell
meshes are not ported and raise NotImplementedError.

`x64=False` is the single-precision route, the counterpart of the JAX
package's COMPOSE_TPU_X64=0: the state, the mesh tables, the geometry and
the CDR are all f32. The checks and error norms are measured in f64 in
both routes, so that they do not measure their own rounding.
"""

import dataclasses
import time

import numpy as np
import torch

from . import constants
from .config import F64, real_dtype, resolve_device
from .mesh import cubed_sphere
from .ops import sphere
from .ops.reduce import bfb_sum
from .transport import gallery
from .transport.isl import IslConfig, IslTransport


@dataclasses.dataclass
class RunOutput:
    """Final metrics, named as the reference's Output struct."""
    l2_err: float
    max_err: float
    l1_err: float
    mass_s: float
    mass_e: float
    mass_gll_s: float
    mass_gll_e: float
    min_s: float
    max_s: float
    min_e: float
    max_e: float
    et_timestep: float
    max_step_mass_err: float
    max_step_bounds_err: float

    @property
    def cv(self):
        return _reldif(self.mass_s, self.mass_e)

    @property
    def cv_gll(self):
        return _reldif(self.mass_gll_s, self.mass_gll_e)

    def one_liner(self, **kv):
        parts = ["<OL>"] + [f"{k} {v}" for k, v in kv.items()]
        parts += [
            f"re l2 {self.l2_err:9.3e} max {self.max_err:9.3e}",
            f"cv re {self.cv:9.3e}", f"cvgll re {self.cv_gll:9.3e}",
            f"mo min {self.min_s:9.3e} {self.min_e:9.3e} "
            f"{self.min_e - self.min_s:9.3e} "
            f"max {self.max_s:9.3e} {self.max_e:9.3e} "
            f"{self.max_e - self.max_s:9.3e}",
            f"et ts {self.et_timestep:9.3e}",
        ]
        return " ".join(parts)


def _reldif(a, b):
    return abs(b - a) / max(1.0, abs(a))


def init_tracers(mesh, ic_names):
    """Evaluate the ICs at the CGLL nodes and inject to the DGLL slots:
    (nt, ncell, np2) in the mesh's dtype on its device."""
    lat, lon = sphere.xyz2ll(mesh.cgll_xyz)
    d2c = mesh.dgll2cgll.reshape(-1)
    return torch.stack([
        gallery.initial_condition(n, lat, lon)[d2c].reshape(mesh.ncell,
                                                           mesh.np2)
        for n in ic_names])


def summarize(mesh, f0, rho0, f, rho, et_timestep=0.0,
              max_step_mass_err=0.0, max_step_bounds_err=0.0):
    """The reference's final error norms of a tracer (print_error): f0, f
    its initial and final mixing ratios, rho0, rho the densities. Computed
    in f64 on the host whatever the run's dtype."""
    fs, ds, fe, de, w, wg = (
        x.reshape(-1).to(F64).cpu().numpy()
        for x in (f0, rho0, f, rho, mesh.dgbfi_sphere, mesh.dgbfi_gll))
    e = fe - fs
    return RunOutput(
        l2_err=float(np.sqrt(np.sum(w * e * e) / np.sum(w * fs * fs))),
        max_err=float(np.max(np.abs(e)) / np.max(np.abs(fs))),
        l1_err=float(np.sum(w * np.abs(e)) / np.sum(w * np.abs(fs))),
        mass_s=float(np.sum(w * fs * ds)), mass_e=float(np.sum(w * fe * de)),
        mass_gll_s=float(np.sum(wg * fs * ds)),
        mass_gll_e=float(np.sum(wg * fe * de)),
        min_s=float(fs.min()), max_s=float(fs.max()),
        min_e=float(fe.min()), max_e=float(fe.max()),
        et_timestep=et_timestep,
        max_step_mass_err=max_step_mass_err,
        max_step_bounds_err=max_step_bounds_err,
    )


def run(ne=10, np_=4, nsteps=12, T_days=12.0, ics=("gaussianhills",),
        ode="divergent", method="pisl", filter_="qlt", limiter="mn2",
        basis="GllNodal", nsub=8, dmc="none", geom_dtype="f64",
        interp_dtype="f64", verbose=True, fitext=False, rotate_grid=False,
        timeint="exact", nonuni=False, prefine=0, mesh_type="geometric", *,
        x64=True, device="cuda"):
    """One slmmir-style ISL run on `device` (the current CUDA device
    unless the CPU is asked for), in f64 or, with x64=False, in f32;
    returns RunOutput."""
    if method not in ("pisl", "pislu"):
        raise NotImplementedError(f"method '{method}' is not ported")
    if prefine:
        raise NotImplementedError(f"prefine {prefine} is not ported")
    # Positive-only filter spellings: only qlt-pve is positive-only;
    # caas-pve is the caas redistribution with the standard bounds.
    positive_only = filter_ == "qlt-pve"
    if filter_.endswith("-pve"):
        filter_ = filter_[:-len("-pve")]
    rotate = None
    if rotate_grid:
        # The reference's fixed rotations: vortex problems probe the cube
        # corners; otherwise keep the solid-body center off a node.
        if ode.lower() == "movingvortices":
            rotate = ((1.0, 0.0, 0.0), 0.97654321 * np.pi / 4)
        else:
            rotate = ((0.11111, -0.051515, 1.0), 0.142314 * np.pi)
    dev = resolve_device(device)
    dtype = real_dtype(x64)
    mesh = cubed_sphere.build(ne, np_, basis, device=dev, dtype=dtype,
                              rotate=rotate, nonuni=nonuni,
                              mesh_type=mesh_type)
    wind = gallery.create_wind(ode)
    cfg = IslConfig(ne=ne, np_=np_, basis="Gll" if method == "pislu"
                    else basis, filter=filter_, limiter=limiter,
                    rho_isl=True, nsub=nsub,
                    dmc="f" if dmc == "none" else dmc,
                    positive_only=positive_only, fitext=fitext,
                    timeint=timeint, geom_dtype=geom_dtype,
                    interp_dtype=interp_dtype, rotate=rotate)
    model = IslTransport(mesh, wind, cfg)

    rho = torch.ones((mesh.ncell, mesh.np2), dtype=dtype, device=dev)
    q = init_tracers(mesh, ics)
    q0, rho0 = q, rho
    T = constants.day2sec(T_days)
    dt = T / nsteps
    # The per-step mass check's measure: the one the model conserves.
    F_check = (mesh.dgbfi_sphere if dmc == "es"
               else mesh.dgbfi_gll).reshape(-1).to(F64)

    def tracer0_stats(q, rho):
        # One host read per step: mass (bfb tree, in f64), min, max of
        # tracer 0.
        Q = (q[0].to(F64) * rho.to(F64)).reshape(-1)
        return torch.stack([bfb_sum(F_check * Q), torch.amin(q[0]).to(F64),
                            torch.amax(q[0]).to(F64)]).tolist()

    mass_prev, q_min0, q_max0 = tracer0_stats(q, rho)
    max_step_mass_err = 0.0
    max_step_bounds_err = 0.0
    t_start = time.time()
    for step in range(nsteps):
        ts = dt * step
        tf = T if step == nsteps - 1 else ts + dt
        rho, q = model.step(rho, q, ts, tf)
        mass, qmin, qmax = tracer0_stats(q, rho)
        max_step_mass_err = max(max_step_mass_err,
                                abs(mass - mass_prev) / max(1.0, abs(mass)))
        mass_prev = mass
        if positive_only:
            # Positive-only runs check nonnegativity only.
            bounds = (max(0.0, -qmin),)
        else:
            bounds = (max(0.0, q_min0 - qmin), max(0.0, qmax - q_max0))
        max_step_bounds_err = max(max_step_bounds_err, *bounds)
    et = (time.time() - t_start) / nsteps
    out = summarize(mesh, q0[0], rho0, q[0], rho, et, max_step_mass_err,
                    max_step_bounds_err)
    if verbose:
        print(out.one_liner(method=method, ode=ode, ic=ics[0], np=np_, ne=ne,
                            nsteps=nsteps, mono=filter_, lim=limiter))
    return out
