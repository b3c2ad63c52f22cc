"""End-to-end transport runs (compose_tpu.driver): the ISL methods pisl
and pislu (pisl with the plain GLL interpolant) with every ISL option, the
cell-integrated methods ir and cdg, the mixed method isl (density by the
cell-integrated remap, tracers by ISL), and the p-refinement experiments
1 and 5; geometric and subcell meshes; the terminator toy chemistry, on
the GLL nodes or (pg > 0) on the nphys x nphys physics grid with its
tendencies remapped back. Mesh + wind + initial conditions, the time loop
with the reference's per-step checks on tracer 0 (mass in the measure the
model conserves: sphere for dmc es under ISL, the IR measure
`IrTransport.F_mass` under ir/cdg, the v grid's `PRefineTransport.F_v`
under prefine 5 and the fine grid's `F_f` under prefine 1, else GLL;
bounds, or nonnegativity alone for a positive-only filter), and the final
error norms of the reference's `print_error`.

The JAX driver checks a prefine-5 dmc es run's first step in the sphere
measure and every later step in the GLL one; the port checks every step
in the measure the run conserves (F_v, the sphere measure under es).

`x64=False` is the single-precision route, the counterpart of the JAX
package's COMPOSE_TPU_X64=0, for every method, prefine and pg: the state,
the mesh and IR tables, the geometry and the CDR are all f32. The checks,
the observer, the diagnostics and the error norms are measured in f64 in
both routes, so that they do not measure their own rounding.

The diagnostics and outputs of the JAX driver come with the same keywords:
the Lauritzen diagnostics at day 6, the observer's JSON series, the
midpoint check against one giant pislu step, the ISL footprint and
per-phase timer lines, NetCDF output of the CGLL fields and the internal
lat-lon raster. `main` is the command line (python -m
compose_tpu_torch.driver), with the JAX driver's flags plus `-device`.

`perturb_rho` adds a mass-free random perturbation to the density after
each step. Its random numbers come from a torch.Generator seeded with the
step index (the JAX package draws them from jax.random.PRNGKey(step)), so
such a run meets the reference's tracer-consistency bars but is not
pointwise equal to the JAX run.
"""

import dataclasses
import os
import time

import numpy as np
import torch

from . import constants, io, vis
from .config import F64, real_dtype, resolve_device
from .diagnostics import LauritzenDiag, Observer
from .mesh import cubed_sphere
from .ops import sphere, sqr
from .ops.reduce import bfb_sum
from .transport import gallery
from .transport.ir import IrConfig, IrTransport
from .transport.isl import IslConfig, IslTransport
from .transport.physgrid import PhysgridOps
from .transport.prefine import PRefineConfig, PRefineTransport


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
              max_step_mass_err=0.0, max_step_bounds_err=0.0, F_gll=None):
    """The reference's final error norms of a tracer (print_error): f0, f
    its initial and final mixing ratios, rho0, rho the densities; the
    "gll" masses in F_gll (default mesh.dgbfi_gll; prefine 1 passes its
    fine Homme measure). Computed in f64 on the host whatever the run's
    dtype."""
    F_gll = mesh.dgbfi_gll if F_gll is None else F_gll
    fs, ds, fe, de, w, wg = (
        x.reshape(-1).to(F64).cpu().numpy()
        for x in (f0, rho0, f, rho, mesh.dgbfi_sphere, F_gll))
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


def _perturb(mesh, rho, amount, step):
    """Mass-free random density perturbation: uniform [-1, 1) numbers
    from a CPU generator seeded with `step` (the same on every device),
    the F-weighted mean projected out, scaled so that rho stays positive."""
    gen = torch.Generator().manual_seed(step)
    u = (2.0 * torch.rand(rho.shape, generator=gen, dtype=F64) - 1.0).to(
        rho.device)
    Fg = mesh.dgbfi_gll
    u = u - Fg * (torch.sum(Fg * u) / torch.sum(Fg * Fg))
    return rho + (amount * torch.amin(rho) / torch.amax(torch.abs(u))) * u


def _toychem_pair(ics):
    """(index of toychem1, index of toychem2) when both are present."""
    low = [n.lower() for n in ics]
    if "toychem1" in low and "toychem2" in low:
        return low.index("toychem1"), low.index("toychem2")
    return None


def _pg_centers(mesh, pg):
    """(lat, lon) of the pg x pg FV subcell centers of every cell, as
    (ncell * pg^2,) in the mesh's dtype (computed in f64)."""
    edges = np.linspace(-1.0, 1.0, pg + 1)
    cmid = 0.5 * (edges[:-1] + edges[1:])
    kw = dict(dtype=F64, device=mesh.device)
    Ac = torch.tensor(np.tile(cmid, pg), **kw)
    Bc = torch.tensor(np.repeat(cmid, pg), **kw)
    pts = sqr.ref_to_sphere(mesh.corners.to(F64)[:, None, :, :], Ac[None, :],
                            Bc[None, :])
    return tuple(x.to(mesh.dtype) for x in sphere.xyz2ll(pts.reshape(-1, 3)))


def _toychem_on_pg(pg_ops, pg_lat, pg_lon, rho, q, pair, dt):
    """The toy chemistry on the physics grid: the tendencies at the FV
    subcell centers, their tracer masses remapped to the GLL nodes through
    fv2gll's operator, each tracer then clipped per cell to the union of
    its post-tendency FV range and its current GLL range (a zero tendency
    leaves it as it was, and the unlimited remap adds no extremum)."""
    mesh, pg = pg_ops.mesh, pg_ops.nphys
    rho_p, q_p = pg_ops.gll2fv(rho, q)
    tends = gallery.toychem_tendency(pg_lat, pg_lon, q_p[pair[0]].reshape(-1),
                                     q_p[pair[1]].reshape(-1), dt)
    rho_safe = torch.where(rho == 0, 1.0, rho)
    q = q.clone()
    for i_t, tend in zip(pair, tends):
        dq_p = (dt * tend).reshape(mesh.ncell, pg * pg)
        Qd = torch.einsum('dp,cp->cd', pg_ops.op_j,
                          pg_ops.fv_met * rho_p * dq_p) / pg_ops.gll_met
        qi = q[i_t] + Qd / rho_safe
        qp_new = q_p[i_t] + dq_p
        lo = torch.minimum(torch.amin(qp_new, -1), torch.amin(q[i_t], -1))
        hi = torch.maximum(torch.amax(qp_new, -1), torch.amax(q[i_t], -1))
        q[i_t] = torch.minimum(torch.maximum(qi, lo[:, None]), hi[:, None])
    return q


def _midpoint_check(mesh, wind, ne, np_, nsub, nsteps, T, rho0, q0, q,
                    verbose):
    """The reference's midpoint check: q at T/2 against one giant pislu
    step (plain GLL interpolant, no filter or limiter) from the initial
    state, l2 per tracer in the sphere measure, in f64 on the host."""
    ref = IslTransport(mesh, wind, IslConfig(
        ne=ne, np_=np_, basis="Gll", filter="none", limiter="none",
        rho_isl=True, nsub=max(32, nsub * (nsteps // 2))))
    _, q_ref = ref.step(rho0, q0, 0.0, T / 2)
    w = mesh.dgbfi_sphere.reshape(-1).to(F64).cpu().numpy()
    for i in range(q.shape[0]):
        f = q_ref[i].reshape(-1).to(F64).cpu().numpy()
        e = q[i].reshape(-1).to(F64).cpu().numpy() - f
        l2 = np.sqrt((w * e * e).sum() / (w * f * f).sum())
        if verbose:
            print(f"> mp tracer {i} re l2 {l2:9.3e}")


class _Output:
    """Per-step field output: the NetCDF writer (io_type netcdf) of
    density and tracers, or the internal lat-lon raster (io_type
    internal), whose frames go to one file at the end."""

    def __init__(self, io_type, mesh, ics, out_prefix, vis_res):
        self.mesh, self.ics, self.prefix = mesh, ics, out_prefix
        self.writer = self.frames = None
        if io_type == "netcdf":
            self.writer = io.NetcdfWriter(mesh, out_prefix + ".nc")
            self.writer.add_nodal_field("density")
            for i, n in enumerate(ics):
                self.writer.add_nodal_field(f"tracer_{n}{i}")
            self.writer.end_definition()
        elif io_type == "internal":
            self.lat, self.lon = vis.latlon_grid(vis_res, 2 * vis_res)
            self.frames = []
        else:
            raise ValueError(f"io_type '{io_type}': expected netcdf | "
                             "internal")

    def write(self, t, rho, q):
        m = self.mesh
        if self.writer is not None:
            self.writer.advance_time_to(t)
            self.writer.write_field("density", rho, m.dgbfi_sphere)
            for i, n in enumerate(self.ics):
                self.writer.write_field(f"tracer_{n}{i}", q[i],
                                        m.dgbfi_sphere)
        else:
            self.frames += [vis.sample_field(m, f, self.lat, self.lon)
                            for f in [rho] + list(q)]

    def close(self):
        if self.writer is not None:
            self.writer.close()
        else:
            vis.write_raster(self.prefix + ".bin", self.frames)


def run(ne=10, np_=4, nsteps=12, T_days=12.0, ics=("gaussianhills",),
        ode="divergent", method="pisl", filter_="qlt", limiter="mn2",
        basis="GllNodal", nsub=8, dmc="none", lauritzen=False,
        observer_out=None, check_midpoint=False, geom_dtype="f64",
        fitext=False, rotate_grid=False, timeint="exact", perturb_rho=0.0,
        footprint=False, io_type=None, out_prefix="slmmir_out",
        write_every=1, vis_res=64, prefine=0, nonuni=False, pg=0,
        mesh_type="geometric", interp_dtype="f64", verbose=True,
        timers=False, tq=None, d2c=True, *, x64=True, device="cuda"):
    """One slmmir-style run on `device` (the current CUDA device unless
    the CPU is asked for), in f64 or, with x64=False, in f32; returns
    RunOutput. The keywords are the JAX driver's: `tq` and `d2c` the
    cell-integrated methods' T-fill quadrature order and continuity
    option; `prefine` 1 or 5 runs that p-refinement experiment (np_ is
    then the fine grid's); `pg` > 0 evaluates the toy chemistry (ics
    holding toychem1 and toychem2) on the pg x pg physics grid;
    `lauritzen` prints the Lauritzen diagnostics of day 6;
    `observer_out` dumps the observer's series there as JSON;
    `check_midpoint` prints the midpoint check (an even nsteps);
    `footprint` and `timers` print the ISL footprint per step and the
    per-phase times; `io_type` netcdf | internal writes the fields every
    `write_every` steps to out_prefix.nc or out_prefix.bin (a vis_res x
    2 vis_res raster)."""
    if method not in ("pisl", "pislu", "ir", "cdg", "isl"):
        raise ValueError(f"unknown method '{method}'")
    # Positive-only filter spellings: only qlt-pve is positive-only;
    # caas-pve is the caas redistribution with the standard bounds.
    positive_only = filter_ == "qlt-pve"
    if filter_.endswith("-pve"):
        filter_ = filter_[:-len("-pve")]
        if method not in ("pisl", "pislu", "isl"):
            raise ValueError("-mono *-pve is an ISL-family filter")
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
    # Subcell meshes refine the grid and force np 2.
    ne, np_, basis = mesh.ne, mesh.np_, mesh.basis_name
    if mesh.is_subcell and dmc in ("f", "ef") and method == "ir":
        # IR's density factor mixes the per-target ref-square measures of
        # neighbouring subcells of different sizes: the reference switches
        # to CDG (slmmir.cpp:1837-1843).
        if verbose:
            print("WARNING: Switching to CDG; (QOF, IR) is not supported "
                  "for subcell mesh.")
        method = "cdg"
    wind = gallery.create_wind(ode)
    rho_remapper = None
    pref = prefine in (1, 5)
    F_gll = None
    if pref:
        # The np4 v grid carries the density; exp 5's primary (IC and
        # diagnostic) grid is the v grid, exp 1's the fine grid, whose
        # Homme measure is the fine basis's weights on the interpolated v
        # Jacobians.
        model = PRefineTransport(mesh, wind, PRefineConfig(
            ne=ne, np_=np_, basis=basis, filter=filter_, limiter=limiter,
            experiment=prefine, nsub=nsub, rotate=rotate, dmc=dmc))
        if prefine == 5:
            mesh = model.mesh_v
            F_check = model.F_v
        else:
            F_check = F_gll = model.F_f
    elif method in ("ir", "cdg"):
        model = IrTransport(mesh, wind, IrConfig(
            ne=ne, np_=np_, method=method, dmc=dmc, filter=filter_,
            limiter=limiter, nsub=nsub, tq=tq, d2c=d2c))
        F_check = model.F_mass
    else:
        if method == "isl":
            # The density by the cell-integrated remap, with a local mass
            # equality in the GLL measure unless a dmc is given.
            rho_remapper = IrTransport(mesh, wind, IrConfig(
                ne=ne, np_=np_, method="ir",
                dmc="eh" if dmc == "none" else dmc, filter="none",
                limiter="none", nsub=nsub, tq=tq))
        cfg = IslConfig(ne=ne, np_=np_, basis="Gll" if method == "pislu"
                        else basis, filter=filter_, limiter=limiter,
                        rho_isl=method != "isl", nsub=nsub,
                        dmc="f" if dmc == "none" else dmc,
                        positive_only=positive_only, fitext=fitext,
                        timeint=timeint, geom_dtype=geom_dtype,
                        interp_dtype=interp_dtype, rotate=rotate)
        model = IslTransport(mesh, wind, cfg)
        F_check = mesh.dgbfi_sphere if dmc == "es" else mesh.dgbfi_gll
    if F_gll is None:
        F_gll = mesh.dgbfi_gll

    rho = torch.ones((mesh.ncell, mesh.np2), dtype=dtype, device=dev)
    q = init_tracers(mesh, ics)
    q0, rho0 = q, rho
    T = constants.day2sec(T_days)
    dt = T / nsteps
    pair = _toychem_pair(ics)
    pg_ops = None
    if pair is not None and pg > 0:
        # The reference's physics-grid coupling uses the elrecon fv2gll.
        pg_ops = PhysgridOps(mesh, pg, "elrecon")
        pg_lat, pg_lon = _pg_centers(mesh, pg)
    elif pair is not None:
        tc_lat, tc_lon = sphere.xyz2ll(mesh.cell_nodes_xyz.reshape(-1, 3))
    # The per-step mass check's measure: the one the model conserves.
    F_check = F_check.reshape(-1).to(F64)

    def tracer0_stats(q, rho):
        # One host read per step: mass (bfb tree, in f64), min, max of
        # tracer 0.
        Q = (q[0].to(F64) * rho.to(F64)).reshape(-1)
        return torch.stack([bfb_sum(F_check * Q), torch.amin(q[0]).to(F64),
                            torch.amax(q[0]).to(F64)]).tolist()

    obs = None
    if observer_out:
        obs = Observer(F_gll, mesh.dgbfi_sphere,
                       ["rho"] + [f"{n}{i}" for i, n in enumerate(ics)])
        obs.add_obs(0.0, rho, list(q))
    ldiag = (LauritzenDiag(nsteps, ics, q, mesh.dgbfi_sphere) if lauritzen
             else None)
    output = (_Output(io_type, mesh, ics, out_prefix, vis_res) if io_type
              else None)
    if output is not None:
        output.write(0.0, rho, q)

    mass_prev, q_min0, q_max0 = tracer0_stats(q, rho)
    max_step_mass_err = 0.0
    max_step_bounds_err = 0.0
    pref_state = None
    t_start = time.time()
    for step in range(nsteps):
        ts = dt * step
        tf = T if step == nsteps - 1 else ts + dt
        if footprint and isinstance(model, IslTransport):
            fp = model.footprint_stats(ts, tf)
            print(f"footprint> {fp[0]:2d} {fp[1]:2d} {fp[2]:4.1f} {fp[3]:2d}")
        if pg_ops is not None:
            q = _toychem_on_pg(pg_ops, pg_lat, pg_lon, rho, q, pair, dt)
        elif pair is not None:
            # The toy chemistry's tendencies at the GLL nodes, both from
            # the mixing ratios before either is updated.
            tends = gallery.toychem_tendency(
                tc_lat, tc_lon, q[pair[0]].reshape(-1),
                q[pair[1]].reshape(-1), dt)
            q = q.clone()
            for i_t, tend in zip(pair, tends):
                q[i_t] = q[i_t] + (dt * tend).reshape(q[i_t].shape)
        if pref:
            rho, q, pref_state = model.step(rho, q, ts, tf, pref_state)
        elif rho_remapper is not None:
            rho, q = model.step(rho, q, ts, tf,
                                rho_tgt=rho_remapper.remap_rho(rho, ts, tf))
        else:
            rho, q = model.step(rho, q, ts, tf)
        if perturb_rho:
            rho = _perturb(mesh, rho, perturb_rho, step)
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
        if obs is not None:
            obs.add_obs(tf, rho, list(q))
        if ldiag is not None:
            ldiag.run(step, q)
        if output is not None and (step + 1) % max(1, write_every) == 0:
            output.write(tf, rho, q)
        if check_midpoint and nsteps % 2 == 0 and step + 1 == nsteps // 2:
            _midpoint_check(mesh, wind, ne, np_, nsub, nsteps, T, rho0, q0,
                            q, verbose)
    et = (time.time() - t_start) / nsteps
    if timers and isinstance(model, IslTransport):
        pt = model.phase_times(rho, q, 0.0, dt)
        tot = pt.get("full step", 1.0)
        for name, sec in pt.items():
            print(f"T {name:<24s} {sec:9.3e} s/step "
                  f"{100 * sec / tot:5.1f}%")
    if output is not None:
        output.close()
    if obs is not None:
        obs.dump(observer_out)
    if ldiag is not None and verbose:
        ldiag.print_()
    out = summarize(mesh, q0[0], rho0, q[0], rho, et, max_step_mass_err,
                    max_step_bounds_err, F_gll=F_gll)
    if verbose:
        print(out.one_liner(method=method, ode=ode, ic=ics[0], np=np_, ne=ne,
                            nsteps=nsteps, mono=filter_, lim=limiter))
    return out


def main(argv=None):
    """The command line: the JAX driver's flags, with its names and
    defaults, plus -device (default cuda; -device cpu runs on the CPU).
    The precision comes from COMPOSE_TPU_X64 as in the JAX package: 0 is
    the single-precision route. Prints the <OL> line; returns RunOutput."""
    import argparse
    p = argparse.ArgumentParser(description="compose_tpu_torch transport "
                                "driver")
    p.add_argument("-method", default="pisl",
                   choices=["pisl", "isl", "pislu", "ir", "cdg"])
    p.add_argument("-dmc", default="none",
                   choices=["none", "es", "eh", "f", "ef", "geh"])
    p.add_argument("-ode", default="divergent")
    p.add_argument("-ic", action="append", default=None)
    p.add_argument("-ne", type=int, default=10)
    p.add_argument("-np", dest="np_", type=int, default=4)
    p.add_argument("-nsteps", type=int, default=12)
    p.add_argument("-T", type=float, default=12.0)
    p.add_argument("-mono", dest="filter_", default="qlt",
                   choices=["qlt", "qlt-pve", "caas", "caas-pve", "mn2",
                            "caas-node", "none"])
    p.add_argument("-lim", dest="limiter", default="mn2",
                   choices=["mn2", "caas", "caags", "qlt", "none"])
    p.add_argument("-basis", default="GllNodal")
    p.add_argument("-tq", type=int, default=None,
                   help="triangle-quadrature order of the IR/CDG T fill "
                        "(4 = reduced quadrature)")
    p.add_argument("-d2c", dest="d2c", action="store_true", default=None,
                   help="make CI fields continuous each step (the default; "
                        "-no-d2c turns it off)")
    p.add_argument("-no-d2c", dest="d2c", action="store_false")
    p.add_argument("-nsub", type=int, default=8)
    p.add_argument("-interp", dest="interp_dtype", default="f64",
                   choices=["f64", "f32"],
                   help="tracer interpolation precision (mass and bounds "
                        "are restored in the working precision)")
    p.add_argument("-geom", dest="geom_dtype", default="f64",
                   choices=["f64", "f32"],
                   help="precision of the geometric pipeline (mass and "
                        "bounds are restored in the working precision)")
    p.add_argument("-lauritzen", action="store_true")
    p.add_argument("-fitext", action="store_true")
    p.add_argument("-rotate-grid", dest="rotate_grid", action="store_true")
    p.add_argument("-timeint", default="exact",
                   choices=["exact", "interp", "line", "interpline"])
    p.add_argument("--perturb-rho", dest="perturb_rho", type=float,
                   default=0.0)
    p.add_argument("-midpoint-check", dest="check_midpoint",
                   action="store_true")
    p.add_argument("-rit", dest="observer_out", default=None,
                   help="record metrics in time to this JSON file")
    p.add_argument("-footprint", action="store_true",
                   help="print the ISL communication footprint per step")
    p.add_argument("-timers", action="store_true",
                   help="print the per-phase step-time breakdown")
    p.add_argument("-io-type", dest="io_type", default=None,
                   choices=["netcdf", "internal"])
    p.add_argument("-o", dest="out_prefix", default="slmmir_out")
    p.add_argument("-we", dest="write_every", type=int, default=1)
    p.add_argument("-res", dest="vis_res", type=int, default=64,
                   help="lat resolution of the internal raster output")
    p.add_argument("-prefine", type=int, default=0, choices=[0, 1, 5],
                   help="p-refinement experiment (np=4 v-grid + p-refined "
                        "tracer grid); 0 = none")
    p.add_argument("-nonuni", "-nonunimesh", dest="nonuni", type=int,
                   default=0, help="nonuniform warped mesh (0 = uniform)")
    p.add_argument("-pg", type=int, default=0,
                   help="physgrid nphys (FV physics grid); 0 = none")
    p.add_argument("-mesh", dest="mesh_type", default="geometric",
                   choices=["geometric", "gllsubcell", "runisubcell",
                            "g", "gllsc", "runisc"],
                   help="mesh type (subcell types force np=2 transport on "
                        "the refined grid)")
    p.add_argument("-device", default="cuda",
                   help="torch device: cuda (the default), cuda:N or cpu")
    a = p.parse_args(argv)
    ics = tuple(a.ic) if a.ic else ("gaussianhills",)
    mt = {"g": "geometric", "gllsc": "gllsubcell",
          "runisc": "runisubcell"}.get(a.mesh_type, a.mesh_type)
    return run(ne=a.ne, np_=a.np_, nsteps=a.nsteps, T_days=a.T, ics=ics,
               ode=a.ode, method=a.method, filter_=a.filter_,
               limiter=a.limiter, basis=a.basis, nsub=a.nsub, dmc=a.dmc,
               lauritzen=a.lauritzen, observer_out=a.observer_out,
               check_midpoint=a.check_midpoint, geom_dtype=a.geom_dtype,
               fitext=a.fitext, rotate_grid=a.rotate_grid,
               timeint=a.timeint, perturb_rho=a.perturb_rho,
               footprint=a.footprint, io_type=a.io_type,
               out_prefix=a.out_prefix, write_every=a.write_every,
               vis_res=a.vis_res, prefine=a.prefine,
               nonuni=bool(a.nonuni), pg=a.pg, mesh_type=mt,
               interp_dtype=a.interp_dtype, timers=a.timers, tq=a.tq,
               d2c=True if a.d2c is None else a.d2c,
               x64=os.environ.get("COMPOSE_TPU_X64", "1") != "0",
               device=a.device)


if __name__ == "__main__":
    main()
