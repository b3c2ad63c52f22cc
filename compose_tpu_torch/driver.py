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
package's COMPOSE_TPU_X64=0: the state, the mesh tables, the geometry and
the CDR are all f32 (ISL methods only, without prefine or pg). The checks
and error norms are measured in f64 in both routes, so that they do not
measure their own rounding.

`perturb_rho` adds a mass-free random perturbation to the density after
each step. Its random numbers come from a torch.Generator seeded with the
step index (the JAX package draws them from jax.random.PRNGKey(step)), so
such a run meets the reference's tracer-consistency bars but is not
pointwise equal to the JAX run.
"""

import dataclasses
import time

import numpy as np
import torch

from . import constants
from .config import F64, real_dtype, resolve_device
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
    (ncell * pg^2,) f64."""
    edges = np.linspace(-1.0, 1.0, pg + 1)
    cmid = 0.5 * (edges[:-1] + edges[1:])
    kw = dict(dtype=F64, device=mesh.device)
    Ac = torch.tensor(np.tile(cmid, pg), **kw)
    Bc = torch.tensor(np.repeat(cmid, pg), **kw)
    pts = sqr.ref_to_sphere(mesh.corners.to(F64)[:, None, :, :], Ac[None, :],
                            Bc[None, :])
    return sphere.xyz2ll(pts.reshape(-1, 3))


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


def run(ne=10, np_=4, nsteps=12, T_days=12.0, ics=("gaussianhills",),
        ode="divergent", method="pisl", filter_="qlt", limiter="mn2",
        basis="GllNodal", nsub=8, dmc="none", geom_dtype="f64",
        interp_dtype="f64", verbose=True, fitext=False, rotate_grid=False,
        timeint="exact", nonuni=False, prefine=0, mesh_type="geometric",
        tq=None, d2c=True, perturb_rho=0.0, pg=0, *, x64=True,
        device="cuda"):
    """One slmmir-style run on `device` (the current CUDA device unless
    the CPU is asked for), in f64 or, with x64=False (ISL methods), in f32;
    returns RunOutput. `tq` and `d2c` are the cell-integrated methods'
    T-fill quadrature order and continuity option; `prefine` 1 or 5 runs
    that p-refinement experiment (np_ is then the fine grid's); `pg` > 0
    evaluates the toy chemistry (ics holding toychem1 and toychem2) on the
    pg x pg physics grid."""
    if method not in ("pisl", "pislu", "ir", "cdg", "isl"):
        raise ValueError(f"unknown method '{method}'")
    if not x64 and (method in ("ir", "cdg", "isl") or prefine in (1, 5)
                    or pg):
        raise NotImplementedError(
            f"x64=False with method '{method}', prefine {prefine}, pg {pg} "
            "is not ported")
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
    F_gll_out = None
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
            F_check = F_gll_out = model.F_f
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

    mass_prev, q_min0, q_max0 = tracer0_stats(q, rho)
    max_step_mass_err = 0.0
    max_step_bounds_err = 0.0
    pref_state = None
    t_start = time.time()
    for step in range(nsteps):
        ts = dt * step
        tf = T if step == nsteps - 1 else ts + dt
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
    et = (time.time() - t_start) / nsteps
    out = summarize(mesh, q0[0], rho0, q[0], rho, et, max_step_mass_err,
                    max_step_bounds_err, F_gll=F_gll_out)
    if verbose:
        print(out.one_liner(method=method, ode=ode, ic=ics[0], np=np_, ne=ne,
                            nsteps=nsteps, mono=filter_, lim=limiter))
    return out
