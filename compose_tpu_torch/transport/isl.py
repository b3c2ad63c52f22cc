"""Interpolation semi-Lagrangian (ISL) transport step
(compose_tpu.transport.isl), method pisl, filters qlt | mn2 | caas and
limiters mn2 | caas.

One step:
  1. departure points: backward DoPri5 trajectories of the CGLL nodes,
     equiangular cell location, warm-started Newton to reference
     coordinates, and the GllNodal np4 weights;
  2. interpolation of rho and the tracers at the departure points, and the
     departure/arrival Jacobian ratio for rho;
  3. rho CDR: global redistribution (K1 for caas), positivity limiter, rho
     DSS (K3, or K4 in f32);
  4. tracer CDR: per-cell records, global redistribution (K1 for caas, the
     QLT tree or the mn2 QP), cell-local limiter (K2 for caas, the mn2 QP);
  5. mixing-ratio DSS (K3, or K4 in f32).
Step 3-5 follow the JAX package's general CDR branch (isl.py:563-711).

The working float type is the mesh's: f64, or f32 on the single-precision
route (the JAX package with x64 off, where every f64 is f32). In f64 the
geometry and interpolation may also run in f32 (geom_dtype = interp_dtype
= "f32"), their invariants then enforced by the f64 CDR. Other
configurations raise NotImplementedError. Tracers are a dense leading
axis; rho is (ncell, np2), q is (nt, ncell, np2), both in the mesh's dtype
on its device.
"""

import dataclasses
import time

import torch

from .. import basis as basis_mod
from ..config import F32
from ..mesh import cubed_sphere
from ..ops import sqr
from ..ops.reduce import bfb_sum_cells
from . import dss, limiter as limiter_mod, spf, timeint


@dataclasses.dataclass(frozen=True)
class IslConfig:
    ne: int
    np_: int = 4
    basis: str = "GllNodal"
    filter: str = "qlt"
    limiter: str = "mn2"
    rho_isl: bool = True
    nsub: int = 8
    dmc: str = "f"
    positive_only: bool = False
    fitext: bool = False
    timeint: str = "exact"
    v_np: int = 4
    geom_dtype: str = "f64"
    rotate: tuple = None
    interp_dtype: str = "f64"

    def check_ported(self):
        """Raise NotImplementedError unless this is a ported pisl
        configuration."""
        ported = dict(np_=(4,), basis=("GllNodal",),
                      filter=("qlt", "mn2", "caas"), limiter=("mn2", "caas"),
                      rho_isl=(True,), dmc=("f",), positive_only=(False,),
                      fitext=(False,), timeint=("exact",), rotate=(None,))
        for k, v in ported.items():
            if getattr(self, k) not in v:
                raise NotImplementedError(
                    f"IslConfig.{k}={getattr(self, k)!r} is not ported "
                    f"(only {' | '.join(map(repr, v))})")
        if (self.geom_dtype, self.interp_dtype) not in (("f64", "f64"),
                                                        ("f32", "f32")):
            raise NotImplementedError(
                f"geom_dtype={self.geom_dtype!r} with interp_dtype="
                f"{self.interp_dtype!r} is not ported")


class IslTransport:
    """Static mesh and basis tables on the mesh's device, and the step."""

    def __init__(self, mesh: cubed_sphere.CubedSphereMesh, wind,
                 config: IslConfig):
        config.check_ported()
        if (mesh.ne, mesh.np_) != (config.ne, config.np_):
            raise ValueError(f"mesh ne{mesh.ne} np{mesh.np_} does not match "
                             f"the config's ne{config.ne} np{config.np_}")
        self.mesh = mesh
        self.config = config
        self.wind = wind
        self.real = mesh.dtype
        dev = mesh.device
        self.basis = basis_mod.create(config.basis, config.np_)
        gll = basis_mod.GLL(config.np_)
        self.deriv_at_nodes = gll.eval_deriv(gll.x).to(dev)  # (node, bf) f64
        self.F = mesh.dgbfi_gll
        self.Ff = self.F.reshape(-1).contiguous()
        self.d2c_map = mesh.dgll2cgll.reshape(-1)
        # The DSS kernel's slot table, built once per mesh beside Ff.
        self.slots = dss.slot_table(mesh.c2d_idx, mesh.c2d_mask,
                                    self.d2c_map)
        self.mrd = spf.MassRedistributor(mesh.ncell, config.filter)

    # ------------------------------------------------------------------
    def step(self, rho, q, ts: float, tf: float):
        """Advance one transport step from ts to tf. Returns (rho', q')."""
        return self._step_impl(rho, q, ts, tf)

    # ------------------------------------------------------------------
    def _departure_data(self, ts, tf):
        m = self.mesh
        f32 = self.config.geom_dtype == "f32"
        nodes = m.cgll_xyz.to(F32) if f32 else m.cgll_xyz
        dep = timeint.integrate(self.wind.velocity, tf, ts, nodes,
                                self.config.nsub)
        ci, a0, b0 = cubed_sphere.locate(m, dep)
        corners = m.corners[ci]
        if f32:
            corners = corners.to(F32)
            tol = 1e1 * float(torch.finfo(F32).eps)
            a, b = sqr.sphere_to_ref(corners, dep, max_its=3, tol=tol,
                                     a0=a0, b0=b0)
        else:
            a, b = sqr.sphere_to_ref(corners, dep, max_its=4, a0=a0, b0=b0)
        va = self.basis.eval(a)
        vb = self.basis.eval(b)
        w = (vb[:, :, None] * va[:, None, :]).reshape(m.cnn, m.np2)
        return dep, ci, w

    @staticmethod
    def _interp(field, ci, w):
        """field (..., ncell, np2) -> (..., cnn) at the departure points."""
        return torch.sum(field[..., ci, :] * w, dim=-1)

    def _jacobian_cells(self, pc):
        """Isoparametric |J| of cells with nodal positions pc (ncell, np,
        np, 3), [j, i] layout, as explicit left-to-right chains."""
        m = self.mesh
        D = self.deriv_at_nodes.to(pc.dtype)
        pcT = torch.movedim(pc, 0, -1)                  # (j, i, d, cells)
        f = pcT
        fa = D[None, :, 0, None, None] * pcT[:, 0, None, :, :]
        fb = D[:, 0, None, None, None] * pcT[0][None, :, :, :]
        for i in range(1, m.np_):
            fa = fa + D[None, :, i, None, None] * pcT[:, i, None, :, :]
            fb = fb + D[:, i, None, None, None] * pcT[i][None, :, :, :]

        def dot_d(a, b):
            return (a[..., 0, :] * b[..., 0, :]
                    + a[..., 1, :] * b[..., 1, :]) \
                + a[..., 2, :] * b[..., 2, :]

        def cross_d(a, b):
            a0, a1, a2 = a[..., 0, :], a[..., 1, :], a[..., 2, :]
            b0, b1, b2 = b[..., 0, :], b[..., 1, :], b[..., 2, :]
            return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                                a0 * b1 - a1 * b0], dim=-2)

        r2 = dot_d(f, f)[..., None, :]
        r = torch.sqrt(r2)
        ua = (fa - f * (dot_d(f, fa)[..., None, :] / r2)) / r
        ub = (fb - f * (dot_d(f, fb)[..., None, :] / r2)) / r
        cr = cross_d(ua, ub)
        jac = torch.sqrt(dot_d(cr, cr))                 # (j, i, cells)
        return torch.movedim(jac, -1, 0).reshape(m.ncell, m.np2)

    def _jacobian_departure(self, dep):
        m = self.mesh
        pc = dep[m.dgll2cgll].reshape(m.ncell, m.np_, m.np_, 3)
        return self._jacobian_cells(pc)

    def _dss(self, field):
        """DSS of a (ncell, np2) field with the static weights F (K3 in
        f64, K4 in f32)."""
        out = dss.dss_gather_t(field.reshape(1, -1), self.d2c_map,
                               self.mesh.c2d_idx, self.mesh.c2d_mask,
                               self.Ff, self.slots)
        return out.reshape(field.shape)

    def _dss_q(self, rho_dg, q):
        """Mixing-ratio DSS of q (nt, ncell, np2) weighted by F rho (K3 in
        f64, K4 in f32)."""
        out = dss.dss_q_gather_t(rho_dg.reshape(-1), q.reshape(q.shape[0], -1),
                                 self.d2c_map, self.mesh.c2d_idx,
                                 self.mesh.c2d_mask, self.Ff, self.slots)
        return out.reshape(q.shape)

    # ------------------------------------------------------------------
    def _interp_phase(self, rho, q, dep, ci, w):
        """Density and tracers at the departure points, on the DGLL slots:
        (rho_tgt, q_tgt) in the working type, and each slot's departure
        cell."""
        m = self.mesh
        nt = q.shape[0]
        if self.config.interp_dtype == "f32":
            # f32 geometry gives f32 weights; rho and the tracers are
            # gathered and contracted in f32, the Jacobian ratio in f32.
            # Mass and bounds are restored in the working type by the CDR.
            w32 = w.to(F32)
            ri = self._interp(rho.to(F32), ci, w32)          # (cnn,)
            qi = self._interp(q.to(F32), ci, w32)            # (nt, cnn)
            ratio32 = self._jacobian_departure(dep).to(F32) \
                / m.jac_node.to(F32)
            rho_tgt = (ratio32 * ri[self.d2c_map].reshape(
                m.ncell, m.np2)).to(self.real)
            q_tgt = qi[:, self.d2c_map].to(self.real).reshape(nt, m.ncell,
                                                              m.np2)
        else:
            rho_interp = self._interp(rho, ci, w)
            ratio = self._jacobian_departure(dep) / m.jac_node
            rho_tgt = ratio * rho_interp[self.d2c_map].reshape(m.ncell,
                                                               m.np2)
            q_tgt = self._interp(q, ci, w)[:, self.d2c_map].reshape(
                nt, m.ncell, m.np2)
        return rho_tgt, q_tgt, ci[self.d2c_map].reshape(m.ncell, m.np2)

    def _rho_cdr(self, rho, rho_tgt):
        """Global redistribution (K1 for caas) on the cell-mean density
        bounds [0, 2], the positivity limiter, then the density DSS (K3 or
        K4)."""
        F = self.F
        mm = bfb_sum_cells(torch.stack([F * rho, F * rho_tgt]))
        rho_mass, R_min, R_mass, R_max = spf.record(
            F, rho_tgt, rho_tgt, torch.zeros_like(rho_tgt),
            torch.full_like(rho_tgt, 2.0))
        redist = self.mrd.redistribute(rho_mass, R_min, R_mass, R_max,
                                       mm[0] - mm[1])
        rho_tgt = limiter_mod.limit_density(F, rho_tgt, redist - R_mass)
        return self._dss(rho_tgt)

    def _tracer_cdr(self, rho, q, rho_tgt, q_tgt, node_src_cell):
        """Per-cell records, global redistribution (K1 for caas), the
        cell-local limiter (K2 for caas). Returns mixing ratios,
        zero-density nodes at their lower bound."""
        F = self.F
        Q_tgt = q_tgt * rho_tgt[None]
        QQ = bfb_sum_cells(torch.stack([F[None] * q * rho[None],
                                        F[None] * Q_tgt]))
        # Source-cell bounds -> per-target-node bounds via each node's
        # departure cell.
        q_min_node = torch.amin(q, dim=-1)[:, node_src_cell]
        q_max_node = torch.amax(q, dim=-1)[:, node_src_cell]
        rhom1 = F * rho_tgt
        Qc_min = torch.sum(rhom1[None] * q_min_node, dim=-1)
        Qc_max = torch.sum(rhom1[None] * q_max_node, dim=-1)
        Qc_mass = torch.sum(F[None] * Q_tgt, dim=-1)
        redist = self.mrd.redistribute(torch.sum(rhom1, dim=-1), Qc_min,
                                       Qc_mass, Qc_max, QQ[0] - QQ[1])
        delta = redist - Qc_mass
        return limiter_mod.limit_tracer(
            F, rho_tgt, Q_tgt, q_min_node, q_max_node, delta,
            limiter=self.config.limiter,
            precomp=(rhom1, Qc_mass + delta, Qc_min, Qc_max), return_q=True)

    def _step_impl(self, rho, q, ts, tf):
        dep, ci, w = self._departure_data(ts, tf)
        rho_tgt, q_tgt, node_src_cell = self._interp_phase(rho, q, dep, ci, w)
        rho_tgt = self._rho_cdr(rho, rho_tgt)
        q_new = self._tracer_cdr(rho, q, rho_tgt, q_tgt, node_src_cell)
        return rho_tgt, self._dss_q(rho_tgt, q_new)

    def phase_times(self, rho, q, ts, tf, iters: int = 10):
        """Per-phase wall times of one step (compose_tpu's phase_times):
        each phase runs alone `iters` times after a warm-up, synchronized
        on CUDA. Returns an ordered {phase: seconds} dict; "other" is the
        full step less the phases."""
        sync = (torch.cuda.synchronize if self.mesh.device.type == "cuda"
                else (lambda: None))

        def tm(fn, *args):
            out = fn(*args)
            sync()
            t0 = time.perf_counter()
            for _ in range(iters):
                out = fn(*args)
            sync()
            return (time.perf_counter() - t0) / iters, out

        t = {}
        t["departure"], (dep, ci, w) = tm(self._departure_data, ts, tf)
        t["interp"], (rho_tgt, q_tgt, nsc) = tm(self._interp_phase, rho, q,
                                                dep, ci, w)
        t["rho cdr + dss"], rho_tgt = tm(self._rho_cdr, rho, rho_tgt)
        t["tracer cdr"], q_new = tm(self._tracer_cdr, rho, q, rho_tgt, q_tgt,
                                    nsc)
        t["tracer dss"], _ = tm(self._dss_q, rho_tgt, q_new)
        full, _ = tm(self.step, rho, q, ts, tf)
        t["other"] = full - sum(t.values())
        t["full step"] = full
        return t
