"""P-refinement experiments (compose_tpu.transport.prefine): a coarse np 4
velocity and density grid (v) under a p-refined tracer grid (t, the fine
grid), both on the same ne and rotation (slmmir -prefine, the experiment
branches of slmmir_remapper_isl.cpp:1526-1647).

  exp 1 - the fine grid is primary (ICs, diagnostics): the density is
          integrated on the v grid and interpolated to the fine grid each
          step; the tracers advect on the fine grid with departure points
          interpolated from the v-grid trajectories.
  exp 5 - the v grid is primary; the fine (rho, q) are internal state: q
          goes v -> t once at the start, advects and is limited on t, and
          goes t -> v every step (element-local interpolation and the
          cell-local mass-restoring limiter).

The mechanics, as in the JAX package:
  - the v grid's basis is GllOffsetNodal (stable for rho), but v -> t
    interpolation uses the plain GLL basis;
  - the fine grid's node Jacobians are the interpolated v-grid Jacobians,
    and its Homme mass weights the fine basis's weights on them (F_f), so
    a constant rho on v is a constant rho on t;
  - rho goes v -> t as (rho J_v) interpolated, divided by J_f.

One exp-5 step with caas/caas launches K1 on the v-grid rho records
(1, ncell) and on the fine tracers (nt, ncell), K3 on the v-grid rho DSS,
and K2 in the fine-grid limiter (nt, ncell x np_f^2) and in the t -> v
transfer (nt, ncell x 16); the first step also runs the v -> t transfer,
one more K2 launch at the fine np^2. Tracers are a dense leading axis;
every table lives on the fine mesh's device, in its dtype: f64, or f32 on
the single-precision route, where the transfer operators and weights are
set up in f64 and rounded once, and K1, K2 and the v-grid DSS (K4) run in
f32.
"""

import dataclasses

import torch

from .. import basis as basis_mod
from ..config import F64
from ..mesh import cubed_sphere
from ..ops import local_qp, sphere, sqr
from ..ops.reduce import bfb_sum
from . import dss, limiter as limiter_mod, spf, timeint


@dataclasses.dataclass(frozen=True)
class PRefineConfig:
    ne: int
    np_: int                       # the fine grid's np
    basis: str = "GllNodal"
    filter: str = "caas"
    limiter: str = "caas"
    experiment: int = 5            # 1 | 5
    nsub: int = 8
    v_np: int = 4
    rotate: tuple = None           # the grids' common (axis, angle)
    # es: the sphere measure on both grids; anything else the Homme (GLL)
    # family.
    dmc: str = "f"


def _kron_eval(bas_from, x_nodes):
    """(np_to^2, np_from^2): the tensor interpolation matrix evaluating
    `bas_from` at the tensor grid of the 1-D coordinates x_nodes."""
    V = bas_from.eval(torch.as_tensor(x_nodes, dtype=F64).cpu())
    return torch.kron(V, V)


def _interp_chain(src, w):
    """sum_k src[..., k] * w[..., k] as an explicit left-to-right chain,
    one (..., cnn) gather per node instead of the (..., cnn, np2) one."""
    acc = src(0) * w[..., 0]
    for k in range(1, w.shape[-1]):
        acc = acc + src(k) * w[..., k]
    return acc


class PRefineTransport:
    def __init__(self, mesh_f: cubed_sphere.CubedSphereMesh, wind,
                 config: PRefineConfig):
        if config.experiment not in (1, 5):
            raise ValueError(f"prefine experiment {config.experiment}: "
                             "expected 1 | 5")
        if mesh_f.np_ != config.np_:
            raise ValueError("the fine mesh must be the config's np")
        self.config = config
        self.wind = wind
        self.mesh_f = mesh_f
        dev, real = mesh_f.device, mesh_f.dtype
        self.mesh_v = cubed_sphere.build(config.ne, config.v_np,
                                         "GllOffsetNodal",
                                         rotate=config.rotate, device=dev,
                                         dtype=real)
        mv, mf = self.mesh_v, mesh_f
        self.basis_v = basis_mod.create("GllOffsetNodal", config.v_np)
        self.basis_f = basis_mod.create(config.basis, config.np_)
        gll_v = basis_mod.GLL(config.v_np)

        # Coarse -> fine by the plain GLL basis, fine -> coarse by the fine
        # basis.
        self.C2F = _kron_eval(gll_v, self.basis_f.x).to(dev, real)
        self.F2C = _kron_eval(self.basis_f, gll_v.x).to(dev, real)

        self.Jt_v = mv.jac_node
        self.Jt_f = torch.einsum('fk,ck->cf', self.C2F, self.Jt_v)
        wf = self.basis_f.w
        w2f = (wf.repeat_interleave(config.np_) * wf.repeat(config.np_)).to(
            dev, real)
        if config.dmc == "es":
            self.F_f = mf.dgbfi_sphere
            self.F_v = mv.dgbfi_sphere
        else:
            self.F_f = w2f[None, :] * self.Jt_f
            self.F_v = mv.dgbfi_gll

        # Each fine CGLL node's owner cell and the GLL(v_np) weights at its
        # reference coordinates: departure points interpolated from v.
        rep = mf.cgll_rep.cpu()
        k = rep % mf.np2
        gx = self.basis_f.x
        va = gll_v.eval(gx[k % mf.np_])
        vb = gll_v.eval(gx[k // mf.np_])
        self.vw_f = (vb[:, :, None] * va[:, None, :]).reshape(
            mf.cnn, config.v_np ** 2).to(dev, real)
        self.own_cell_f = (rep // mf.np2).to(dev)

        # The isoparametric Jacobian's derivative matrix on the v grid.
        self.D_v = gll_v.eval_deriv(gll_v.x).to(dev, real)
        self.d2c_v = mv.dgll2cgll.reshape(-1)
        self.d2c_f = mf.dgll2cgll.reshape(-1)
        self.Ff_v = self.F_v.reshape(-1).contiguous()
        self.slots_v = dss.slot_table(mv.c2d_idx, mv.c2d_mask, self.d2c_v)

        if config.filter in ("none", "caas-node"):
            # caas-node is global-only: no MassRedistributor.
            self.mrd_v = self.mrd_f = None
        else:
            self.mrd_v = spf.MassRedistributor(mv.ncell, config.filter)
            self.mrd_f = spf.MassRedistributor(mf.ncell, config.filter)
        self.run_cdr = config.filter != "none"

    # -- shared pieces ---------------------------------------------------
    def _departure(self, ts, tf):
        """Departure data on both grids from one v-grid integration."""
        mv, mf = self.mesh_v, self.mesh_f
        vdep = timeint.integrate(self.wind.velocity, tf, ts, mv.cgll_xyz,
                                 self.config.nsub)
        ci_v, a0, b0 = cubed_sphere.get_cell_coords(mv.ne, vdep, mv.rot_R)
        av, bv = sqr.sphere_to_ref(mv.corners[ci_v], vdep, max_its=4,
                                   a0=a0, b0=b0)
        ea = self.basis_v.eval(av)
        eb = self.basis_v.eval(bv)
        w_v = (eb[:, :, None] * ea[:, None, :]).reshape(mv.cnn, mv.np2)

        vdep_cells = vdep[mv.dgll2cgll]                # (ncell, npv2, 3)
        dep_f = sphere.normalize(timeint.interp_departure(
            self.vw_f, vdep_cells[self.own_cell_f]))
        ci_f, a0, b0 = cubed_sphere.get_cell_coords(mf.ne, dep_f, mf.rot_R)
        af, bf = sqr.sphere_to_ref(mf.corners[ci_f], dep_f, max_its=4,
                                   a0=a0, b0=b0)
        fa = self.basis_f.eval(af)
        fb = self.basis_f.eval(bf)
        w_f = (fb[:, :, None] * fa[:, None, :]).reshape(mf.cnn, mf.np2)
        return (vdep, ci_v, w_v), (ci_f, w_f)

    def _transport_rho_v(self, rho_v, vdep, ci_v, w_v):
        """ISL density transport, CDR and DSS on the v grid (the dycore's
        leg): K1 on the (1, ncell) records for caas, K3 on the DSS."""
        mv = self.mesh_v
        rho_i = torch.sum(rho_v[ci_v, :] * w_v, dim=-1)
        pc = vdep[mv.dgll2cgll].reshape(mv.ncell, mv.np_, mv.np_, 3)
        D = self.D_v
        fa = torch.einsum('ti,cjid->cjtd', D, pc)
        fb = torch.einsum('tj,cjid->ctid', D, pc)
        f = pc
        r2 = sphere.norm2(f)[..., None]
        r = torch.sqrt(r2)
        ua = (fa - f * (sphere.dot(f, fa)[..., None] / r2)) / r
        ub = (fb - f * (sphere.dot(f, fb)[..., None] / r2)) / r
        Jdep = sphere.norm(sphere.cross(ua, ub)).reshape(mv.ncell, mv.np2)
        rho_tgt = (Jdep / mv.jac_node) * rho_i[self.d2c_v].reshape(
            mv.ncell, mv.np2)

        F, Ff = self.F_v, self.Ff_v
        if self.run_cdr:
            mass_src = bfb_sum(Ff * rho_v.reshape(-1))
            mass_tgt = bfb_sum(Ff * rho_tgt.reshape(-1))
            if self.mrd_v is None:
                # caas-node: a uniform shift restores the global mass.
                rho_tgt = rho_tgt + (mass_src - mass_tgt) / bfb_sum(Ff)
            else:
                rho_mass, R_min, R_mass, R_max = spf.record(
                    F, rho_tgt, rho_tgt, torch.zeros_like(rho_tgt),
                    torch.full_like(rho_tgt, 2.0))
                redist = self.mrd_v.redistribute(
                    rho_mass, R_min, R_mass, R_max, mass_src - mass_tgt)
                rho_tgt = limiter_mod.limit_density(F, rho_tgt,
                                                    redist - R_mass)
        out = dss.dss_gather_t(rho_tgt.reshape(1, -1), self.d2c_v,
                               mv.c2d_idx, mv.c2d_mask, Ff, self.slots_v)
        return out.reshape(mv.ncell, mv.np2)

    def _interp_rho(self, rho_v):
        """v -> fine density in the Homme-mass form: (rho J_v)
        interpolated, divided by the interpolated J."""
        return torch.einsum('fk,ck->cf', self.C2F, rho_v * self.Jt_v) \
            / self.Jt_f

    def _transfer_q(self, op, F_from, rho_from, q_from, F_to, rho_to,
                    run_limit):
        """Element-local interpolation of q (nt, ncell, np2_from), then the
        cell-local limiter (K2 for caas, one launch for all tracers) that
        restores each cell's tracer mass within the source cell's range."""
        q_to = torch.einsum('fk,nck->ncf', op, q_from)
        if not run_limit:
            return q_to
        Q_to = q_to * rho_to[None]
        Qm_to = torch.sum(F_to[None] * Q_to, dim=-1)
        Qm_from = torch.sum(F_from[None] * rho_from[None] * q_from, dim=-1)
        q_min = torch.amin(q_from, dim=-1, keepdim=True).expand(Q_to.shape)
        q_max = torch.amax(q_from, dim=-1, keepdim=True).expand(Q_to.shape)
        lim = self.config.limiter if self.config.limiter != "none" else "caas"
        Q_lim = limiter_mod.limit_tracer(F_to, rho_to, Q_to, q_min, q_max,
                                         Qm_from - Qm_to, limiter=lim)
        return Q_lim / torch.where(rho_to == 0, 1.0, rho_to)[None]

    def _advect_cdr_fine(self, rho_f_src, q_f, rho_f_tgt, ci_f, w_f):
        """Tracer advection and CDR on the fine grid: the global filter
        (K1 for caas) and the cell-local limiter at the fine np^2 (K2), or
        caas-node's relaxed prefilter and one CAAS over all DGLL nodes. No
        DSS: the internal fine grid need not be continuous."""
        mf, cfg = self.mesh_f, self.config
        nt = q_f.shape[0]
        q_i = _interp_chain(lambda k: q_f[:, ci_f, k], w_f)
        q_tgt = q_i[:, self.d2c_f].reshape(nt, mf.ncell, mf.np2)
        if not self.run_cdr:
            return q_tgt
        F = self.F_f
        Ff = F.reshape(-1)
        Q_tgt = q_tgt * rho_f_tgt[None]
        Qm_src = bfb_sum(Ff[None] * (q_f * rho_f_src[None]).reshape(nt, -1))
        Qm_tgt = bfb_sum(Ff[None] * Q_tgt.reshape(nt, -1))
        q_min_cell = torch.amin(q_f, dim=-1)
        q_max_cell = torch.amax(q_f, dim=-1)
        node_src_cell = ci_f[self.d2c_f].reshape(mf.ncell, mf.np2)
        q_min_node = q_min_cell[:, node_src_cell]
        q_max_node = q_max_cell[:, node_src_cell]

        if self.mrd_f is None:
            # caas-node: the relaxed-bounds prefilter, then each node's
            # mass clipped to its strict bounds and the global discrepancy
            # spread over the nodal headroom.
            if cfg.limiter != "none":
                rel = 1e-2 * (q_max_node - q_min_node)
                Q_tgt = limiter_mod.limit_tracer(
                    F, rho_f_tgt, Q_tgt, q_min_node - rel, q_max_node + rel,
                    Q_tgt.new_zeros(Q_tgt.shape[:2]),
                    limiter=cfg.limiter, expand_bounds_allowed=True)
            lo = (q_min_node * rho_f_tgt[None]).reshape(nt, -1)
            hi = (q_max_node * rho_f_tgt[None]).reshape(nt, -1)
            Q_tgt = local_qp.caas_gsum(
                Ff[None].expand(lo.shape), Qm_src, lo, hi,
                Q_tgt.reshape(nt, -1), gsum=bfb_sum).reshape(Q_tgt.shape)
        else:
            rhom = F[None] * rho_f_tgt[None]
            Qc_min = torch.sum(rhom * q_min_node, dim=-1)
            Qc_max = torch.sum(rhom * q_max_node, dim=-1)
            Qc_mass = torch.sum(F[None] * Q_tgt, dim=-1)
            redist = self.mrd_f.redistribute(
                torch.sum(F * rho_f_tgt, dim=-1), Qc_min, Qc_mass, Qc_max,
                Qm_src - Qm_tgt)
            if cfg.limiter != "none":
                Q_tgt = limiter_mod.limit_tracer(
                    F, rho_f_tgt, Q_tgt, q_min_node, q_max_node,
                    redist - Qc_mass, limiter=cfg.limiter)
        rho_safe = torch.where(rho_f_tgt == 0, 1.0, rho_f_tgt)
        q_new = torch.where(rho_f_tgt[None] == 0, q_min_node,
                            Q_tgt / rho_safe[None])
        return torch.minimum(torch.maximum(q_new, q_min_node), q_max_node)

    # -- the experiments ---------------------------------------------------
    def _step5(self, rho_v, q_v, rho_f, q_f, ts, tf, first):
        (vdep, ci_v, w_v), (ci_f, w_f) = self._departure(ts, tf)
        rho_v_tgt = self._transport_rho_v(rho_v, vdep, ci_v, w_v)
        if first:
            # The fine state starts from the v grid's (one v -> t transfer,
            # K2 at the fine np^2).
            rho_f = self._interp_rho(rho_v)
            q_f = self._transfer_q(self.C2F, self.F_v, rho_v, q_v, self.F_f,
                                   rho_f, self.run_cdr)
        rho_f_tgt = self._interp_rho(rho_v_tgt)
        q_f_tgt = self._advect_cdr_fine(rho_f, q_f, rho_f_tgt, ci_f, w_f)
        q_v_tgt = self._transfer_q(self.F2C, self.F_f, rho_f_tgt, q_f_tgt,
                                   self.F_v, rho_v_tgt, self.run_cdr)
        return rho_v_tgt, q_v_tgt, rho_f_tgt, q_f_tgt

    def _step1(self, rho_f, q_f, rho_v, ts, tf):
        (vdep, ci_v, w_v), (ci_f, w_f) = self._departure(ts, tf)
        rho_v_tgt = self._transport_rho_v(rho_v, vdep, ci_v, w_v)
        rho_f_src = self._interp_rho(rho_v)
        rho_f_tgt = self._interp_rho(rho_v_tgt)
        q_f_tgt = self._advect_cdr_fine(rho_f_src, q_f, rho_f_tgt, ci_f, w_f)
        return rho_f_tgt, q_f_tgt, rho_v_tgt

    def step(self, rho, q, ts, tf, state=None):
        """Advance one step; returns (rho', q', state'). exp 5: (rho, q) on
        the v grid, `state` the internal fine (rho_f, q_f, first); exp 1:
        (rho, q) on the fine grid, `state` the v-grid density. state=None
        starts a run."""
        if self.config.experiment == 5:
            if state is None:
                state = (None, None, True)
            rho_f, q_f, first = state
            rho_v, q_v, rho_f, q_f = self._step5(rho, q, rho_f, q_f, ts, tf,
                                                 first)
            return rho_v, q_v, (rho_f, q_f, False)
        if state is None:
            mv = self.mesh_v
            state = torch.ones((mv.ncell, mv.np2), dtype=mv.dtype,
                               device=mv.device)
        return self._step1(rho, q, state, ts, tf)
