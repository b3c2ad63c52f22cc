"""Interpolation semi-Lagrangian (ISL) transport step
(compose_tpu.transport.isl): methods pisl and pislu (rho_isl), or density
held (rho_isl=False); every Islet basis and np; filters qlt | mn2 | caas |
caas-node | none, positive-only; limiters mn2 | caas | caags | qlt | none;
dmc f | eh | geh (GLL measure) or es (sphere measure); -fitext; exact,
interp, line and interpline trajectories; rotated and nonuniform meshes.

One step:
  1. departure points: backward DoPri5 (or midpoint 'line') trajectories of
     the CGLL nodes, or of a coarse np=v_np velocity grid interpolated to
     them; cell location (equiangular, or the warp inverse and ring-1 Newton
     selection on a nonuniform mesh), Newton to reference coordinates, and
     the basis weights;
  2. interpolation of rho and the tracers at the departure points, and the
     departure/arrival Jacobian ratio for rho;
  3. rho CDR: global redistribution (K1 for caas), positivity limiter, rho
     DSS (K3, or K4 in f32); caas-node restores the mass by a uniform shift;
  4. tracer CDR: per-cell records, global redistribution (K1 for caas, the
     QLT tree or the mn2 QP), cell-local limiter (K2 for caas, the QPs of
     mn2, caags, qlt); caas-node instead runs a relaxed-bounds prefilter
     (K2 for caas) and one CAAS over all DGLL nodes; positive-only filters
     limit tracer masses to nonnegativity;
  5. mixing-ratio DSS (K3, or K4 in f32), weighted with the model's mass
     measure F. In the mixed `isl` method (rho_isl=False, the density
     remapped by IrTransport.remap_rho and passed as `rho_tgt`) the general
     CDR instead runs the DSS on the density and the tracer masses, both
     weighted with F (K3 twice), forms q = Q / rho and clips it to the
     coincident-node range of the pre-DSS q.
Steps 3-5 follow the JAX package's general CDR branch (isl.py:493-711).

The working float type is the mesh's: f64, or f32 on the single-precision
route (the JAX package with x64 off, where every f64 is f32). In f64 the
geometry and the interpolation may each run in f32, their invariants then
enforced by the f64 CDR, as in the JAX package's branches: geom_dtype
alone sets the departure data's type (f32 weights are widened to the
working type), interp_dtype f32 gathers and contracts rho, the tracers
and the Jacobian ratio in f32 whatever the geometry's type. Tracers are a
dense leading axis; rho is (ncell, np2), q is (nt, ncell, np2), both in
the mesh's dtype on its device.
"""

import dataclasses

import numpy as np
import torch

from .. import _native, basis as basis_mod, trace
from ..config import F32
from ..mesh import cubed_sphere
from ..ops import local_qp, sphere, sqr
from ..ops.reduce import bfb_sum, bfb_sum_cells
from . import dss, limiter as limiter_mod, spf, timeint
from .fit_extremum import FitExtremum
from .locate import CellLocator, basis_weights

_FILTERS = ("qlt", "mn2", "caas", "caas-node", "none")
_LIMITERS = ("mn2", "caas", "caags", "qlt", "none")
_TIMEINTS = ("exact", "interp", "line", "interpline")
_DTYPES = ("f64", "f32")
# The Newton tolerance of the departure points' inverse map in f32
# geometry (else sqr.sphere_to_ref's default, sqr.TOL).
_TOL_F32 = 1e1 * float(torch.finfo(F32).eps)


@dataclasses.dataclass(frozen=True)
class IslConfig:
    ne: int
    np_: int = 4
    basis: str = "GllNodal"
    filter: str = "qlt"          # global CDR: qlt | caas | mn2 | caas-node | none
    limiter: str = "mn2"         # cell-local: mn2 | caas | caags | qlt | none
    rho_isl: bool = True         # pisl: transport rho by ISL too
    nsub: int = 8                # trajectory substeps per transport step
    dmc: str = "f"               # es: sphere measure; f, eh, geh: GLL
    positive_only: bool = False  # -mono qlt-pve: nonnegativity only
    fitext: bool = False         # -fitext: sub-grid bound relaxation
    timeint: str = "exact"       # exact | interp | line | interpline
    v_np: int = 4                # the interp velocity grid's np
    geom_dtype: str = "f64"
    rotate: tuple = None         # (axis, angle) of the mesh's rotation
    interp_dtype: str = "f64"

    def check(self):
        """Raise ValueError for unknown option values."""
        for k, allowed in (("filter", _FILTERS), ("limiter", _LIMITERS),
                           ("timeint", _TIMEINTS), ("geom_dtype", _DTYPES),
                           ("interp_dtype", _DTYPES)):
            if getattr(self, k) not in allowed:
                raise ValueError(f"IslConfig.{k}={getattr(self, k)!r}: "
                                 f"expected {' | '.join(allowed)}")


class IslTransport:
    """Static mesh and basis tables on the mesh's device, and the step."""

    def __init__(self, mesh: cubed_sphere.CubedSphereMesh, wind,
                 config: IslConfig):
        config.check()
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
        # The mass measure: spherical integrals for -dmc es, else the Homme
        # (GLL) weights. The DSS weights with the same F, so that it
        # conserves the measure the CDR conserves.
        self.F = mesh.dgbfi_sphere if config.dmc == "es" else mesh.dgbfi_gll
        self.Ff = self.F.reshape(-1).contiguous()
        self.d2c_map = mesh.dgll2cgll.reshape(-1)
        # The DSS kernel's slot table, built once per mesh beside Ff.
        self.slots = dss.slot_table(mesh.c2d_idx, mesh.c2d_mask,
                                    self.d2c_map)
        self.mrd = (None if config.filter in ("none", "caas-node")
                    else spf.MassRedistributor(mesh.ncell, config.filter))
        self.fitext = FitExtremum(config.np_) if config.fitext else None
        self.vmesh = None
        if config.timeint in ("interp", "interpline") \
                and config.v_np < config.np_:
            self._init_velocity_grid()
        # Cell location's kernel operands: the Newton's iterations and
        # tolerance are _locate_plain's.
        f32 = config.geom_dtype == "f32"
        self.locator = CellLocator(
            mesh, self.basis, F32 if f32 else self.real, 3 if f32 else 4,
            _TOL_F32 if f32 else sqr.TOL, self.real)

    def _init_velocity_grid(self):
        """The coarse np=v_np GLL velocity grid (with the fine mesh's
        rotation), and each fine CGLL node's owner cell and coarse basis
        weights at its GLL reference coordinates."""
        m, cfg = self.mesh, self.config
        self.vmesh = cubed_sphere.build(m.ne, cfg.v_np, "Gll",
                                        rotate=cfg.rotate, device=m.device,
                                        dtype=m.dtype)
        rep = m.cgll_rep.cpu()
        k = rep % m.np2
        gx = torch.tensor(basis_mod.gll_nodes_weights(cfg.np_)[0],
                          dtype=m.dtype)
        vb = basis_mod.GLL(cfg.v_np)
        va = vb.eval(gx[k % cfg.np_])                   # (cnn, v_np)
        vbv = vb.eval(gx[k // cfg.np_])
        self.v_weights = (vbv[:, :, None] * va[:, None, :]).reshape(
            m.cnn, cfg.v_np ** 2).to(m.device)
        self.v_own_cell = (rep // m.np2).to(m.device)

    # ------------------------------------------------------------------
    def step(self, rho, q, ts: float, tf: float, rho_tgt=None):
        """Advance one transport step from ts to tf. Returns (rho', q').
        `rho_tgt`: the target density of the mixed `isl` method (with
        rho_isl=False; without it the density is held)."""
        if rho_tgt is not None and self.config.rho_isl:
            raise ValueError("rho_tgt needs rho_isl=False")
        return self._step_impl(rho, q, ts, tf, rho_tgt)

    # ------------------------------------------------------------------
    def _trajectories(self, nodes, ts, tf, line):
        """Departure points of `nodes`: backward from tf to ts."""
        if line:
            return timeint.integrate_line(self.wind.velocity, tf, ts, nodes)
        return timeint.integrate(self.wind.velocity, tf, ts, nodes,
                                 self.config.nsub)

    def _departure_data(self, ts, tf, nodes=None):
        """(dep, ci, w) of the CGLL nodes, or of the node ids `nodes` only
        (a shard's): each node's arithmetic is the same either way."""
        with trace.span("isl.departure"):
            with trace.span("isl.departure.trajectory"):
                dep = self._departure_points(ts, tf, nodes)
            with trace.span("isl.departure.locate"):
                ci, w = self._locate(dep)
        return dep, ci, w

    def _departure_points(self, ts, tf, nodes):
        """The departure points of `_departure_data`'s nodes."""
        m, cfg = self.mesh, self.config
        f32 = cfg.geom_dtype == "f32"
        if self.vmesh is not None:
            # Integrate the coarse velocity grid, then interpolate the
            # departure points to the fine nodes through their owner cells.
            vm = self.vmesh
            vw, voc = self.v_weights, self.v_own_cell
            if nodes is not None:
                vw, voc = vw[nodes], voc[nodes]
            vnodes = vm.cgll_xyz.to(F32) if f32 else vm.cgll_xyz
            vdep = self._trajectories(vnodes, ts, tf,
                                      cfg.timeint == "interpline")
            dep = timeint.interp_departure(vw.to(vdep.dtype),
                                           vdep[vm.dgll2cgll][voc])
            return sphere.normalize(dep)
        xyz = m.cgll_xyz if nodes is None else m.cgll_xyz[nodes]
        return self._trajectories(xyz.to(F32) if f32 else xyz, ts, tf,
                                  cfg.timeint == "line")

    def _locate(self, dep):
        """Each departure point's cell (cell location, then the Newton
        inverse to reference coordinates) and its basis weights: the kernel
        csrc/locate.cu (`self.locator`) for CUDA points on a uniform mesh
        (CUDA DTensors through `_native.on_local`), else the eager chain
        `_locate_plain`. The program's trace counters `locate.kernel` and
        `locate.eager` count the calls of each."""
        m = self.mesh
        if not dep.is_cuda or m.nonuni or m.is_subcell:
            trace.count("locate.eager")
            return self._locate_plain(dep)
        if _native.has_dtensor(dep):
            return _native.on_local(self._locate, (dep,), n_out=2)
        trace.count("locate.kernel")
        return self.locator(dep.contiguous())

    def _locate_plain(self, dep):
        """`_locate` as the eager chain of PyTorch ops, for any mesh and
        device: the kernel's plain version."""
        m, cfg = self.mesh, self.config
        if m.nonuni:
            # The nonuniform mesh's locate converges the Newton itself.
            ci, a, b = cubed_sphere.locate(m, dep)
        else:
            ci, a0, b0 = cubed_sphere.locate(m, dep)
            corners = m.corners[ci]
            if cfg.geom_dtype == "f32":
                corners = corners.to(F32)
                a, b = sqr.sphere_to_ref(corners, dep, max_its=3,
                                         tol=_TOL_F32, a0=a0, b0=b0)
            else:
                a, b = sqr.sphere_to_ref(corners, dep, max_its=4, a0=a0,
                                         b0=b0)
        w = basis_weights(self.basis, a, b, m.np2)
        # f32 weights widen to the working type; dep stays f32 (the
        # departure Jacobian runs in f32 and its ratio is widened).
        return ci, w.to(self.real)

    def _interp(self, field, ci, w):
        """field (..., ncell, np2) -> (..., cnn) at the departure points.
        np > 4 contracts as an explicit left-to-right chain, as the JAX
        package does."""
        src = field[..., ci, :]
        if self.mesh.np_ <= 4:
            return torch.sum(src * w, dim=-1)
        acc = src[..., 0] * w[..., 0]
        for k in range(1, w.shape[-1]):
            acc = acc + src[..., k] * w[..., k]
        return acc

    def _jacobian_cells(self, pc):
        """Isoparametric |J| of cells with nodal positions pc (ncell, np,
        np, 3), [j, i] layout, as explicit left-to-right chains; any number
        of cells (a shard's block too)."""
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
        return torch.movedim(jac, -1, 0).reshape(pc.shape[0], m.np2)

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
        cell. With rho_isl=False the density is held."""
        m, cfg = self.mesh, self.config
        nt = q.shape[0]
        if cfg.interp_dtype == "f32":
            # f32 geometry gives f32 weights; rho and the tracers are
            # gathered and contracted in f32, the Jacobian ratio in f32.
            # Mass and bounds are restored in the working type by the CDR.
            w32 = w.to(F32)
            qi = self._interp(q.to(F32), ci, w32)            # (nt, cnn)
            q_tgt = qi[:, self.d2c_map].to(self.real).reshape(nt, m.ncell,
                                                              m.np2)
            if cfg.rho_isl:
                ri = self._interp(rho.to(F32), ci, w32)      # (cnn,)
                ratio32 = self._jacobian_departure(dep).to(F32) \
                    / m.jac_node.to(F32)
                rho_tgt = (ratio32 * ri[self.d2c_map].reshape(
                    m.ncell, m.np2)).to(self.real)
            else:
                rho_tgt = rho
        else:
            if cfg.rho_isl:
                rho_interp = self._interp(rho, ci, w)
                ratio = self._jacobian_departure(dep) / m.jac_node
                rho_tgt = ratio * rho_interp[self.d2c_map].reshape(m.ncell,
                                                                   m.np2)
            else:
                rho_tgt = rho
            q_tgt = self._interp(q, ci, w)[:, self.d2c_map].reshape(
                nt, m.ncell, m.np2)
        return rho_tgt, q_tgt, ci[self.d2c_map].reshape(m.ncell, m.np2)

    def _rho_cdr(self, rho, rho_tgt):
        """The density after the transport step, before the tracers' CDR:
        held (rho_isl=False); the DSS alone (filter none); for caas-node a
        uniform shift that restores the mass, then the DSS; else global
        redistribution (K1 for caas) on the cell-mean density bounds
        [0, 2], the positivity limiter, then the DSS (K3 or K4)."""
        cfg = self.config
        if not cfg.rho_isl:
            return rho_tgt
        if cfg.filter == "none":
            return self._dss(rho_tgt)
        F = self.F
        mm = bfb_sum_cells(torch.stack([F * rho, F * rho_tgt]))
        if cfg.filter == "caas-node":
            return self._dss(rho_tgt + (mm[0] - mm[1]) / bfb_sum(self.Ff))
        rho_mass, R_min, R_mass, R_max = spf.record(
            F, rho_tgt, rho_tgt, torch.zeros_like(rho_tgt),
            torch.full_like(rho_tgt, 2.0))
        redist = self.mrd.redistribute(rho_mass, R_min, R_mass, R_max,
                                       mm[0] - mm[1])
        rho_tgt = limiter_mod.limit_density(F, rho_tgt, redist - R_mass)
        return self._dss(rho_tgt)

    def _tracer_cdr(self, rho, q, rho_tgt, q_tgt, node_src_cell):
        """The tracers' CDR; returns mixing ratios before the DSS. Filter
        none: q_tgt. Positive-only: [0, 2] records, redistribution and the
        nonnegativity limiter on the tracer masses. caas-node: the
        relaxed-bounds prefilter (K2 for caas), then one CAAS over all DGLL
        nodes (caas_gsum with bfb_sum). Otherwise per-cell records, global
        redistribution (K1 for caas), the cell-local limiter (K2 for caas);
        zero-density nodes at their lower bound."""
        cfg = self.config
        if cfg.filter == "none":
            return q_tgt
        F = self.F
        nt = q.shape[0]
        Q_tgt = q_tgt * rho_tgt[None]
        QQ = bfb_sum_cells(torch.stack([F[None] * q * rho[None],
                                        F[None] * Q_tgt]))
        rhom1 = F * rho_tgt
        rho_inv = 1.0 / torch.where(rho_tgt == 0, 1.0, rho_tgt)
        if cfg.positive_only:
            Qc_mass = torch.sum(F[None] * Q_tgt, dim=-1)
            Qc_max = (2.0 * torch.sum(rhom1, dim=-1)).expand(
                nt, -1).contiguous()
            redist = self.mrd.redistribute(
                torch.sum(rhom1, dim=-1), torch.zeros_like(Qc_mass),
                Qc_mass, Qc_max, QQ[0] - QQ[1])
            Q_tgt = limiter_mod.limit_density(F, Q_tgt, redist - Qc_mass)
            return torch.where(rho_tgt[None] == 0, 0.0,
                               Q_tgt * rho_inv[None])

        q_min_cell = torch.amin(q, dim=-1)
        q_max_cell = torch.amax(q, dim=-1)
        if self.fitext is not None:
            fmin, fmax, fuse = self.fitext.calc(q)
            q_min_cell = torch.where(fuse, torch.minimum(q_min_cell, fmin),
                                     q_min_cell)
            q_max_cell = torch.where(fuse, torch.maximum(q_max_cell, fmax),
                                     q_max_cell)
        # Source-cell bounds -> per-target-node bounds via each node's
        # departure cell.
        q_min_node = q_min_cell[:, node_src_cell]
        q_max_node = q_max_cell[:, node_src_cell]

        if cfg.filter == "caas-node":
            if cfg.limiter != "none":
                # Prefilter with bounds widened by 1e-2 of the range,
                # expandable, zero mass change per cell.
                rel = 1e-2 * (q_max_node - q_min_node)
                Q_tgt = limiter_mod.limit_tracer(
                    F, rho_tgt, Q_tgt, q_min_node - rel, q_max_node + rel,
                    torch.zeros(Q_tgt.shape[:2], dtype=Q_tgt.dtype,
                                device=Q_tgt.device),
                    limiter=cfg.limiter, expand_bounds_allowed=True)
            lo = (q_min_node * rho_tgt[None]).reshape(nt, -1)
            hi = (q_max_node * rho_tgt[None]).reshape(nt, -1)
            Q_tgt = local_qp.caas_gsum(
                self.Ff[None].expand(lo.shape), QQ[0], lo, hi,
                Q_tgt.reshape(nt, -1), gsum=bfb_sum).reshape(Q_tgt.shape)
        else:
            Qc_min = torch.sum(rhom1[None] * q_min_node, dim=-1)
            Qc_max = torch.sum(rhom1[None] * q_max_node, dim=-1)
            Qc_mass = torch.sum(F[None] * Q_tgt, dim=-1)
            redist = self.mrd.redistribute(torch.sum(rhom1, dim=-1), Qc_min,
                                           Qc_mass, Qc_max, QQ[0] - QQ[1])
            delta = redist - Qc_mass
            if cfg.limiter != "none":
                return limiter_mod.limit_tracer(
                    F, rho_tgt, Q_tgt, q_min_node, q_max_node, delta,
                    limiter=cfg.limiter,
                    precomp=(rhom1, Qc_mass + delta, Qc_min, Qc_max),
                    return_q=True)
        # Q -> q with the zero-density guard and a clip of the roundoff.
        q_new = torch.where(rho_tgt[None] == 0, q_min_node,
                            Q_tgt * rho_inv[None])
        return torch.minimum(torch.maximum(q_new, q_min_node), q_max_node)

    def _mixed_dss(self, rho_tgt, q_new):
        """The mixed method's DSS: density and tracer masses with the
        weights F (K3/K4 each), q = Q / rho clipped to the coincident-node
        range of the pre-DSS q."""
        m = self.mesh
        nt = q_new.shape[0]
        rho_out = self._dss(rho_tgt)
        Q_out = dss.dss_gather_t((q_new * rho_tgt[None]).reshape(nt, -1),
                                 self.d2c_map, m.c2d_idx, m.c2d_mask, self.Ff,
                                 self.slots)
        q_out = Q_out / torch.where(rho_out == 0, 1.0, rho_out).reshape(1, -1)
        vals = q_new.reshape(nt, -1)[:, m.c2d_idx]          # (nt, cnn, 4)
        inf = float("inf")
        lo = torch.amin(torch.where(m.c2d_mask, vals, inf), -1)
        hi = torch.amax(torch.where(m.c2d_mask, vals, -inf), -1)
        q_out = torch.minimum(torch.maximum(q_out, lo[:, self.d2c_map]),
                              hi[:, self.d2c_map])
        return rho_out, q_out.reshape(q_new.shape)

    def _step_impl(self, rho, q, ts, tf, rho_tgt_ext=None):
        cfg = self.config
        with trace.span("isl.step"):
            dep, ci, w = self._departure_data(ts, tf)
            with trace.span("isl.interp"):
                rho_tgt, q_tgt, node_src_cell = self._interp_phase(
                    rho, q, dep, ci, w)
            if rho_tgt_ext is not None:
                rho_tgt = rho_tgt_ext
            with trace.span("isl.rho_cdr"):
                rho_tgt = self._rho_cdr(rho, rho_tgt)
            with trace.span("isl.tracer_cdr"):
                q_new = self._tracer_cdr(rho, q, rho_tgt, q_tgt,
                                         node_src_cell)
            with trace.span("isl.dss"):
                if (rho_tgt_ext is not None and not cfg.positive_only
                        and cfg.filter not in ("none", "caas-node")):
                    return self._mixed_dss(rho_tgt, q_new)
                return rho_tgt, self._dss_q(rho_tgt, q_new)

    def footprint_stats(self, ts, tf):
        """The ISL communication footprint of the step ts -> tf: per target
        cell, the departure nodes whose source cell is another cell, plus
        2 per distinct such source cell (its min and max); returns (min,
        median, mean, max) over the cells, on the host."""
        m = self.mesh
        _, ci, _ = self._departure_data(ts, tf)
        node_src = ci[self.d2c_map].reshape(m.ncell, m.np2).cpu().numpy()
        out = node_src != np.arange(m.ncell)[:, None]
        s = np.sort(np.where(out, node_src, -1), axis=1)
        nuniq = ((s[:, 1:] != s[:, :-1]) & (s[:, 1:] >= 0)).sum(axis=1) \
            + (s[:, 0] >= 0)
        nout = out.sum(axis=1) + 2 * nuniq
        med = np.partition(nout, len(nout) // 2)[len(nout) // 2]
        return int(nout.min()), int(med), float(nout.mean()), int(nout.max())
