"""Cell-integrated remap transport, IR and CDG (compose_tpu.transport.ir).

One step:
  1. advect the deduplicated cell-corner vertices forward ts -> tf;
  2. pair every advected source cell with the 2-ring of Eulerian cells
     around the cell its advected centre lands in; clip the advected quad
     against each target cell (batched Sutherland-Hodgman, ops/clip.py),
     fan-triangulate the overlap and accumulate the np^2 x np^2 mixed mass
     matrix block T by triangle quadrature, in one of two geometries:
       - sphere (dmc none, es, eh, geh): quadrature on the spherical
         overlap with two Newton inverse maps per point;
       - facet (dmc f, ef): Newton inverses only at the overlap vertices,
         planar quadrature in the reference square; the transported field
         is (rho J) and the mass matrix the ref-square GLL one;
  3. IR's density factor FsmoFtm (Eulerian over advected source basis
     integrals); CDG carries the Jacobian ratio inside the quadrature
     (sphere) or integrates in source coordinates (facet), and under dmc f
     takes the facet factor too (a difference from the JAX package, see
     _density_factor);
  4. project: y = sum over a target's pairs of T (src FsmoFtm), then the
     per-cell Cholesky solve; dmc es/eh/ef add a per-cell mass equality
     (sphere or GLL measure), geh one global equality, dmc f the facet
     mass identity;
  5. optional CDR: per-cell q bounds over the T graph, global mass
     redistribution (K1 for caas), cell-local limiter (K2 for caas);
  6. optional d2c: DSS of rho and the tracer masses (K3).

The quadrature runs only on the pairs whose clipped overlap has a triangle
(a quarter to a third of the 25 candidates per source), in chunks of at
most `IrConfig.pair_chunk` pairs to bound device memory. Sums over the
pairs of a target run in pair order through a per-step gather table
(`_TargetTable`), not float atomics, so a step is bitwise reproducible on
the card; the contractions the JAX package
writes as explicit left-to-right chains (apply_T_contrib, dot_last,
mass_target_terms) keep that order here.

The working float type is the mesh's: f64, or f32 on the single-precision
route (the JAX package with x64 off), where the IR tables are the f64
ones rounded once (mesh/ir_data.py), the CDR runs K1 and K2 and the d2c
DSS K4 in f32. The per-cell solves and the target table's sums keep their
order in both.
"""

import dataclasses

import torch

from .. import basis as basis_mod
from ..mesh import cubed_sphere, ir_data
from ..ops import clip, sphere, sqr
from ..ops.reduce import bfb_sum
from . import dss, limiter as limiter_mod, spf, timeint
from .isl import MeshCells

_EQ_LOCAL = ("es", "eh", "ef")           # per-cell mass equality
_FACET = ("f", "ef")                     # facet transport
_HOMME_MASS = ("eh", "geh", "f", "ef")   # the GLL (Homme) mass measure
_DMCS = ("none", "es", "eh", "geh", "f", "ef")
_FILTERS = ("none", "caas", "qlt", "mn2")
_LIMITERS = ("mn2", "caas", "caags", "qlt", "none")


def apply_T_contrib(T, xs):
    """contrib[..., p, a] = sum_b T[p, a, b] xs[..., p, b], left to right."""
    acc = T[:, :, 0] * xs[..., 0][..., None]
    for b in range(1, T.shape[-1]):
        acc = acc + T[:, :, b] * xs[..., b][..., None]
    return acc


def dot_last(a, b):
    """sum_i a[..., i] b[..., i], left to right."""
    acc = a[..., 0] * b[..., 0]
    for i in range(1, a.shape[-1]):
        acc = acc + a[..., i] * b[..., i]
    return acc


def mass_target_terms(ps, F_src, xs):
    """dp[..., p] = sum_i ps[p, i] F_src[p, i] xs[..., p, i], left to
    right."""
    w = ps * F_src
    acc = w[:, 0] * xs[..., 0]
    for i in range(1, w.shape[-1]):
        acc = acc + w[:, i] * xs[..., i]
    return acc


def _cellwise(L, y, transpose=False):
    """Per-cell triangular solve L x = y (L^T x = y with `transpose`). L:
    (nc | 1, n, n) lower; y: (..., nc, n)."""
    lead, (nc, n) = y.shape[:-2], y.shape[-2:]
    yy = torch.movedim(y, -2, 0).reshape(nc, -1, n).transpose(1, 2)
    A = L.mT if transpose else L
    x = torch.linalg.solve_triangular(A, yy, upper=transpose)
    return torch.movedim(x.transpose(1, 2).reshape((nc,) + lead + (n,)), 0,
                         -2)


def mass_solve_blk(L, y):
    """Per-cell M^-1 y from the Cholesky factors L of M."""
    return _cellwise(L, _cellwise(L, y), transpose=True)


def solve_1eq_ls_blk(L, y, c, d):
    """Per-cell mass-constrained solve: min the M-norm distance to M^-1 y
    subject to c' x = d (FullMassMatrix::solve_1eq_ls)."""
    s = _cellwise(L, c)                                    # L s = c
    a1 = _cellwise(L, y)
    a2 = d - dot_last(s.expand(a1.shape), a1)
    mu = a2 / dot_last(s, s)
    return _cellwise(L, a1 + mu[..., None] * s, transpose=True)


@dataclasses.dataclass(frozen=True)
class IrConfig:
    ne: int
    np_: int = 4
    method: str = "ir"           # ir | cdg
    dmc: str = "none"            # none | es | eh | geh | f | ef
    filter: str = "none"         # global CDR: none | caas | qlt | mn2
    limiter: str = "mn2"         # mn2 | caas | caags | qlt
    nsub: int = 8
    # Pairs per chunk of the T assembly: bounds its device memory (about
    # 60-100 kB per pair in the sphere geometry at np 4).
    pair_chunk: int = 32768
    # T-fill triangle quadrature order (None: the accuracy-matched order of
    # np; facet dmc: (np-1)*4).
    tq: int = None
    d2c: bool = True             # DSS rho and the tracer masses each step

    def check(self):
        for k, allowed in (("method", ("ir", "cdg")), ("dmc", _DMCS),
                           ("filter", _FILTERS), ("limiter", _LIMITERS)):
            if getattr(self, k) not in allowed:
                raise ValueError(f"IrConfig.{k}={getattr(self, k)!r}: "
                                 f"expected {' | '.join(allowed)}")


class _TargetTable:
    """The pairs of each target cell, in pair order: (ncell, K) pair ids
    and validity, K the most pairs any target has in this step (one host
    read). Masked pairs carry zero T blocks and are left out."""

    def __init__(self, pair_tgt, pair_mask, ncell):
        tgt = torch.where(pair_mask, pair_tgt, ncell)
        order = torch.sort(tgt, stable=True).indices
        counts = torch.bincount(tgt, minlength=ncell + 1)[:ncell]
        K = max(int(counts.max()), 1)
        starts = torch.cumsum(counts, 0) - counts
        k = torch.arange(K, device=tgt.device)
        self.valid = k[None, :] < counts[:, None]               # (ncell, K)
        pos = torch.clamp(starts[:, None] + k[None, :], max=tgt.shape[0] - 1)
        self.pairs = order[pos]                                 # (ncell, K)
        self.K = K

    def sum(self, c):
        """Per-target sums of per-pair values c (..., P, n) -> (..., ncell,
        n), folded in pair order."""
        acc = None
        for k in range(self.K):
            ck = torch.where(self.valid[:, k, None], c[..., self.pairs[:, k], :],
                             0.0)
            acc = ck if acc is None else acc + ck
        return acc


class IrTransport:
    """Static IR data on the mesh's device, and the step."""

    def __init__(self, mesh: cubed_sphere.CubedSphereMesh, wind,
                 config: IrConfig, ird: ir_data.IrData = None):
        config.check()
        if (mesh.ne, mesh.np_) != (config.ne, config.np_):
            raise ValueError(f"mesh ne{mesh.ne} np{mesh.np_} does not match "
                             f"the config's ne{config.ne} np{config.np_}")
        self.mesh = mesh
        self.config = config
        self.wind = wind
        tq = config.tq
        if tq is None and config.dmc in _FACET:
            tq = (config.np_ - 1) * 4
        self.ird = ir_data.build(mesh, tq_order=tq) if ird is None else ird
        self.gll = basis_mod.GLL(config.np_)
        self.facet = config.dmc in _FACET
        self.F_sphere = mesh.dgbfi_sphere
        # The mass measure the step conserves: GLL for the Homme-mass dmcs,
        # else the sphere integrals.
        self.F_mass = (mesh.dgbfi_gll if config.dmc in _HOMME_MASS
                       else mesh.dgbfi_sphere)
        self.Ff = self.F_mass.reshape(-1).contiguous()
        self.d2c_map = mesh.dgll2cgll.reshape(-1)
        self.slots = dss.slot_table(mesh.c2d_idx, mesh.c2d_mask, self.d2c_map)
        self.euler_v = self.ird.vert_xyz[self.ird.cell2vert]   # (ncell, 4, 3)
        self.mrd = (spf.MassRedistributor(mesh.ncell, config.filter)
                    if config.filter != "none" else None)
        self.cells = MeshCells(
            self, self.F_mass, Jt=self.ird.Jt,
            chol=self.ird.chol_ref[None] if self.facet else self.ird.chol)

    # ------------------------------------------------------------------
    def step(self, rho, q, ts: float, tf: float):
        """Advance rho (ncell, np2) and mixing ratios q (nt, ncell, np2)
        from ts to tf. Returns (rho', q')."""
        return self._step_impl(rho, q, ts, tf)

    def remap_rho(self, rho, ts: float, tf: float):
        """Density-only remap plus the positivity limiter: the density leg
        of the mixed `isl` method."""
        rem = self._remap_data(ts, tf)
        rho_tgt = self._project(rem, rho, self._density_factor(rem))
        return limiter_mod.limit_density(
            self.F_mass, rho_tgt, rho_tgt.new_zeros(self.mesh.ncell))

    # ------------------------------------------------------------------
    def _pairs(self, adv_cells):
        """(src, tgt, mask) pairs: each advected source cell with the
        2-ring of the Eulerian cell its advected centre lands in."""
        m, ird = self.mesh, self.ird
        ncand = ird.cands.shape[1]
        ctr = sphere.normalize(torch.mean(adv_cells, dim=1))
        land = cubed_sphere.locate_cell(m, ctr)
        pair_src = torch.arange(m.ncell, device=m.device).repeat_interleave(
            ncand)
        return (pair_src, ird.cands[land].reshape(-1),
                ird.cands_mask[land].reshape(-1))

    def _pair_blocks(self, adv_cells, tci, sci, vo, no, src_corners):
        """T blocks (B, np2, np2) and source-share integrals (B, np2) of one
        chunk of pairs, from their clipped overlaps (vo, no); src_corners:
        the Eulerian corners of each source (CDG's Jacobian ratio)."""
        m, ird, cfg = self.mesh, self.ird, self.config
        np2 = m.np2
        bary, qw = ird.tq_bary, ird.tq_w
        is_cdg = cfg.method == "cdg"
        tgt_v = self.euler_v[tci]
        src_v = adv_cells[sci]
        tgt_corners = m.corners[tci]
        B = tci.shape[0]
        T = vo.new_zeros((B, np2, np2))
        ps = vo.new_zeros((B, np2))
        # Fan triangles k = 1..n_out-2; the triangles no pair of the chunk
        # has add zeros and are skipped (one host read).
        ktop = min(int(no.max()) - 1, clip.MAX_NVERT - 1)

        def clamp(u):
            # Empty-overlap and folded lanes can send the Newton far away;
            # true overlap points have |a|, |b| <= 1 + ulp, so the clamp only
            # touches lanes the masks zero, and keeps them finite.
            return torch.clamp(u, -2.0, 2.0)

        def phi(a, b):
            ga, gb = self.gll.eval(a), self.gll.eval(b)      # (B, nq, np)
            return (gb[..., :, None] * ga[..., None, :]).reshape(
                a.shape + (np2,))

        def accumulate(T, ps, d0, tphi, sphi):
            w = d0[..., None] * tphi                         # (B, nq, np2)
            return (T + torch.matmul(w.transpose(1, 2), sphi),
                    ps + torch.matmul(d0[:, None, :], sphi)[:, 0, :])

        if self.facet:
            valid = (torch.arange(clip.MAX_NVERT, device=m.device)[None, :]
                     < no[:, None])
            ctr = sphere.normalize(torch.mean(tgt_v, dim=-2))
            von = torch.where(valid[..., None], vo, ctr[:, None, :])
            von = von / torch.clamp_min(sphere.norm(von)[..., None],
                                        torch.finfo(von.dtype).tiny)
            ftol = 2.220446049250313e-16
            tva, tvb = map(clamp, sqr.sphere_to_ref(
                tgt_corners[:, None, :, :], von, max_its=15, tol=ftol))
            sva, svb = map(clamp, sqr.sphere_to_ref(
                src_v[:, None, :, :], von, max_its=15, tol=ftol))
            ja, jb = (sva, svb) if is_cdg else (tva, tvb)
            bT = bary.T                                      # (3, nq)
            for k in range(1, ktop):
                act = (k + 1) < no
                tri2 = ((ja[:, k] - ja[:, 0]) * (jb[:, k + 1] - jb[:, 0])
                        - (jb[:, k] - jb[:, 0]) * (ja[:, k + 1] - ja[:, 0]))
                d0 = 0.5 * tri2[:, None] * qw[None, :]
                d0 = torch.where(act[:, None], d0, 0.0)

                def pts(u):
                    return torch.stack([u[:, 0], u[:, k], u[:, k + 1]],
                                       dim=-1) @ bT          # (B, nq)
                T, ps = accumulate(T, ps, d0, phi(pts(tva), pts(tvb)),
                                   phi(pts(sva), pts(svb)))
            return T, ps

        for k in range(1, ktop):
            act = (k + 1) < no
            jac, pq = sphere.tri_jacobian(vo[:, None, 0, :], vo[:, None, k, :],
                                          vo[:, None, k + 1, :],
                                          bary[None, :, :])
            ta, tb = map(clamp, sqr.sphere_to_ref(tgt_corners[:, None, :, :],
                                                  pq))
            sa, sb = map(clamp, sqr.sphere_to_ref(src_v[:, None, :, :], pq))
            d0 = 0.5 * qw[None, :] * jac
            if is_cdg:
                # The Jacobian ratio Eulerian / advected at the source
                # reference coordinates.
                je = sqr.bilinear_jacobian_norm(
                    src_corners[sci][:, None, :, :], sa, sb)
                jadv = sqr.bilinear_jacobian_norm(src_v[:, None, :, :], sa, sb)
                d0 = d0 * (je / jadv)
            d0 = torch.where(act[:, None], d0, 0.0)
            T, ps = accumulate(T, ps, d0, phi(ta, tb), phi(sa, sb))
        return T, ps

    def _assemble_T(self, adv_cells, pair_src, pair_tgt, pair_mask,
                    src_corners=None):
        """T blocks (P, np2, np2) and raw source shares (P, np2). The clip
        runs on every pair; the quadrature only on the pairs whose overlap
        has a triangle (one host read), in chunks of at most pair_chunk
        pairs. The other pairs' blocks are zero, as the masked quadrature
        of the JAX package leaves them. pair_src indexes adv_cells and
        `src_corners` (default the mesh's corners: every cell a source)."""
        m, ird = self.mesh, self.ird
        src_v = adv_cells[pair_src]
        poly0 = torch.cat([src_v, torch.zeros_like(src_v)], dim=-2)
        vo, no = clip.clip_against_poly(self.euler_v[pair_tgt],
                                        ird.edge_nmls[pair_tgt], poly0,
                                        torch.where(pair_mask, 4, 0))
        live = torch.nonzero(no >= 3)[:, 0]
        P, L = pair_tgt.shape[0], live.shape[0]
        T = vo.new_zeros((P, m.np2, m.np2))
        ps = vo.new_zeros((P, m.np2))
        nchunk = -(-L // self.config.pair_chunk)
        size = -(-L // nchunk) if L else 1
        for lo in range(0, L, size):
            idx = live[lo:lo + size]
            T[idx], ps[idx] = self._pair_blocks(
                adv_cells, pair_tgt[idx], pair_src[idx], vo[idx], no[idx],
                m.corners if src_corners is None else src_corners)
        return T, ps

    @staticmethod
    def _src_sum(x, ncand):
        """Per-source sums of per-pair values (P, n): pairs are source-major,
        ncand per source; folded in pair order."""
        x = x.reshape(-1, ncand, x.shape[-1])
        acc = x[:, 0]
        for j in range(1, ncand):
            acc = acc + x[:, j]
        return acc

    def _fsmoftm(self, adv_cells, T, F_src):
        """IR density factor per DGLL node of each source: Eulerian over
        advected source basis integrals (facet: GLL weights over T's column
        sums). F_src: the sources' sphere integrals."""
        m = self.mesh
        if self.facet:
            colsum = self._src_sum(torch.sum(T, dim=-2),
                                   self.ird.cands.shape[1])
            colsum = torch.where(colsum == 0, 1.0, colsum)
            return self.ird.gll_w2[None, :] / colsum
        F_adv = cubed_sphere._dgbfi_sphere(
            adv_cells, self.ird.tq_bary, self.ird.tq_w,
            m.np_).reshape(-1, m.np2)
        return F_src / F_adv

    def _normalize_ps(self, ps_raw, pair_src):
        """Source-share integrals normalized per source basis function."""
        colsum = self._src_sum(ps_raw, self.ird.cands.shape[1])
        cs = colsum[pair_src]
        return ps_raw / torch.where(cs == 0, 1.0, cs)

    def _apply_T(self, rem, x):
        """y[tgt] = sum over the target's pairs of T_pair x[src]; x (...,
        ncell, np2)."""
        xs = x[..., rem.pair_src, :]
        xs = torch.where(rem.pair_mask[:, None], xs, 0.0)
        return rem.table.sum(apply_T_contrib(rem.T, xs))

    def _solve_glbl_eq(self, y, x_src):
        """One global mass equality in the GLL measure (dmc geh)."""
        L, F = self.ird.chol, self.F_mass
        s = _cellwise(L, F)
        z = _cellwise(L, y)
        mass = bfb_sum((F * x_src).reshape(x_src.shape[:-2] + (-1,)))
        a2 = mass - torch.sum(s * z, dim=(-2, -1))
        mu = a2 / torch.sum(s * s)
        return _cellwise(L, z + mu[..., None, None] * s, transpose=True)

    @staticmethod
    def _at_src(rem, x):
        """A per-cell table x at rem's sources."""
        return x if rem.src is None else x[rem.src]

    def _project(self, rem, x, FsmoFtm, cells=None):
        """The remap of one field batch x (..., nsrc, np2) on rem's sources
        onto the layout `cells` (default the whole mesh); FsmoFtm: the
        density factor, or None for none."""
        cells = self.cells if cells is None else cells
        cfg = self.config
        # The facet transport moves (x J): J first, then the density factor.
        xin = x * self._at_src(rem, self.ird.Jt) if self.facet else x
        if FsmoFtm is not None:
            xin = xin * FsmoFtm
        y = self._apply_T(rem, xin)
        if cfg.dmc in _EQ_LOCAL:
            # Local mass target: this cell's share of each source basis
            # function's mass.
            xs = x[..., rem.pair_src, :]
            xs = torch.where(rem.pair_mask[:, None], xs, 0.0)
            dp = mass_target_terms(
                rem.ps, self._at_src(rem, self.F_mass)[rem.pair_src], xs)
            d = rem.table.sum(dp[..., None])[..., 0]
            c = cells.F / cells.Jt if self.facet else cells.F
            out = solve_1eq_ls_blk(cells.chol, y, c, d)
        elif cfg.dmc == "geh":
            out = self._solve_glbl_eq(y, x)
        elif self.facet:
            # dmc f: enforce the facet identity w2' Mref^-1 y = 1' y, exact
            # in exact arithmetic, whose plain solve drifts by a fixed
            # per-cell defect in floating point (see _density_factor).
            d = dot_last(torch.ones_like(y), y)
            out = solve_1eq_ls_blk(cells.chol, y, cells.F / cells.Jt, d)
        else:
            out = mass_solve_blk(cells.chol, y)
        if self.facet:
            out = out / cells.Jt
        return cells.zero_pads(out)

    def _density_factor(self, rem):
        """IR's density factor; for CDG under dmc f the facet factor too
        (GLL weights over T's column sums), which is 1 in exact arithmetic;
        None for CDG otherwise. CDG's facet conservation rests on two
        identities that hold in exact arithmetic, T's column sums = w2 and
        w2' Mref^-1 = 1'. The JAX package leaves both to floating point,
        where their per-step defects (a few ulp of the mass each, set by the
        last bits of the tables) cancel or add depending on the machine that
        built the tables; the port enforces both, as the JAX package does
        for IR."""
        cfg = self.config
        if cfg.method == "ir" or cfg.dmc == "f":
            return self._fsmoftm(rem.adv_cells, rem.T,
                                 self._at_src(rem, self.F_sphere))
        return None

    def _remap_data(self, ts, tf):
        """Advected cells, pairs, T blocks, normalized shares and the
        per-target pair table of one step."""
        cfg = self.config
        adv_vert = timeint.integrate(self.wind.velocity, ts, tf,
                                     self.ird.vert_xyz, cfg.nsub)
        adv_cells = adv_vert[self.ird.cell2vert]
        pair_src, pair_tgt, pair_mask = self._pairs(adv_cells)
        T, ps_raw = self._assemble_T(adv_cells, pair_src, pair_tgt, pair_mask)
        return _Remap(adv_cells=adv_cells, pair_src=pair_src,
                      pair_tgt=pair_tgt, pair_mask=pair_mask, T=T,
                      ps=self._normalize_ps(ps_raw, pair_src),
                      table=_TargetTable(pair_tgt, pair_mask,
                                         self.mesh.ncell))

    def _q_bounds(self, rem, rho, Q):
        """Per-target-cell q bounds over the T-graph source neighbourhood,
        clamped to [0, 1]; cells without sources get [0, 1]."""
        q_src = Q / torch.where(rho == 0, 1.0, rho)[None]
        src = rem.pair_src[rem.table.pairs]                     # (ncell, K)
        v = rem.table.valid
        inf = float("inf")
        q_min = torch.amin(torch.where(v, torch.amin(q_src, -1)[..., src],
                                       inf), -1)
        q_max = torch.amax(torch.where(v, torch.amax(q_src, -1)[..., src],
                                       -inf), -1)
        q_min = torch.clamp_min(q_min, 0.0)
        q_max = torch.clamp_max(q_max, 1.0)
        return (torch.where(torch.isfinite(q_min), q_min, 0.0),
                torch.where(torch.isfinite(q_max), q_max, 1.0))

    def _cdr(self, rem, rho, Q, rho_tgt, Q_tgt, cells):
        """Density positivity, global redistribution of the tracer masses
        within the T-graph bounds (K1 for caas) and the cell-local limiter
        (K2 for caas), bounds expanded where a cell is infeasible; rho and
        Q on rem's sources, the targets on the layout `cells`."""
        cfg, F = self.config, cells.F
        rho_tgt = limiter_mod.limit_density(F, rho_tgt,
                                            rho_tgt.new_zeros(F.shape[0]))
        q_min, q_max = self._q_bounds(rem, rho, Q)
        nt = Q.shape[0]
        rho_cell = torch.sum(F * rho_tgt, dim=-1)
        Qc_mass = torch.sum(F[None] * Q_tgt, dim=-1)
        redist = cells.redistribute(
            rho_cell, q_min * rho_cell, Qc_mass, q_max * rho_cell,
            rho_cell.new_zeros(nt))
        shape = Q_tgt.shape
        Q_tgt = limiter_mod.limit_tracer(
            F, rho_tgt, Q_tgt, q_min[..., None].expand(shape).contiguous(),
            q_max[..., None].expand(shape).contiguous(), redist - Qc_mass,
            limiter=cfg.limiter, expand_bounds_allowed=True)
        return rho_tgt, Q_tgt

    def _step_impl(self, rho, q, ts, tf):
        m, cfg = self.mesh, self.config
        rho_tgt, Q_tgt = self._remap_cdr(self._remap_data(ts, tf), rho, q,
                                         self.cells)
        if not cfg.d2c:
            return rho_tgt, torch.where(
                rho_tgt[None] == 0, 0.0,
                Q_tgt / torch.where(rho_tgt == 0, 1.0, rho_tgt)[None])
        nt = Q_tgt.shape[0]
        rho_out = self.cells.dss(rho_tgt.reshape(1, -1)).reshape(m.ncell,
                                                                 m.np2)
        Q_out = self.cells.dss(Q_tgt.reshape(nt, -1)).reshape(Q_tgt.shape)
        return rho_out, Q_out / torch.where(rho_out == 0, 1.0, rho_out)[None]

    def _remap_cdr(self, rem, rho, q, cells):
        """The remap from rem's sources (rho, q) onto the layout `cells`:
        the projection of rho and the tracer masses Q = q rho, then the
        CDR; returns (rho_tgt, Q_tgt)."""
        FsmoFtm = self._density_factor(rem)
        Q = q * rho[None]
        rho_tgt = self._project(rem, rho, FsmoFtm, cells)
        Q_tgt = self._project(rem, Q, FsmoFtm, cells)
        if self.config.filter != "none":
            rho_tgt, Q_tgt = self._cdr(rem, rho, Q, rho_tgt, Q_tgt, cells)
        return rho_tgt, Q_tgt


@dataclasses.dataclass
class _Remap:
    """One step's remap data (see IrTransport._remap_data)."""
    adv_cells: torch.Tensor
    pair_src: torch.Tensor
    pair_tgt: torch.Tensor
    pair_mask: torch.Tensor
    T: torch.Tensor
    ps: torch.Tensor
    table: _TargetTable
    # The sources' cell ids (None: every cell, in order).
    src: torch.Tensor = None
