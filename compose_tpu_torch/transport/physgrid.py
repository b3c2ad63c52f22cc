"""Physgrid: GLL <-> FV (nphys x nphys subcell) remaps for physics coupling
(compose_tpu.transport.physgrid; pg::Gll2Fv and the Fv2Gll variants of
slmmir_physgrid.{hpp,cpp}).

  - M_dp: the mixed mass matrix of basis-function integrals over the FV
    subcells, a tensor product of 1-D integrals computed exactly by
    piecewise Gauss quadrature split at the basis's region breaks;
  - gll2fv: subcell averages, p = M_dp' (J_gll d) / (M_pp J_fv);
  - fv2gll, one dense (np^2, nphys^2) operator per variant:
      idem    - the idempotent reconstruction through GLL(nphys), then
                interpolated to np (FV -> GLL -> FV returns the FV state);
      l2      - L2 projection through the piecewise-linear hat basis;
      l2ep    - the same with the hat reconstruction KKT-constrained to
                conserve every perimeter subcell's mass (and the element's);
      elrecon - each subcell's value from an idempotent GLL(3) panel over
                its neighbours, L2-projected onto the np basis (nphys <= 2
                coincides with idem);
  - a cell-local CAAS of the remapped mixing ratio against bounds.

The operators are set up in numpy f64 on the host, as the JAX package sets
them up, and rounded once to the mesh's dtype (f32 on the
single-precision route); only the remaps and the CAAS run as torch ops on
the mesh's device.
"""

import numpy as np
import torch

from .. import basis as basis_mod
from ..config import F64
from ..ops import local_qp, sqr


def _eval_np(bas, x):
    """Basis values (n, np) at the numpy points x, in numpy f64 (the hat
    basis evaluates in numpy itself)."""
    if isinstance(bas, _Hat1D):
        return bas.eval(x)
    return bas.eval(torch.tensor(np.asarray(x), dtype=F64)).numpy()


def _basis_region_breaks(bas):
    """1-D break points where the basis is only piecewise polynomial."""
    xs = np.asarray(bas.x)
    return np.unique(np.concatenate([[-1.0], xs, [1.0]]))


def _basis_1d_integrals(bas, nphys: int):
    """I1[i, p] = integral of basis function i over FV interval p of
    [-1, 1], exact by piecewise Gauss split at the region breaks."""
    np_ = bas.np
    edges = np.linspace(-1.0, 1.0, nphys + 1)
    breaks = _basis_region_breaks(bas)
    gx, gw = np.polynomial.legendre.leggauss(np_ + 2)
    I1 = np.zeros((np_, nphys))
    for p in range(nphys):
        lo, hi = edges[p], edges[p + 1]
        pts = np.unique(np.clip(
            np.concatenate([[lo, hi], breaks[(breaks > lo) & (breaks < hi)]]),
            lo, hi))
        for a, b in zip(pts[:-1], pts[1:]):
            xm = 0.5 * (a + b) + 0.5 * (b - a) * gx
            wm = 0.5 * (b - a) * gw
            I1[:, p] += (wm[:, None] * _eval_np(bas, xm)).sum(axis=0)
    return I1


def _mixed_mass_matrix(bas, nphys: int):
    """M_dp[(j*np+i), (py*nphys+px)] by the tensor factorization."""
    I1 = _basis_1d_integrals(bas, nphys)
    np_ = bas.np
    return np.einsum('jq,ip->jiqp', I1, I1).reshape(np_ * np_, nphys * nphys)


class _Hat1D:
    """Piecewise-linear hat basis on np uniform nodes in [-1, 1], linearly
    extrapolated outside (UniformNodeReduced, slmm_basis_reduced.cpp)."""

    def __init__(self, np_: int):
        self.np = np_
        self.x = np.linspace(-1.0, 1.0, np_)

    def eval(self, x):
        xn = self.x
        xx = np.asarray(x)
        v = np.zeros(xx.shape + (self.np,))
        h = xn[1] - xn[0]
        for i in range(self.np):
            v[..., i] = np.clip(1.0 - np.abs(xx - xn[i]) / h, 0.0, None)
        lo = xx < xn[0]
        hi = xx > xn[-1]
        if np.any(lo):
            v[lo] = 0.0
            v[lo, 0] = (xn[1] - xx[lo]) / h
            v[lo, 1] = (xx[lo] - xn[0]) / h
        if np.any(hi):
            v[hi] = 0.0
            v[hi, -2] = (xn[-1] - xx[hi]) / h
            v[hi, -1] = (xx[hi] - xn[-2]) / h
        return v


def _mass_matrix_1d(bas_a, bas_b):
    """M[i, j] = integral over [-1, 1] of a_i b_j, exact piecewise Gauss
    with the breaks of both bases."""
    breaks = np.unique(np.concatenate(
        [_basis_region_breaks(bas_a), _basis_region_breaks(bas_b)]))
    gx, gw = np.polynomial.legendre.leggauss(bas_a.np + bas_b.np + 2)
    M = np.zeros((bas_a.np, bas_b.np))
    for a, b in zip(breaks[:-1], breaks[1:]):
        xm = 0.5 * (a + b) + 0.5 * (b - a) * gx
        wm = 0.5 * (b - a) * gw
        M += np.einsum('q,qi,qj->ij', wm, _eval_np(bas_a, xm),
                       _eval_np(bas_b, xm))
    return M


def _interp_matrix(np_from: int, np_to: int):
    """Lagrange interpolation matrix from the GLL np_from nodes to the GLL
    np_to nodes, tensorized: (np_to^2, np_from^2)."""
    v = _eval_np(basis_mod.GLL(np_from), basis_mod.GLL(np_to).x.numpy())
    return np.einsum('ia,jb->ijab', v, v).reshape(np_to * np_to,
                                                  np_from * np_from)


def _hat_matrices(nphys):
    """(hat basis, M_pdi^T, M_didi) of the hat reconstruction."""
    hat = _Hat1D(max(2, nphys))
    M1_hh = _mass_matrix_1d(hat, hat)
    return hat, _mixed_mass_matrix(hat, nphys), np.kron(M1_hh, M1_hh)


def _project_to_basis(bas, hat, C):
    """M_dd^-1 M_ddi C: the L2 projection of a hat-basis reconstruction C
    onto the np basis."""
    M1_dh = _mass_matrix_1d(bas, hat)
    M1_dd = _mass_matrix_1d(bas, bas)
    return np.linalg.solve(np.kron(M1_dd, M1_dd),
                           np.kron(M1_dh, M1_dh) @ C)


def _op_l2(bas, nphys):
    """L2Fv2Gll: op = M_dd^-1 M_ddi M_didi^-1 M_pdi^T."""
    hat, M_pdiT, M_didi = _hat_matrices(nphys)
    return _project_to_basis(bas, hat, np.linalg.solve(M_didi, M_pdiT))


def _op_l2ep(bas, nphys):
    """L2ExceptPerimFv2Gll: the hat reconstruction constrained (KKT) to
    conserve each perimeter subcell's mass, plus the element's total mass
    unless every subcell is on the perimeter; then L2-projected."""
    npi = max(2, nphys)
    nphys2, npi2 = nphys * nphys, npi * npi
    hat, M_pdiT, M_didi = _hat_matrices(nphys)
    mass_constraint = 0 if nphys == 2 else 1
    perim = [i * nphys + j for i in range(nphys) for j in range(nphys)
             if i in (0, nphys - 1) or j in (0, nphys - 1)]
    ncon = len(perim) + mass_constraint
    Con = np.zeros((ncon, npi2))
    D = np.zeros((ncon, nphys2))
    for k, sc in enumerate(perim):
        Con[k] = M_pdiT[:, sc]
        D[k, sc] = 4.0 / nphys2
    if mass_constraint:
        # The hat basis's quadrature weights: the trapezoid rule.
        wts = np.full(npi, 2.0 / (npi - 1))
        wts[0] = wts[-1] = 1.0 / (npi - 1)
        Con[-1] = np.outer(wts, wts).reshape(-1)
        D[-1, :] = 4.0 / nphys2
    K = np.zeros((npi2 + ncon, npi2 + ncon))
    K[:npi2, :npi2] = M_didi
    K[:npi2, npi2:] = Con.T
    K[npi2:, :npi2] = Con
    CX = np.linalg.solve(K, np.concatenate([M_pdiT, D], axis=0))[:npi2]
    return _project_to_basis(bas, hat, CX)


def _op_elrecon(bas, np_, nphys):
    """ElemLclReconFv2Gll (nphys >= 3): each subcell's panel is the 3
    consecutive subcells around it per dimension (clamped at the element's
    edges), mapped onto [-1, 1] in thirds, with an idempotent GLL(3)
    reconstruction of their FV values; the per-subcell reconstruction of
    each FV unit vector is L2-projected onto the np basis."""
    nf = nphys
    nf2 = nf * nf
    np2 = np_ * np_
    g3 = basis_mod.GLL(3)
    M3 = _mixed_mass_matrix(g3, 3)
    inv3 = np.linalg.solve(M3.T, np.eye(9) * (4.0 / 9.0))
    edges = np.linspace(-1.0, 1.0, nf + 1)

    def panel_range(j):
        if j == 0:
            return (-1.0, -1.0 / 3.0)
        if j == nf - 1:
            return (1.0 / 3.0, 1.0)
        return (-1.0 / 3.0, 1.0 / 3.0)

    def neighbors(j):
        if j == 0:
            return [0, 1, 2]
        if j == nf - 1:
            return [nf - 3, nf - 2, nf - 1]
        return [j - 1, j, j + 1]

    breaks = np.unique(np.concatenate([_basis_region_breaks(bas), edges]))
    gx, gw = np.polynomial.legendre.leggauss(np_ + 6)
    pieces = []  # (subcell, np-basis values, GLL(3) panel values, weights)
    for a, b in zip(breaks[:-1], breaks[1:]):
        mid = 0.5 * (a + b)
        j = min(nf - 1, max(0, int(nf * (mid + 1) / 2)))
        xs = 0.5 * (a + b) + 0.5 * (b - a) * gx
        ws = 0.5 * (b - a) * gw
        lo, hi = edges[j], edges[j + 1]
        plo, phi = panel_range(j)
        alpha = (xs - lo) / (hi - lo)
        xp = (1 - alpha) * plo + alpha * phi
        pieces.append((j, _eval_np(bas, xs), _eval_np(g3, xp), ws))

    M_mix = np.zeros((np2, nf2))
    for dof in range(nf2):
        ei = np.zeros(nf2)
        ei[dof] = 1.0
        coef = np.zeros((nf, nf, 9))
        for sci in range(nf):
            for scj in range(nf):
                pv = np.array([ei[i * nf + j] for i in neighbors(sci)
                               for j in neighbors(scj)])
                coef[sci, scj] = inv3 @ pv
        for (jy, vy, vy3, wy) in pieces:
            for (jx, vx, vx3, wx) in pieces:
                c = coef[jy, jx].reshape(3, 3)
                f = np.einsum('qi,ij,rj->qr', vy3, c, vx3)
                wqr = np.outer(wy, wx) * f
                M_mix[:, dof] += np.einsum('qr,qi,rj->ij', wqr, vy,
                                           vx).reshape(-1)
    M1_dd = _mass_matrix_1d(bas, bas)
    return np.linalg.solve(np.kron(M1_dd, M1_dd), M_mix)


class PhysgridOps:
    """Per-mesh physgrid operators, on the mesh's device in f64.

    gll_met: (ncell, np2) the sphere Jacobian at the GLL nodes
    (mesh.jac_node); fv_met: (ncell, nphys2) the mean Jacobian over each FV
    subcell; op_j: the (np2, nphys2) fv2gll operator; M_dp_j, M_pp_j: the
    mixed and FV mass matrices."""

    def __init__(self, mesh, nphys: int, fv2gll_type: str = "idem"):
        if fv2gll_type not in ("idem", "l2", "l2ep", "elrecon"):
            raise ValueError(f"fv2gll_type {fv2gll_type!r}: expected idem | "
                             "l2 | l2ep | elrecon")
        self.mesh = mesh
        self.nphys = nphys
        self.fv2gll_type = fv2gll_type
        np_ = mesh.np_
        bas = basis_mod.create(mesh.basis_name, np_)
        self.M_dp = _mixed_mass_matrix(bas, nphys)         # (np2, nphys2)
        self.M_pp = np.full(nphys * nphys, (2.0 / nphys) ** 2)
        gw = basis_mod.GLL(np_).w.numpy()
        w_dd = np.outer(gw, gw).reshape(-1)
        if fv2gll_type == "l2":
            op = _op_l2(bas, nphys)
        elif fv2gll_type == "l2ep":
            op = _op_l2ep(bas, nphys)
        elif fv2gll_type == "elrecon" and nphys >= 3:
            op = _op_elrecon(bas, np_, nphys)
        else:
            # idem, and elrecon at nphys <= 2 where the two coincide.
            npi = max(2, nphys)
            M_dp_i = _mixed_mass_matrix(basis_mod.GLL(npi), nphys)
            if nphys >= 2:
                inv = np.linalg.solve(M_dp_i.T, np.diag(self.M_pp))
            else:
                # nphys 1: the least-norm reconstruction through npi 2.
                inv = np.linalg.pinv(M_dp_i.T) @ np.diag(self.M_pp)
            op = _interp_matrix(npi, np_) @ inv
        self.op_p_to_d = op

        def on_mesh(a):
            return torch.tensor(np.asarray(a), dtype=F64,
                                device=mesh.device).to(mesh.dtype)

        self.gll_met = mesh.jac_node
        self.fv_met = on_mesh(self._fv_metdet())
        self.M_dp_j = on_mesh(self.M_dp)
        self.op_j = on_mesh(op)
        self.M_pp_j = on_mesh(self.M_pp)
        self.w_dd = on_mesh(w_dd)

    def _fv_metdet(self):
        """Each FV subcell's mean corner-bilinear |J|: 4x4 Gauss over the
        subcell, on the host in f64."""
        m = self.mesh
        nphys = self.nphys
        corners = m.corners.to(dtype=F64, device="cpu")
        gx, gw = np.polynomial.legendre.leggauss(4)
        edges = np.linspace(-1.0, 1.0, nphys + 1)
        out = np.zeros((m.ncell, nphys * nphys))
        for py in range(nphys):
            for px in range(nphys):
                ax = 0.5 * (edges[px] + edges[px + 1])
                hx = 0.5 * (edges[px + 1] - edges[px])
                ay = 0.5 * (edges[py] + edges[py + 1])
                hy = 0.5 * (edges[py + 1] - edges[py])
                acc = 0.0
                for i in range(len(gx)):
                    for j in range(len(gx)):
                        J = sqr.bilinear_jacobian_norm(
                            corners,
                            torch.full((m.ncell,), ax + hx * gx[i],
                                       dtype=F64),
                            torch.full((m.ncell,), ay + hy * gx[j],
                                       dtype=F64))
                        acc = acc + gw[i] * gw[j] * J.numpy()
                out[:, py * nphys + px] = acc / 4.0
        return out

    # ------------------------------------------------------------------
    def gll2fv(self, rho_d, q_d, limiter: str = "caas"):
        """(ncell, np2), (nt, ncell, np2) -> the FV state (ncell, nphys2),
        (nt, ncell, nphys2); with limiter caas the FV mixing ratios are
        held to each cell's GLL range."""
        md = self.M_dp_j
        den = self.M_pp_j[None, :] * self.fv_met
        rho_p = torch.einsum('dp,cd->cp', md, rho_d * self.gll_met) / den
        Q_p = torch.einsum('dp,ncd->ncp', md,
                           (q_d * rho_d[None]) * self.gll_met[None]) \
            / den[None]
        q_p = Q_p / rho_p[None]
        if limiter == "caas":
            qlo = torch.amin(q_d, dim=-1)
            qhi = torch.amax(q_d, dim=-1)
            a = den[None] * rho_p[None]
            b = torch.sum(a * q_p, dim=-1)
            q_p = local_qp.caas(a.expand(q_p.shape), b, qlo[..., None],
                                qhi[..., None], q_p)
        return rho_p, q_p

    def fv2gll(self, rho_p, q_p, qlo=None, qhi=None, limiter: str = "caas"):
        """The FV state back to GLL. qlo, qhi: (nt, ncell) mixing-ratio
        bounds for the caas limiter, by default each cell's FV extrema."""
        op = self.op_j
        rho_d = torch.einsum('dp,cp->cd', op, self.fv_met * rho_p) \
            / self.gll_met
        Q_d = torch.einsum('dp,ncp->ncd', op,
                           (self.fv_met * rho_p)[None] * q_p) \
            / self.gll_met[None]
        q_d = Q_d / rho_d[None]
        if limiter == "caas" and self.nphys > 1:
            if qlo is None:
                qlo = torch.amin(q_p, dim=-1)
            if qhi is None:
                qhi = torch.amax(q_p, dim=-1)
            a = (self.w_dd[None, :] * self.gll_met)[None] * rho_d[None]
            b = torch.sum(a * q_d, dim=-1)
            q_d = local_qp.caas(a.expand(q_d.shape), b, qlo[..., None],
                                qhi[..., None], q_d)
        return rho_d, q_d
