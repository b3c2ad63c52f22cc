"""Cell-local limiters (compose_tpu.transport.limiter): the density
positivity limiter, and the tracer limiters caas (kernel K2), mn2 (the
bound-constrained QP of ops/local_qp), caags (clip and weighted assured
sum) and qlt (a QLT tree over the np x np nodes of a cell).
"""

import math
import re

import numpy as np
import torch

from .. import _native, trace
from ..ops import local_qp
from .cdr_fused import limit_caas


def limit_density(F, rho, extra_mass):
    """Positivity limiter for density. F, rho: (ncell, np2), or rho
    (nt, ncell, np2) for a batch of fields; extra_mass: rho's shape less
    its last axis. Returns rho' >= 0 with sum(F rho') = sum(F rho) +
    extra_mass per cell. A uniform shift is the QP optimum unless it drives
    a node negative; only then (rare) the mn2 QP runs. Deciding that is one
    host sync per call."""
    mass_tgt = torch.sum(rho * F, dim=-1) + extra_mass
    any_below = torch.any(rho < 0, dim=-1)
    need = any_below | (extra_mass != 0)
    rho_clip = torch.clamp_min(rho, 0.0)
    mass = torch.sum(rho_clip * F, dim=-1)
    delta = mass_tgt - mass
    fac = delta / torch.sum(F, dim=-1)
    rho_add = rho_clip + fac[..., None]
    if bool(torch.any(rho_add < 0.0)):
        big = rho_clip + torch.abs(mass_tgt)[..., None] + 1.0
        x_qp, _ = local_qp.solve_1eq_bc_qp(F, F, mass_tgt,
                                           torch.zeros_like(rho), big,
                                           rho_clip)
    else:
        x_qp = rho_add
    sel = (delta >= 0) | torch.all(rho_add >= 0.0, dim=-1)
    out = torch.where(sel[..., None], rho_add, x_qp)
    return torch.where(need[..., None], out, rho)


# ---------------------------------------------------------------------------
# Cell-local QLT (limiter "qlt"): a 1-D tree over the np node indices,
# crossed with itself into a static tree over the np^2 nodes of a cell. The
# leaf-to-root sweep aggregates (lo, hi, y) masses by node membership; the
# root-to-leaf sweep splits each node's mass among its kids by one batched
# QP per (depth, kid count) group, then among each leaf's nodes.

_TREE_DESC = {
    4: "((0 1) (2 3))",
    7: "((0 1) (2 3 4) (5 6))",
    8: "(((0 1) (2 3)) ((4 5) (6 7)))",
    10: "(((0 1) (2 3)) (4 5) ((6 7) (8 9)))",
    11: "(((0 1) (2 3)) (4 5 6) ((7 8) (9 10)))",
    12: "(((0 1) (2 3 4)) (5 6) ((7 8 9) (10 11)))",
    13: "(((0 1) (2 3 4)) (5 6 7) ((8 9 10) (11 12)))",
    16: "((((0 1) (2 3)) ((4 5) (6 7))) "
        "(((8 9) (10 11)) ((12 13) (14 15))))",
}


def _parse_desc(desc):
    tokens = re.findall(r"[()]|\d+", desc)

    def parse(it):
        node = []
        for tok in it:
            if tok == "(":
                node.append(parse(it))
            elif tok == ")":
                return node
            else:
                node.append(int(tok))
        return node

    it = iter(tokens)
    next(it)  # leading '('
    return parse(it)


def _is_interior(nd):
    return any(isinstance(e, list) for e in nd)


def _tensor2d(n, x, y):
    """The tensor product of two 1-D trees over the n x n nodes."""
    xi, yi = _is_interior(x), _is_interior(y)
    if xi:
        kids = []
        for xk in x:
            if yi:
                kids += [_tensor2d(n, xk, yk) for yk in y]
            else:
                kids.append(_tensor2d(n, xk, y))
        return kids
    if yi:
        return [_tensor2d(n, x, yk) for yk in y]
    return [n * iy + ix for iy in y for ix in x]


class _Lqlt2dTree:
    """Flattened static tensor-2d tree for one np: node membership over the
    np^2 DOFs, interior nodes grouped by (depth, kid count), leaves by DOF
    count."""

    def __init__(self, np_):
        root = _tensor2d(np_, _parse_desc(_TREE_DESC[np_]),
                         _parse_desc(_TREE_DESC[np_]))
        np2 = np_ * np_
        self.kids, self.dofs, self.depth = [], [], []

        def rec(nd, depth):
            idx = len(self.kids)
            self.kids.append(None)
            self.dofs.append(None)
            self.depth.append(depth)
            if _is_interior(nd):
                self.kids[idx] = [rec(k, depth + 1) for k in nd]
            else:
                self.dofs[idx] = list(nd)
            return idx

        rec(root, 0)
        nnode = len(self.kids)
        memb = np.zeros((nnode, np2))
        for i in reversed(range(nnode)):
            if self.dofs[i] is not None:
                memb[i, self.dofs[i]] = 1.0
            else:
                for k in self.kids[i]:
                    memb[i] += memb[k]
        assert np.all(memb[0] == 1.0)
        self.memb = torch.tensor(memb, dtype=torch.float64)
        self.int_groups = []  # (node_ids (g,), kid_ids (g, k))
        for d in range(max(self.depth) + 1):
            byk = {}
            for i in range(nnode):
                if self.depth[i] == d and self.kids[i] is not None:
                    byk.setdefault(len(self.kids[i]), []).append(i)
            for _, ids in sorted(byk.items()):
                self.int_groups.append(
                    (torch.tensor(ids), torch.tensor([self.kids[i]
                                                      for i in ids])))
        byd = {}
        for i in range(nnode):
            if self.dofs[i] is not None:
                byd.setdefault(len(self.dofs[i]), []).append(i)
        self.leaf_groups = [
            (torch.tensor(ids), torch.tensor([self.dofs[i] for i in ids]))
            for _, ids in sorted(byd.items())]


_LQLT_TREES = {}


def _get_lqlt_tree(np_):
    if np_ not in _LQLT_TREES:
        _LQLT_TREES[np_] = (_Lqlt2dTree(np_) if np_ in _TREE_DESC else None)
    return _LQLT_TREES[np_]


def _local_qlt_tensor2d(a, b, xlo, xhi, y):
    """The cell-local QLT limiter, batched over all leading axes. a: (...,
    np2) per-DOF masses; b: (...,) target masses; xlo, xhi, y: (..., np2).
    An np without a tree solves the plain np2-dimensional QP."""
    np2 = y.shape[-1]
    np_ = math.isqrt(np2)
    tree = _get_lqlt_tree(np_) if np_ * np_ == np2 else None
    if tree is None:
        x, _ = local_qp.solve_1eq_bc_qp(a, a, b, xlo, xhi, y)
        return x
    if _native.has_dtensor(a, b, xlo, xhi, y):
        # The tree fills its node masses in place, which DTensor cannot
        # propagate into plain buffers: each rank solves its whole copy.
        return _native.on_local(_local_qlt_tensor2d, (a, b, xlo, xhi, y))
    dev = y.device
    memb = tree.memb.to(dtype=y.dtype, device=dev)
    lmass = torch.einsum('...i,ni->...n', a * xlo, memb)
    hmass = torch.einsum('...i,ni->...n', a * xhi, memb)
    ymass = torch.einsum('...i,ni->...n', a * y, memb)
    mass = torch.zeros(b.shape + (memb.shape[0],), dtype=y.dtype, device=dev)
    mass[..., 0] = b
    for node_ids, kid_ids in tree.int_groups:
        node_ids, kid_ids = node_ids.to(dev), kid_ids.to(dev)
        nb = mass[..., node_ids]                       # (..., g)
        kl = lmass[..., kid_ids]                       # (..., g, k)
        kh = hmass[..., kid_ids]
        ky = ymass[..., kid_ids]
        ones = torch.ones_like(kl)
        xk, _ = local_qp.solve_1eq_bc_qp(ones, ones, nb, kl, kh, ky)
        mass[..., kid_ids.reshape(-1)] = xk.reshape(xk.shape[:-2] + (-1,))
    out = torch.zeros_like(y)
    for leaf_ids, dof_ids in tree.leaf_groups:
        leaf_ids, dof_ids = leaf_ids.to(dev), dof_ids.to(dev)
        la = a[..., dof_ids]                           # (..., g, d)
        xs, _ = local_qp.solve_1eq_bc_qp(la, la, mass[..., leaf_ids],
                                         xlo[..., dof_ids],
                                         xhi[..., dof_ids], y[..., dof_ids])
        out[..., dof_ids.reshape(-1)] = xs.reshape(xs.shape[:-2] + (-1,))
    return out


def _expand_bounds(rhom, q_min, q_max, Qm_extra, lo, hi, rhom_tot):
    """Feasibility-restoring bound expansion of the cells whose target mass
    lies outside [sum rhom q_min, sum rhom q_max] (lo | hi): the bound on
    the violated side moves by the solution of a bound-adjusting QP, or to
    a constant if even that is infeasible. The QP runs only on those rows
    (its lanes are independent); the others keep their bounds."""
    act = lo | hi
    if not bool(torch.any(act)):
        return q_min, q_max
    args = (rhom, q_min, q_max, Qm_extra, lo, hi, rhom_tot)
    if _native.has_dtensor(*args):
        # The active rows' count depends on the data (nonzero): DTensor
        # has no sharding strategy for that, so each rank expands its
        # whole copy.
        return _native.on_local(_expand_bounds, args, n_out=2)
    rhom = rhom.expand(q_min.shape)
    rows = torch.nonzero(act, as_tuple=True)
    neg = lo[rows]
    rm, qn, qx = rhom[rows], q_min[rows], q_max[rows]
    q_bnd = torch.where(neg[..., None], qn, qx)
    Qm = Qm_extra[rows] + torch.sum(q_bnd * rm, dim=-1)
    all_min = torch.amin(qn, dim=-1, keepdim=True).expand(qn.shape)
    all_max = torch.amax(qx, dim=-1, keepdim=True).expand(qx.shape)
    q_bnd_min = torch.where(neg[..., None], all_min, qn)
    q_bnd_max = torch.where(neg[..., None], qx, all_max)
    Qm_lo = torch.sum(q_bnd_min * rm, dim=-1)
    Qm_hi = torch.sum(q_bnd_max * rm, dim=-1)
    feasible = (Qm_lo <= Qm) & (Qm <= Qm_hi)
    x_qp, _ = local_qp.solve_1eq_bc_qp(rm, rm, Qm, q_bnd_min, q_bnd_max,
                                       q_bnd)
    q_const = (Qm / rhom_tot.expand(act.shape)[rows])[..., None]
    new_bnd = torch.where(feasible[..., None], x_qp, q_const.expand(
        q_bnd.shape))
    q_min, q_max = q_min.clone(), q_max.clone()
    q_min[rows] = torch.where(neg[..., None], new_bnd, qn)
    q_max[rows] = torch.where(neg[..., None], qx, new_bnd)
    return q_min, q_max


def _spf_run(limiter, a, b, xlo, xhi, y):
    if limiter == "mn2":
        x, _ = local_qp.solve_1eq_bc_qp(a, a, b, xlo, xhi, y)
        return x
    if limiter == "caags":
        return local_qp.clip_and_weighted_sum(a, b, xlo, xhi, y)
    if limiter == "qlt":
        return _local_qlt_tensor2d(a, b, xlo, xhi, y)
    raise ValueError(f"unknown limiter {limiter}")


def limit_tracer(F, rho, Q, q_min, q_max, Qm_extra, limiter: str = "caas",
                 expand_bounds_allowed: bool = False, precomp=None,
                 return_q: bool = False):
    """Bounds-preserving tracer limiter, batched over tracers: per cell

        min sum_i w_i (q_i - y_i)^2  s.t.  sum_i F_i rho_i q_i = Qm_tot,
                                           q_min_i <= q_i <= q_max_i

    with w = a = F rho, y = Q / rho, Qm_tot = sum(F Q) + Qm_extra; 'caas'
    solves it by clip-and-assured-sum (K2), 'mn2' by the Newton QP, 'caags'
    by CAAGS, 'qlt' by the cell-local QLT tree. With
    `expand_bounds_allowed`, the bounds of cells whose problem is
    infeasible are first widened (_expand_bounds).

    F, rho: (ncell, np2); Q, q_min, q_max: (nt, ncell, np2); Qm_extra:
    (nt, ncell). `precomp` = (rhom, Qm_tot, Qm_min, Qm_max) as the ISL CDR
    already has them. Returns the mixing ratios if `return_q`, else Q;
    nodes with rho == 0 take q_min (the ISL CDR's zero-density rule)."""
    if limiter not in ("caas", "mn2", "caags", "qlt"):
        raise ValueError(f"unknown limiter {limiter}")
    if precomp is not None:
        rhom, Qm_tot, Qm_min, Qm_max = precomp
    else:
        rhom = rho * F
        Qm_tot = torch.sum(Q * F, dim=-1) + Qm_extra
        if expand_bounds_allowed:
            Qm_min = torch.sum(q_min * rhom, dim=-1)
            Qm_max = torch.sum(q_max * rhom, dim=-1)
    if expand_bounds_allowed:
        lo = Qm_tot < Qm_min
        hi = Qm_tot > Qm_max
        q_min, q_max = _expand_bounds(
            rhom, q_min, q_max, Qm_tot - torch.where(lo, Qm_min, Qm_max),
            lo, hi, torch.sum(rhom, dim=-1))
    if limiter == "caas":
        x = limit_caas(rhom, rho, Q, q_min, q_max, Qm_tot)
    else:
        # Zero-density nodes get a vanishing but nonzero QP weight so that
        # w/a and a/w stay finite: 1e-300 in f64, as in the JAX package,
        # and the smallest normal f32 in f32, where 1e-300 rounds to 0 and
        # a zero-density node would make its cell's QP return NaN (the
        # JAX package does that with x64 off).
        a = torch.clamp_min(rhom, max(1e-300, torch.finfo(rhom.dtype).tiny))
        y = Q * (1.0 / torch.where(rho == 0, 1.0, rho))
        if limiter == "mn2":
            with trace.span("cdr.mn2"):
                x = _spf_run(limiter, a, Qm_tot, q_min, q_max, y)
        else:
            x = _spf_run(limiter, a, Qm_tot, q_min, q_max, y)
        x = torch.where(rho == 0, q_min, x)
    return x if return_q else x * rho
