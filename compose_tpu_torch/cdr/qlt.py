"""QLT: quasi-local tree constrained density reconstructor
(compose_tpu.cdr.qlt), for every problem type of the standalone CEDR and
for the SHAPEPRESERVE type with a root-mass extra that the spf 'qlt'
filter uses.

Both sweeps are level-batched over a flat tree (tree.py): each level is one
gather, a vectorized node solve and an index_copy_ into the level's ids, so
the solve is O(log ncell) rounds of tensor ops whatever the tracer count.
No Python loop runs over nodes. Tracers are a dense leading axis.

`QLT.run` takes the CUDA kernel csrc/qlt_tree.cu (both sweeps in one
launch, bitwise equal to the level loop) for the spf filter's problem type,
SHAPEPRESERVE with no mass-conservation preference, on CUDA tensors of f64
or f32; every other call runs the eager level loop `QLT.run_plain`. CUDA
DTensors reach it through `_native.on_local`. The program's trace counters
`qlt.kernel` and `qlt.eager` count the runs of each.

Problem types follow cedr::ProblemType: a bitmask of conserve=1,
shapepreserve=2, consistent=4, nonnegative=16. Conserve takes the mass
target from Qm_prev; consistent without shapepreserve carries the q range
(kid min / max, not sums) up the tree and hands every node the root's
global range ("dynamic range"); nonnegative solves a nonnegativity-only
node problem.
"""

import numpy as np
import torch

from .. import _native, trace
from ..ops import local_qp
from . import tree as tree_mod

CONSERVE = 1
SHAPEPRESERVE = 2
CONSISTENT = 4
NONNEGATIVE = 16

_EPS = 2.220446049250313e-16


def _sum2(x):
    return x[..., 0] + x[..., 1]


def solve_1eq_bc_qp_2d(w, a, b, xlo, xhi, y, clip=True,
                       early_exit_on_tol=True):
    """Closed-form 2-unknown QP, batched over leading axes. w, a, xlo, xhi,
    y: (..., 2); b: (...,). Returns (x, info): info 1 solved, -1 infeasible
    (x then the nearest corner)."""
    r_tol = local_qp.calc_r_tol(b, a, y)

    r_lo = _sum2(a * xlo) - b
    r_hi = _sum2(a * xhi) - b
    lo_is_sol = torch.abs(r_lo) <= r_tol
    hi_is_sol = torch.abs(r_hi) <= r_tol
    infeas = (~lo_is_sol) & (~hi_is_sol) & ((r_lo > 0) | (r_hi < 0))
    if not early_exit_on_tol:
        lo_is_sol = torch.zeros_like(lo_is_sol)
        hi_is_sol = torch.zeros_like(hi_is_sol)
        infeas = torch.zeros_like(infeas)
    corner_sel = lo_is_sol | (infeas & (r_lo > 0))
    x_corner = torch.where(corner_sel[..., None], xlo, xhi)
    corner_done = lo_is_sol | hi_is_sol | infeas

    # Unconstrained optimum along the constraint line.
    q = a / w
    qmass = _sum2(a * q)
    dm = b - _sum2(a * y)
    lam = dm / qmass
    x_free = y + lam[..., None] * q
    free_ok = torch.all((x_free >= xlo) & (x_free <= xhi), dim=-1)

    # Constrained: intersect the line a'x = b with the box walls.
    x_base = 0.5 * b[..., None] / a
    x_dir = torch.stack([-a[..., 1], a[..., 0]], dim=-1)
    alphas = torch.stack([
        (xlo[..., 1] - x_base[..., 1]) / x_dir[..., 1],   # 0: bottom
        (xhi[..., 0] - x_base[..., 0]) / x_dir[..., 0],   # 1: right
        (xhi[..., 1] - x_base[..., 1]) / x_dir[..., 1],   # 2: top
        (xlo[..., 0] - x_base[..., 0]) / x_dir[..., 0],   # 3: left
    ], dim=-1)
    order = torch.argsort(alphas, dim=-1, stable=True)
    mid_ai = order[..., 1:3]                               # wall indices
    mid_alpha = torch.gather(alphas, -1, mid_ai)

    def objective(k):
        d = y - (x_base + mid_alpha[..., k, None] * x_dir)
        return _sum2(w * (d * d))

    pick = torch.where(objective(0) <= objective(1), 0, 1)
    ai = torch.gather(mid_ai, -1, pick[..., None])[..., 0]

    # Fix one coordinate at its wall, solve the other from the constraint.
    fixed_is_x1 = (ai == 0) | (ai == 2)     # bottom/top fix x[1]
    fixed_val = torch.where(
        ai == 0, xlo[..., 1], torch.where(
            ai == 1, xhi[..., 0], torch.where(ai == 2, xhi[..., 1],
                                              xlo[..., 0])))
    a_fixed = torch.where(fixed_is_x1, a[..., 1], a[..., 0])
    a_free = torch.where(fixed_is_x1, a[..., 0], a[..., 1])
    free_val = (b - a_fixed * fixed_val) / a_free
    if clip:
        free_lo = torch.where(fixed_is_x1, xlo[..., 0], xlo[..., 1])
        free_hi = torch.where(fixed_is_x1, xhi[..., 0], xhi[..., 1])
        free_val = torch.minimum(torch.maximum(free_val, free_lo), free_hi)
    x_wall = torch.where(
        fixed_is_x1[..., None],
        torch.stack([free_val, fixed_val], dim=-1),
        torch.stack([fixed_val, free_val], dim=-1))

    x = torch.where(free_ok[..., None], x_free, x_wall)
    x = torch.where(corner_done[..., None], x_corner, x)
    info = torch.where(infeas, -1, 1).to(torch.int32)
    return x, info


def r2l_nl_adjust_bounds(Qm_bnd, rhom, Qm_extra):
    """Feasibility-restoring bound relaxation, batched. Qm_bnd, rhom:
    (..., 2); Qm_extra: (...,). Returns the adjusted Qm_bnd."""
    q = Qm_bnd / rhom
    neg = Qm_extra < 0
    # i0: the kid whose q bound is (neg) the larger / (pos) the smaller.
    i0_is_0 = torch.where(neg, q[..., 0] >= q[..., 1], q[..., 0] <= q[..., 1])
    q_i0 = torch.where(i0_is_0, q[..., 0], q[..., 1])
    q_i1 = torch.where(i0_is_0, q[..., 1], q[..., 0])
    rhom_i0 = torch.where(i0_is_0, rhom[..., 0], rhom[..., 1])
    Qm_gap = (q_i1 - q_i0) * rhom_i0
    single_ok = torch.where(neg, Qm_gap <= Qm_extra, Qm_gap >= Qm_extra)
    zero = torch.zeros_like(Qm_extra)
    single = Qm_bnd + torch.stack([torch.where(i0_is_0, Qm_extra, zero),
                                   torch.where(i0_is_0, zero, Qm_extra)],
                                  dim=-1)
    # Both kids: equalize the q bounds.
    Qm_tot = Qm_bnd[..., 0] + Qm_bnd[..., 1] + Qm_extra
    q_tot = (Qm_tot / (rhom[..., 0] + rhom[..., 1]))[..., None]
    return torch.where(single_ok[..., None], single, q_tot * rhom)


def solve_node_problem(problem_type, rhom, pd, Qm, rhom0, k0d, rhom1, k1d,
                       prefer_mass_con_to_bounds=False):
    """Batched node QP. pd, k0d, k1d: (..., 3) = (Qm_min, Qm, Qm_max) of
    the node and its kids (the l2r data; q bounds for consistent without
    shapepreserve); rhom*: (...,). Returns the kids' masses (Qm0, Qm1)."""
    if (problem_type & CONSISTENT) and not (problem_type & SHAPEPRESERVE):
        def scale(d, r):
            return torch.stack([d[..., 0] * r, d[..., 1], d[..., 2] * r],
                               dim=-1)
        return solve_node_problem(
            problem_type | SHAPEPRESERVE, rhom, scale(pd, rhom), Qm, rhom0,
            scale(k0d, rhom0), rhom1, scale(k1d, rhom1),
            prefer_mass_con_to_bounds)
    if problem_type & NONNEGATIVE:
        a = torch.ones(Qm.shape + (2,), dtype=Qm.dtype, device=Qm.device)
        w = torch.stack([1.0 / rhom0, 1.0 / rhom1], dim=-1)
        y = torch.stack([k0d[..., 0], k1d[..., 0]], dim=-1)
        x, _ = local_qp.solve_1eq_nonneg(a, Qm, y, w, method="least_squares")
        return x[..., 0], x[..., 1]
    Qm_min_kids = torch.stack([k0d[..., 0], k1d[..., 0]], dim=-1)
    Qm_orig_kids = torch.stack([k0d[..., 1], k1d[..., 1]], dim=-1)
    Qm_max_kids = torch.stack([k0d[..., 2], k1d[..., 2]], dim=-1)
    rhom_kids = torch.stack([rhom0, rhom1], dim=-1)

    Qm_min, Qm_max = pd[..., 0], pd[..., 2]
    lo = Qm < Qm_min
    hi = Qm > Qm_max
    tol = 10 * _EPS
    discrepancy = torch.where(lo, Qm_min - Qm, Qm - Qm_max)
    act = (lo | hi) & (discrepancy > tol * (Qm_max - Qm_min))
    target = Qm - torch.where(lo, Qm_min, Qm_max)
    adj_min = r2l_nl_adjust_bounds(Qm_min_kids, rhom_kids, target)
    adj_max = r2l_nl_adjust_bounds(Qm_max_kids, rhom_kids, target)
    Qm_min_kids = torch.where((act & lo)[..., None], adj_min, Qm_min_kids)
    Qm_max_kids = torch.where((act & hi)[..., None], adj_max, Qm_max_kids)

    # Nothing changed and the kids are feasible: pass their masses through.
    no_change = ((~lo) & (~hi) & (Qm == pd[..., 1])
                 & torch.all((Qm_orig_kids >= Qm_min_kids)
                             & (Qm_orig_kids <= Qm_max_kids), dim=-1))

    ones = torch.ones_like(Qm_min_kids)
    x, _ = solve_1eq_bc_qp_2d(
        1.0 / rhom_kids, ones, Qm, Qm_min_kids, Qm_max_kids, Qm_orig_kids,
        clip=not prefer_mass_con_to_bounds,
        early_exit_on_tol=not prefer_mass_con_to_bounds)
    x = torch.where(no_change[..., None], Qm_orig_kids, x)
    return x[..., 0], x[..., 1]


class _Level:
    """One tree level's index tensors on a device: node ids, kid ids (kid 1
    clamped to 0 where absent), the single-kid mask, and the two-kid nodes'
    kid-1 ids with their positions in the level."""

    def __init__(self, ids, k0, k1, device):
        def t(a):
            return torch.as_tensor(a.astype("int64"), device=device)
        self.ids, self.k0 = t(ids), t(k0)
        self.k1s = t(k1.clip(min=0))
        self.single = torch.as_tensor(k1 < 0, device=device)
        self.pair = t((k1 >= 0).nonzero()[0])
        self.k1_pair = t(k1[k1 >= 0])


class QLT:
    """Functional QLT over a fixed tree.

        q = QLT(ncells, problem_type=SHAPEPRESERVE | CONSERVE)
        Qm_out = q.run(rhom, Qm, Qm_min, Qm_max, Qm_prev)

    Tracer arrays have shape (nt, ncells), rhom (ncells,). One problem type
    per instance; a mixed tracer set runs one QLT per type.
    """

    def __init__(self, ncells: int, problem_type: int = SHAPEPRESERVE,
                 imbalanced_tree: bool = False,
                 prefer_mass_con_to_bounds: bool = False):
        if not problem_type & (NONNEGATIVE | SHAPEPRESERVE | CONSISTENT):
            raise ValueError(f"invalid QLT problem type {problem_type}")
        self.ncells = ncells
        self.problem_type = problem_type
        self.prefer = prefer_mass_con_to_bounds
        self.tree = tree_mod.build(ncells, imbalanced_tree)
        self._levels = {}
        self._tables = {}

    def _levels_on(self, device):
        key = str(device)
        if key not in self._levels:
            self._levels[key] = [_Level(*lv, device)
                                 for lv in self.tree.levels]
        return self._levels[key]

    def _kernel_table(self, device):
        """The kernel's level table on `device` (int32): the nlev + 1
        level offsets, then the internal nodes' ids, kid-0 ids and kid-1
        ids (-1 when absent), level by level from the leaves up."""
        key = str(device)
        if key not in self._tables:
            self._tables[key] = torch.as_tensor(
                kernel_table(self.tree), device=device)
        return self._tables[key]

    def run(self, rhom, Qm, Qm_min=None, Qm_max=None, Qm_prev=None,
            root_extra=None):
        """Redistributed leaf masses (nt, ncells). Qm_min and Qm_max are
        unused by the nonnegative types, Qm_prev by the types without
        conserve. root_extra: optional (nt,) mass added to the ROOT total
        only (the spf contract root_mass = Q_data(root) + extra_mass),
        leaving every leaf channel untouched. The kernel where it applies
        (`takes_kernel`), else the eager level loop."""
        args = (rhom, Qm, Qm_min, Qm_max, Qm_prev, root_extra)
        if _native.has_dtensor(*args):
            return _native.on_local(self.run, args)
        if self.takes_kernel(Qm):
            trace.count("qlt.kernel")
            return self.run_kernel(rhom, Qm, Qm_min, Qm_max, root_extra)
        trace.count("qlt.eager")
        return self.run_plain(*args)

    def takes_kernel(self, Qm):
        """Whether `run` takes the kernel: CUDA tensors and problem type
        SHAPEPRESERVE with no mass-conservation preference (the spf `qlt`
        filter's contract)."""
        return (Qm.is_cuda and self.problem_type == SHAPEPRESERVE
                and not self.prefer)

    def kernel_operands(self, rhom, Qm, Qm_min, Qm_max, root_extra=None):
        """The kernel's operands, contiguous: [rhom, Qm_min, Qm, Qm_max]
        and root_extra flattened (None when absent; a number becomes a
        tensor of Qm's dtype, and one value expanded to every row stays
        one value). Raises unless rhom is (ncells,), Qm and its bounds
        (nt, ncells), root_extra of one value or one per row, all CUDA
        tensors of Qm's dtype and device."""
        if Qm.dim() != 2:
            raise ValueError(f"Qm: expected shape (nt, {self.ncells}), got "
                             f"{tuple(Qm.shape)}")
        nt, dt = Qm.shape[0], Qm.dtype
        if root_extra is not None and not isinstance(root_extra,
                                                     torch.Tensor):
            root_extra = torch.as_tensor(root_extra, dtype=dt,
                                         device=Qm.device)
        if root_extra is not None:
            if root_extra.dim() > 1 or root_extra.numel() not in (1, nt):
                raise ValueError(f"root_extra: expected one value or {nt}, "
                                 f"got shape {tuple(root_extra.shape)}")
            root_extra = root_extra.reshape(-1)
            if root_extra.stride(0) == 0:
                root_extra = root_extra[:1]
        ops = [("rhom", rhom, (self.ncells,)),
               ("Qm_min", Qm_min, (nt, self.ncells)),
               ("Qm", Qm, (nt, self.ncells)),
               ("Qm_max", Qm_max, (nt, self.ncells))]
        if root_extra is not None:
            ops.append(("root_extra", root_extra, (root_extra.numel(),)))
        out = []
        for name, t, shape in ops:
            if not isinstance(t, torch.Tensor):
                raise TypeError(f"{name}: expected a tensor, got "
                                f"{type(t).__name__}")
            if t.device != Qm.device:
                raise ValueError(f"{name}: expected a tensor on {Qm.device}"
                                 f", got {t.device}")
            t = t.contiguous()
            _native.require(t, name, dt, shape)
            out.append(t)
        return out[:4], (out[4] if root_extra is not None else None)

    def run_kernel(self, rhom, Qm, Qm_min, Qm_max, root_extra=None):
        """The kernel csrc/qlt_tree.cu: run_plain's result, bitwise, for
        problem type SHAPEPRESERVE with no preference, on the operands
        `kernel_operands` admits (it raises on any other). One launch on
        the current stream; the node arrays go to a scratch of
        5 x (nnodes - ncells) values per row."""
        ins, extra = self.kernel_operands(rhom, Qm, Qm_min, Qm_max,
                                          root_extra)
        nt, nl = Qm.shape
        kernel = _native.kernel("qlt_tree", Qm.dtype)
        table = self._kernel_table(Qm.device)
        nlev = len(self.tree.levels)
        out = torch.empty((nt, nl), dtype=Qm.dtype, device=Qm.device)
        scratch = torch.empty(nt * 5 * (self.tree.nnodes - nl),
                              dtype=Qm.dtype, device=Qm.device)
        stride = int(extra is not None and extra.numel() > 1)
        kernel(*(x.data_ptr() for x in ins),
               None if extra is None else extra.data_ptr(), stride,
               out.data_ptr(), scratch.data_ptr(), table.data_ptr(), nlev,
               nt, nl, stream=_native.stream_of(Qm))
        return out

    def run_plain(self, rhom, Qm, Qm_min=None, Qm_max=None, Qm_prev=None,
                  root_extra=None):
        """`run` as the eager level loop, for every problem type and
        device: the kernel's plain version."""
        pt = self.problem_type
        t = self.tree
        levels = self._levels_on(Qm.device)
        nt, nl, nn = Qm.shape[0], t.nleaf, t.nnodes
        kw = dict(dtype=Qm.dtype, device=Qm.device)
        conserve = bool(pt & CONSERVE)
        if pt & NONNEGATIVE:
            # The bound channels carry Qm itself.
            l2r_min = l2r_max = Qm
        elif pt & SHAPEPRESERVE:
            l2r_min, l2r_max = Qm_min, Qm_max
        else:
            l2r_min, l2r_max = Qm_min / rhom, Qm_max / rhom
        # Shape preservation and nonnegativity sum the bound channels up
        # the tree; the consistent-only types take the kids' q range.
        sum_bounds = bool(pt & (SHAPEPRESERVE | NONNEGATIVE))

        def leaves(x):
            V = torch.zeros(x.shape[:-1] + (nn,), **kw)
            V[..., :nl] = x
            return V

        V_rho, V_min, V_Qm, V_max = (leaves(x)
                                     for x in (rhom, l2r_min, Qm, l2r_max))
        V_prev = leaves(Qm_prev) if conserve else None

        # Leaf to root: kid sums (a single kid passes through), or for the
        # dynamic-range bounds the kids' min / max.
        def comb_sum(V, lv):
            v1 = torch.where(lv.single, 0.0, V[..., lv.k1s])
            return V[..., lv.k0] + v1

        def comb_ext(V, lv, op):
            v0 = V[..., lv.k0]
            return op(v0, torch.where(lv.single, v0, V[..., lv.k1s]))

        summed = [V_rho, V_Qm] + ([V_min, V_max] if sum_bounds else []) \
            + ([V_prev] if conserve else [])
        for lv in levels:
            for V in summed:
                V.index_copy_(-1, lv.ids, comb_sum(V, lv))
            if not sum_bounds:
                V_min.index_copy_(-1, lv.ids,
                                  comb_ext(V_min, lv, torch.minimum))
                V_max.index_copy_(-1, lv.ids,
                                  comb_ext(V_max, lv, torch.maximum))

        # Root: the total mass (of Qm_prev under conserve), plus the extra.
        M_root = (V_prev if conserve else V_Qm)[:, t.root]
        if root_extra is not None:
            M_root = M_root + root_extra
        M = torch.zeros((nt, nn), **kw)
        M[:, t.root] = M_root

        # Root to leaf: per-level batched node QPs. A level reads its
        # parents' masses (written by the level above) before it writes its
        # kids'. The consistent-only types give every node the root's q
        # range, which keeps each node problem feasible.
        dynamic_range = not sum_bounds
        if dynamic_range:
            qmin_g = V_min[:, t.root, None]
            qmax_g = V_max[:, t.root, None]

        def data(idx):
            if dynamic_range:
                shape = (nt, idx.shape[0])
                lo, hi = qmin_g.expand(shape), qmax_g.expand(shape)
            else:
                lo, hi = V_min[:, idx], V_max[:, idx]
            return torch.stack([lo, V_Qm[:, idx], hi], dim=-1)

        for lv in reversed(levels):
            Qm_node = M[:, lv.ids]
            shape = Qm_node.shape
            rhom0 = V_rho[lv.k0].expand(shape)
            rhom1 = torch.where(lv.single, 1.0, V_rho[lv.k1s]).expand(shape)
            Qm0, Qm1 = solve_node_problem(
                pt, V_rho[lv.ids].expand(shape), data(lv.ids), Qm_node,
                rhom0, data(lv.k0), rhom1, data(lv.k1s), self.prefer)
            M.index_copy_(1, lv.k0, torch.where(lv.single, Qm_node, Qm0))
            M.index_copy_(1, lv.k1_pair, Qm1[:, lv.pair])
        return M[:, :nl]


def kernel_table(tree):
    """csrc/qlt_tree.cu's level table of `tree` (int32 numpy): the nlev + 1
    offsets of the levels in the node lists, then the internal nodes' ids,
    kid-0 ids and kid-1 ids (-1 when absent), each list level by level
    from the leaves up."""
    sizes = [len(ids) for ids, _, _ in tree.levels]
    off = np.concatenate([[0], np.cumsum(sizes, dtype=np.int64)])
    cols = [np.concatenate([lv[c] for lv in tree.levels]
                           + [np.zeros(0, np.int32)]) for c in range(3)]
    return np.concatenate([off] + cols).astype(np.int32)
