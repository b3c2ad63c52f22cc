"""Distributed QLT: a sharded level schedule over the reduction tree
(compose_tpu.cdr.qlt_sharded).

Each shard owns a set of leaves (contiguous blocks by default, ragged when
ncells is not a multiple of n_shards, or any `owner` map). A node is
shard-local when all its leaves share one owner.

  l2r: each shard sweeps its local nodes level by level, producing the
       values of its "frontier" (local nodes whose parent is not local).
       One all_gather ships every shard's frontier, and every shard
       combines the remaining "top" of the tree (< 2 n_shards nodes for
       contiguous blocks) redundantly.
  r2l: every shard solves the top node problems down to the frontier,
       takes its own frontier masses and finishes the sweep locally.

The tree and every node's arithmetic are those of cdr/qlt.py's QLT, so
the result is bitwise equal to QLT.run on the assembled arrays for every
decomposition. The index tables are those of the JAX package (numpy, equal
exactly); each shard runs only its own rows, without their padding.
"""

import numpy as np
import torch

from .. import trace
from . import tree as tree_mod
from .qlt import (CONSERVE, CONSISTENT, NONNEGATIVE, SHAPEPRESERVE,
                  solve_node_problem)


class _Lv:
    """One level's index tensors (ids, kid 0, kid 1 clamped to 0, the
    single-kid mask, the two-kid nodes' positions and kid-1 ids)."""

    def __init__(self, ids, k0, k1, device):
        def t(a):
            return torch.as_tensor(np.asarray(a, np.int64), device=device)
        self.ids, self.k0 = t(ids), t(k0)
        self.k1s = t(np.maximum(k1, 0))
        self.single = torch.as_tensor(np.asarray(k1) < 0, device=device)
        self.pair = t(np.nonzero(np.asarray(k1) >= 0)[0])
        self.k1_pair = t(np.asarray(k1)[np.asarray(k1) >= 0])


class ShardedQLT:
    """QLT over `ncells` leaves split among `n_shards` shards; every problem
    type of cdr.qlt.QLT (balanced tree)."""

    def __init__(self, ncells: int, n_shards: int,
                 problem_type: int = SHAPEPRESERVE,
                 prefer_mass_con_to_bounds: bool = False,
                 owner: np.ndarray = None):
        if n_shards < 2:
            raise ValueError("ShardedQLT: use cdr.qlt.QLT for one shard")
        if not problem_type & (NONNEGATIVE | SHAPEPRESERVE | CONSISTENT):
            raise ValueError(f"invalid QLT problem type {problem_type}")
        self.ncells = ncells
        self.n_shards = n_shards
        self.problem_type = problem_type
        self.prefer = prefer_mass_con_to_bounds
        t = tree_mod.build(ncells)
        self.tree = t
        if owner is None:
            B = -(-ncells // n_shards)
            owner = np.arange(ncells) // B
        owner = np.asarray(owner, np.int64)
        counts = np.bincount(owner, minlength=n_shards)
        if owner.shape != (ncells,) or len(counts) != n_shards \
                or counts.min() < 1:
            raise ValueError("ShardedQLT: the owner map must give every "
                             "leaf one of the shards and every shard a "
                             "leaf")
        B = int(counts.max())
        self.block = B
        leaf_idx = np.zeros((n_shards, B), np.int64)
        leaf_slot = np.zeros(ncells, np.int64)
        for s in range(n_shards):
            mine = np.nonzero(owner == s)[0]
            leaf_idx[s, :len(mine)] = mine
            leaf_idx[s, len(mine):] = mine[0]
            leaf_slot[mine] = np.arange(len(mine))
        self.leaf_idx = leaf_idx
        self.leaf_count = counts
        self.owner_leaf = owner

        own = np.full(t.nnodes, -1, np.int64)
        own[:t.nleaf] = owner
        for ids, k0, k1 in t.levels:
            o0 = own[k0]
            o1 = np.where(k1 < 0, o0, own[np.maximum(k1, 0)])
            own[ids] = np.where(o0 == o1, o0, -1)
        parent = np.full(t.nnodes, -1, np.int64)
        for ids, k0, k1 in t.levels:
            parent[k0] = ids
            parent[np.maximum(k1, 0)] = np.where(
                k1 < 0, parent[np.maximum(k1, 0)], ids)

        # Local slots: [0, B) leaves, [B, B + nloc_int) internal, a dummy
        # last (the padding of the JAX tables' rows).
        loc_of = {}
        nloc_int = np.zeros(n_shards, np.int64)
        for g in range(t.nleaf):
            loc_of[g] = (int(owner[g]), int(leaf_slot[g]))
        for g in range(t.nleaf, t.nnodes):
            s = own[g]
            if s >= 0:
                loc_of[g] = (int(s), B + int(nloc_int[s]))
                nloc_int[s] += 1
        self.loc_size = B + int(nloc_int.max()) + 1
        D = self.loc_size - 1

        self.local_levels = []            # (ids, k0, k1), each (ns, m)
        for ids, k0, k1 in t.levels:
            rows = [[] for _ in range(n_shards)]
            for i, g in enumerate(ids):
                s = own[g]
                if s >= 0:
                    kk0 = loc_of[int(k0[i])][1]
                    kk1 = -1 if k1[i] < 0 else loc_of[int(k1[i])][1]
                    rows[s].append((loc_of[g][1], kk0, kk1))
            m = max(len(r) for r in rows)
            if m == 0:
                continue
            lids = np.full((n_shards, m), D, np.int32)
            lk0 = np.full((n_shards, m), D, np.int32)
            lk1 = np.full((n_shards, m), -1, np.int32)
            for s in range(n_shards):
                for j, (a, b, c) in enumerate(rows[s]):
                    lids[s, j], lk0[s, j], lk1[s, j] = a, b, c
            self.local_levels.append((lids, lk0, lk1))

        frontier = [[] for _ in range(n_shards)]
        for g in range(t.nnodes):
            s = own[g]
            if s >= 0 and (parent[g] < 0 or own[parent[g]] < 0):
                if g != t.root:
                    frontier[s].append(g)
        assert own[t.root] < 0
        max_nf = max(len(f) for f in frontier)
        self.max_nf = max_nf
        self.n_frontier = [len(f) for f in frontier]
        fr_idx = np.full((n_shards, max_nf), D, np.int32)
        fslot_of = {}
        for s in range(n_shards):
            for i, g in enumerate(sorted(frontier[s])):
                fr_idx[s, i] = loc_of[g][1]
                fslot_of[g] = s * max_nf + i
        self.frontier_idx = fr_idx

        top_nodes = [g for g in range(t.nleaf, t.nnodes) if own[g] < 0]
        F_tot = n_shards * max_nf
        tslot_of = dict(fslot_of)
        for i, g in enumerate(top_nodes):
            tslot_of[g] = F_tot + i
        self.top_size = F_tot + len(top_nodes) + 1
        self.n_top = len(top_nodes)
        self.top_levels = []
        for ids, k0, k1 in t.levels:
            rows = [(tslot_of[int(g)], tslot_of[int(k0[i])],
                     -1 if k1[i] < 0 else tslot_of[int(k1[i])])
                    for i, g in enumerate(ids) if own[g] < 0]
            if not rows:
                continue
            self.top_levels.append(tuple(
                np.array([r[c] for r in rows], np.int32) for c in range(3)))
        self.root_slot = tslot_of[t.root]
        self._dev = {}

    def _tables(self, device, s):
        """Shard s's local levels (its rows without padding, empty levels
        dropped), frontier slots and the top levels, on `device`."""
        key = (str(device), s)
        if key not in self._dev:
            D = self.loc_size - 1
            local = []
            for lids, lk0, lk1 in self.local_levels:
                sel = lids[s] != D
                if sel.any():
                    local.append(_Lv(lids[s][sel], lk0[s][sel], lk1[s][sel],
                                     device))
            fidx = torch.as_tensor(
                self.frontier_idx[s, :self.n_frontier[s]].astype(np.int64),
                device=device)
            top = [_Lv(*lv, device) for lv in self.top_levels]
            self._dev[key] = (local, fidx, top)
        return self._dev[key]

    # ------------------------------------------------------------------
    def scatter_leaves(self, x, fill=0.0):
        """Global (..., ncells) -> (..., n_shards * B), shard-major leaf
        slots; pad slots get `fill`."""
        out = x[..., torch.as_tensor(self.leaf_idx.reshape(-1),
                                     device=x.device)]
        if fill is not None:
            mask = (np.arange(self.block)[None, :]
                    < self.leaf_count[:, None]).reshape(-1)
            out = torch.where(torch.as_tensor(mask, device=x.device), out,
                              fill)
        return out

    def gather_leaves(self, blocks):
        """Inverse of scatter_leaves (pad slots dropped)."""
        mask = (np.arange(self.block)[None, :]
                < self.leaf_count[:, None]).reshape(-1)
        inv = np.zeros(self.ncells, np.int64)
        inv[self.leaf_idx.reshape(-1)[mask]] = np.nonzero(mask)[0]
        return blocks[..., torch.as_tensor(inv, device=blocks.device)]

    # ------------------------------------------------------------------
    def run(self, comm, rhom, Qm, Qm_min=None, Qm_max=None, Qm_prev=None,
            root_extra=None):
        """This shard's (comm.rank) leaf blocks in leaf_idx order: rhom
        (B,), Qm and the bound / prev channels (nt, B). Pad slots are
        ignored. Returns the (nt, B) leaf masses (pads 0), bitwise equal to
        QLT.run on the assembled global arrays."""
        pt = self.problem_type
        s = comm.rank
        nt = Qm.shape[0]
        local, fidx, top = self._tables(Qm.device, s)
        kw = dict(dtype=Qm.dtype, device=Qm.device)
        conserve = bool(pt & CONSERVE)
        nl = int(self.leaf_count[s])
        rhom, Qm = rhom[..., :nl], Qm[..., :nl]
        if pt & NONNEGATIVE:
            l2r_min = l2r_max = Qm
        elif pt & SHAPEPRESERVE:
            l2r_min, l2r_max = Qm_min[..., :nl], Qm_max[..., :nl]
        else:
            l2r_min, l2r_max = (Qm_min[..., :nl] / rhom,
                                Qm_max[..., :nl] / rhom)
        sum_bounds = bool(pt & (SHAPEPRESERVE | NONNEGATIVE))
        dynamic_range = not sum_bounds

        def space(x, size):
            V = torch.zeros(x.shape[:-1] + (size,), **kw)
            V[..., :x.shape[-1]] = x
            return V

        L = self.loc_size
        W_rho, W_min, W_Qm, W_max = (space(x, L) for x in
                                     (rhom, l2r_min, Qm, l2r_max))
        W_prev = space(Qm_prev[..., :nl], L) if conserve else None

        def l2r(levels, V_rho, V_min, V_Qm, V_max, V_prev):
            summed = [V_rho, V_Qm] + ([V_min, V_max] if sum_bounds else []) \
                + ([V_prev] if conserve else [])
            for lv in levels:
                for V in summed:
                    v1 = torch.where(lv.single, 0.0, V[..., lv.k1s])
                    V.index_copy_(-1, lv.ids, V[..., lv.k0] + v1)
                if not sum_bounds:
                    for V, op in ((V_min, torch.minimum),
                                  (V_max, torch.maximum)):
                        v0 = V[..., lv.k0]
                        V.index_copy_(-1, lv.ids, op(
                            v0, torch.where(lv.single, v0, V[..., lv.k1s])))

        l2r(local, W_rho, W_min, W_Qm, W_max, W_prev)

        # Frontier gather: every shard's frontier values, padded to max_nf.
        ch = [W_rho[None].expand(nt, L), W_min, W_Qm, W_max] \
            + ([W_prev] if conserve else [])
        f = torch.stack([c[:, fidx] for c in ch])             # (C, nt, nf)
        f = torch.nn.functional.pad(f, (0, self.max_nf - f.shape[-1]))
        with trace.span("comm.bfb") as sp:
            g = comm.all_gather(f.contiguous(), dim=2)        # (C, nt, ns, nf)
            if trace.active:
                sp.add(trace.gather_bytes(comm, f))
        g = g.reshape(g.shape[0], nt, -1)
        TS = self.top_size
        T_rho = space(g[0, 0], TS)
        T_min, T_Qm, T_max = (space(g[k], TS) for k in (1, 2, 3))
        T_prev = space(g[4], TS) if conserve else None
        l2r(top, T_rho, T_min, T_Qm, T_max, T_prev)

        root = self.root_slot
        M_root = (T_prev if conserve else T_Qm)[:, root]
        if root_extra is not None:
            M_root = M_root + root_extra
        M_top = torch.zeros((nt, TS), **kw)
        M_top[:, root] = M_root
        if dynamic_range:
            qmin_g = T_min[:, root, None]
            qmax_g = T_max[:, root, None]

        def r2l(levels, M, V_rho, V_min, V_Qm, V_max):
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
                rhom1 = torch.where(lv.single, 1.0,
                                    V_rho[lv.k1s]).expand(shape)
                Qm0, Qm1 = solve_node_problem(
                    pt, V_rho[lv.ids].expand(shape), data(lv.ids), Qm_node,
                    rhom0, data(lv.k0), rhom1, data(lv.k1s), self.prefer)
                M.index_copy_(1, lv.k0, torch.where(lv.single, Qm_node, Qm0))
                M.index_copy_(1, lv.k1_pair, Qm1[:, lv.pair])
            return M

        M_top = r2l(top, M_top, T_rho, T_min, T_Qm, T_max)
        M_loc = torch.zeros((nt, L), **kw)
        nf = fidx.shape[0]
        M_loc[:, fidx] = M_top[:, s * self.max_nf:s * self.max_nf + nf]
        M_loc = r2l(local, M_loc, W_rho, W_min, W_Qm, W_max)
        out = torch.zeros((nt, self.block), **kw)
        out[:, :nl] = M_loc[:, :nl]
        return out
