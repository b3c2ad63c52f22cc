"""CFL-bounded halo exchange for the sharded ISL and IR steps
(compose_tpu.parallel.halo).

The semi-Lagrangian footprint is spatially local, so a shard reads remote
cells only near its boundary. For a cell -> shard map (contiguous blocks,
ragged ones, or the 2-D face tiles of `tile_owner`) the tables here give,
for every shard, the remote cells it may read (its halo: `depth` rings of
its cells, or a measured footprint) and the cells it sends. At run time one
point-to-point exchange per occurring shard offset d (rank s sends to
s + d) moves only those cells, and a static remap turns global source-cell
ids into indices into [local block | halo buffer], so the gather stays
local. The integer tables are built in numpy and equal the JAX package's.
"""

import numpy as np
import torch

from .. import trace
from ..mesh.cubed_sphere import _face_key


def _cell_rings(mesh, depth: int):
    """Per-cell neighbour sets up to `depth` rings (corner adjacency)."""
    ncell = mesh.ncell
    ne = mesh.ne
    f, iy, ix = np.unravel_index(np.arange(ncell), (6, ne, ne))
    gx = np.stack([ix, ix + 1, ix + 1, ix], -1).astype(np.int64)
    gy = np.stack([iy, iy, iy + 1, iy + 1], -1).astype(np.int64)
    keys = np.empty((ncell, 4, 3), np.int64)
    for ff in range(6):
        sel = f == ff
        keys[sel] = _face_key(ff, 2 * gx[sel] - ne, 2 * gy[sel] - ne, ne)
    _, vinv = np.unique(keys.reshape(-1, 3), axis=0, return_inverse=True)
    vinv = vinv.reshape(ncell, 4)
    v2c = {}
    for c in range(ncell):
        for k in range(4):
            v2c.setdefault(vinv[c, k], []).append(c)
    ring = [set([c]) for c in range(ncell)]
    for _ in range(depth):
        new = [set(r) for r in ring]
        for c in range(ncell):
            for c1 in ring[c]:
                for k in range(4):
                    new[c].update(v2c[vinv[c1, k]])
        ring = new
    return ring


def tile_owner(mesh, n_shards: int):
    """2-D face-tile cell -> shard map by recursive coordinate bisection of
    the cell centres on the sphere: split the cell set along its widest
    extent into count-proportional halves, recurse. Regions are compact,
    so halo and DSS volume scale with the tile perimeter."""
    centers = mesh.corners.detach().cpu().double().numpy().mean(axis=1)
    centers = centers / np.linalg.norm(centers, axis=1, keepdims=True)
    out = np.zeros(mesh.ncell, np.int64)

    def bisect(idx, ns, s0):
        if ns == 1:
            out[idx] = s0
            return
        nl = ns // 2
        k = int(round(len(idx) * nl / ns))
        ext = centers[idx].max(0) - centers[idx].min(0)
        ax = int(np.argmax(ext))
        order = idx[np.argsort(centers[idx, ax], kind="stable")]
        bisect(np.sort(order[:k]), nl, s0)
        bisect(np.sort(order[k:]), ns - nl, s0 + nl)

    bisect(np.arange(mesh.ncell), n_shards, 0)
    return out


class HaloMaps:
    """Static send / receive / remap tables for one (mesh, n_shards,
    depth), or explicit per-shard remote-cell `need_sets`.

    Blocks are the per-shard sorted cell lists padded to the largest
    (B cells; contiguous blocks of B = ceil(ncell / n_shards) by default,
    the last one short when ragged); `perm` and `leaf_slot` translate
    between the global and the block layouts. Pad rows are in no ring,
    send or need set and no remap entry resolves to them."""

    def __init__(self, mesh, n_shards: int, depth: int = 2, owner=None,
                 need_sets=None):
        ncell = mesh.ncell
        if owner is None:
            B = -(-ncell // n_shards)
            if (n_shards - 1) * B >= ncell:
                raise ValueError(f"HaloMaps: {ncell} cells leave a shard "
                                 f"of {n_shards} empty")
            owner = np.arange(ncell) // B
        else:
            owner = np.asarray(owner, np.int64)
            counts = np.bincount(owner, minlength=n_shards)
            if owner.shape != (ncell,) or len(counts) != n_shards \
                    or counts.min() < 1:
                raise ValueError("HaloMaps: the owner map must give every "
                                 "cell one of the shards and every shard "
                                 "a cell")
            B = int(counts.max())
        self.owner = owner
        self.n_shards = n_shards
        self.block = B
        self.ncell_pad = n_shards * B
        self.depth = depth
        self.leaf_lists = [np.nonzero(owner == s)[0]
                           for s in range(n_shards)]
        self.leaf_count = np.array([len(l) for l in self.leaf_lists])
        perm = np.zeros((n_shards, B), np.int64)
        leaf_slot = np.zeros(ncell, np.int64)
        for s, leaves in enumerate(self.leaf_lists):
            perm[s, :len(leaves)] = leaves
            perm[s, len(leaves):] = leaves[0]       # inert pad rows
            leaf_slot[leaves] = np.arange(len(leaves))
        self.perm = perm
        self.leaf_slot = leaf_slot
        self.contiguous = bool(
            (owner == np.arange(ncell) // (-(-ncell // n_shards))).all()
            and B == -(-ncell // n_shards))
        if need_sets is not None:
            need = [set(int(c) for c in ns_ if owner[c] != s)
                    for s, ns_ in enumerate(need_sets)]
        else:
            rings = _cell_rings(mesh, depth)
            need = [set() for _ in range(n_shards)]
            for c in range(ncell):
                oc = owner[c]
                for c1 in rings[c]:
                    if owner[c1] != oc:
                        need[oc].add(c1)
        send = [set() for _ in range(n_shards)]
        for s in range(n_shards):
            for c in need[s]:
                send[owner[c]].add(c)

        # One padded boundary block per shard (the all_gather layout, kept
        # for the volume comparison).
        max_send = max(len(s) for s in send)
        self.send_idx = np.zeros((n_shards, max_send), np.int32)
        for s in range(n_shards):
            loc = [leaf_slot[c] for c in sorted(send[s])]
            self.send_idx[s, :len(loc)] = loc
            if max_send - len(loc):
                self.send_idx[s, len(loc):] = loc[0] if loc else 0
        self.max_send = max_send

        # Neighbour-wise exchange: for each ordered shard pair (src, dst)
        # the cells dst needs from src, one message per occurring offset
        # d = dst - src (mod n_shards), padded to that offset's largest.
        pair = {}
        for dst in range(n_shards):
            by_src = {}
            for c in sorted(need[dst]):
                by_src.setdefault(owner[c], []).append(c)
            for src, cells in by_src.items():
                pair[(src, dst)] = cells
        deltas = sorted({(dst - src) % n_shards for (src, dst) in pair})
        self.deltas = deltas
        self.pair_sizes = []
        self.pair_send_idx = []
        for d in deltas:
            size_d = max((len(pair.get((s, (s + d) % n_shards), []))
                          for s in range(n_shards)), default=0)
            tab = np.zeros((n_shards, size_d), np.int32)
            for s in range(n_shards):
                loc = [leaf_slot[c]
                       for c in pair.get((s, (s + d) % n_shards), [])]
                tab[s, :len(loc)] = loc
                if len(loc) < size_d:
                    tab[s, len(loc):] = loc[0] if loc else 0
            self.pair_sizes.append(size_d)
            self.pair_send_idx.append(tab)

        # Remap: global cell id -> index into [local block | halo buffer];
        # the halo buffer is the concatenation over deltas of the cells
        # received from shard s - d, in that sender's sorted order.
        off = {}
        o = 0
        for d, sz in zip(deltas, self.pair_sizes):
            off[d] = o
            o += sz
        self.halo_size = o
        self.remap = np.zeros((n_shards, ncell), np.int32)
        for s in range(n_shards):
            mine = self.leaf_lists[s]
            self.remap[s, mine] = np.arange(len(mine))
            for c in need[s]:
                src = owner[c]
                d = (s - src) % n_shards
                self.remap[s, c] = B + off[d] + pair[(src, s)].index(c)
        self.comm_fraction = self.halo_size / ncell
        self._dev = {}

    def ppermute_tables(self):
        """Per-delta send tables (n_shards, size_d) and the matching
        permutations [(src, dst), ...]."""
        perms = [[(s, (s + d) % self.n_shards) for s in range(self.n_shards)]
                 for d in self.deltas]
        return self.pair_send_idx, perms

    def tables_on(self, device):
        """(per-delta send index tensors, perms, remap tensor) on
        `device`."""
        key = str(device)
        if key not in self._dev:
            tabs, perms = self.ppermute_tables()
            self._dev[key] = (
                [torch.as_tensor(t.astype(np.int64), device=device)
                 for t in tabs], perms,
                torch.as_tensor(self.remap.astype(np.int64), device=device))
        return self._dev[key]

    def bytes_per_exchange(self, nfields: int, np2: int, itemsize: int = 8):
        """Per-shard RECEIVED bytes of one halo exchange of `nfields`
        (ncell, np2) fields."""
        return self.halo_size * np2 * nfields * itemsize

    def coverage_ok(self, ci, d2c_map, np2):
        """Whether every (target cell, node) departure read of a step
        resolves locally or in the halo. ci: (cnn,) source cell per
        continuous node; d2c_map: (ncell * np2,) slot -> node."""
        ci = np.asarray(ci)
        d2c = np.asarray(d2c_map).reshape(-1, np2)
        B = self.block
        tgt_shard = np.repeat(self.owner, np2)
        src = ci[d2c.reshape(-1)]
        rm = self.remap[tgt_shard, src]
        local = self.owner[src] == tgt_shard
        ok_local = rm == self.leaf_slot[src]
        ok_halo = rm >= B
        return bool(np.all(np.where(local, ok_local, ok_halo)))


def measured_need_sets(mesh, owner, ci_list, d2c_map, np2: int,
                       margin_rings: int = 0, n_shards: int = None,
                       base_rings: int = 1):
    """Per-shard remote-cell need sets from measured departure footprints:
    the union over `ci_list` (one (cnn,) source-cell array per step) of the
    foreign cells each shard's nodes read, widened by `margin_rings`, and
    united with the ring-`base_rings` neighbourhood of the shard's cells
    (which balances the per-offset buffer sizes). For HaloMaps(need_sets=);
    coverage_ok stays the per-step guard."""
    owner = np.asarray(owner, np.int64)
    ns = int(owner.max()) + 1 if n_shards is None else n_shards
    d2c = np.asarray(d2c_map).reshape(-1)
    tgt_shard = np.repeat(owner, np2)
    need = [set() for _ in range(ns)]
    for ci in ci_list:
        src = np.asarray(ci)[d2c]
        foreign = owner[src] != tgt_shard
        for s in range(ns):
            need[s].update(
                np.unique(src[foreign & (tgt_shard == s)]).tolist())
    if margin_rings:
        rings = _cell_rings(mesh, margin_rings)
        for s in range(ns):
            ext = set()
            for c in need[s]:
                ext.update(rings[c])
            need[s] = {c for c in ext if owner[c] != s}
    if base_rings:
        rings = _cell_rings(mesh, base_rings)
        for c in range(owner.shape[0]):
            for c1 in rings[c]:
                if owner[c1] != owner[c]:
                    need[owner[c]].add(int(c1))
    return need


class DssSlotExchange:
    """Slot-level exchange tables for the DSS: ship only the foreign
    coincident DGLL slots each shard's nodes read (the facing edge slots of
    its neighbours' boundary cells) instead of whole halo cells.

    tabs[d]: (n_shards, size_d) local flat slot ids each shard sends to
    shard s + deltas[d]; perms[d]: the matching permutation; eslots4:
    (ncell_pad, np2, 4) block-order coincident-slot table indexing
    [local B*np2 slots | received slot halo]; halo_slot_gid: (n_shards,
    halo_slots) the global slot each received position holds (slot 0 where
    padded)."""

    def __init__(self, maps: HaloMaps, slots4, mask_flat, np2):
        n_shards = maps.n_shards
        ncell = maps.owner.shape[0]
        owner_cell = maps.owner
        loc_slot = maps.leaf_slot * np2
        dst_all = np.repeat(owner_cell, np2)[:, None]
        src_all = owner_cell[slots4 // np2]
        foreign = mask_flat & (src_all != dst_all)
        pair_slots = {}
        for dst in range(n_shards):
            rows = np.nonzero(np.repeat(owner_cell, np2) == dst)[0]
            gsl = slots4[rows][foreign[rows]]
            srcs = src_all[rows][foreign[rows]]
            for src in np.unique(srcs):
                pair_slots[(int(src), dst)] = np.unique(gsl[srcs == src])
        sdeltas = sorted({(d_ - s_) % n_shards for (s_, d_) in pair_slots})
        self.deltas = sdeltas
        self.tabs, self.perms = [], []
        off = {}
        o = 0
        for dd in sdeltas:
            size_d = max((len(pair_slots.get((s_, (s_ + dd) % n_shards),
                                             ())) for s_ in range(n_shards)),
                         default=0)
            tab = np.zeros((n_shards, size_d), np.int32)
            for s_ in range(n_shards):
                g = pair_slots.get((s_, (s_ + dd) % n_shards), None)
                if g is not None and len(g):
                    loc = loc_slot[g // np2] + g % np2
                    tab[s_, :len(loc)] = loc
                    if len(loc) < size_d:
                        tab[s_, len(loc):] = loc[0]
            self.tabs.append(tab)
            self.perms.append([(s_, (s_ + dd) % n_shards)
                               for s_ in range(n_shards)])
            off[dd] = o
            o += size_d
        self.halo_slots = o
        B = maps.block
        eslots = np.zeros((n_shards, ncell * np2), np.int64)
        base = loc_slot[np.arange(ncell * np2) // np2] \
            + np.arange(ncell * np2) % np2
        for s_ in range(n_shards):
            eslots[s_] = base
        self.halo_slot_gid = np.zeros((n_shards, o), np.int64)
        for (src, dst), g in pair_slots.items():
            dd = (dst - src) % n_shards
            eslots[dst, g] = B * np2 + off[dd] + np.arange(len(g))
            self.halo_slot_gid[dst, off[dd]:off[dd] + len(g)] = g
        s4r = slots4.reshape(ncell, np2, 4)
        e4 = np.zeros((n_shards, B, np2, 4), np.int32)
        for s_ in range(n_shards):
            e4[s_] = eslots[s_][s4r[maps.perm[s_]]]
        self.eslots4 = e4.reshape(maps.ncell_pad, np2, 4)

    def bytes_per_exchange(self, nfields: int, itemsize: int = 8):
        """Per-shard RECEIVED bytes of one slot-level DSS exchange."""
        return self.halo_slots * nfields * itemsize


def halo_exchange(comm, st, send_tabs, perms):
    """Neighbour-wise halo exchange of this shard's block st (nfields, B,
    np2): returns (nfields, B + halo_size, np2), the block followed by the
    per-delta receive buffers (the layout of HaloMaps.remap). One
    point-to-point round per shard offset; copies only, so results are
    bitwise those of any other layout. send_tabs: per-delta index tensors
    (n_shards, size_d)."""
    parts = [st]
    with trace.span("comm.halo") as sp:
        for tab, perm in zip(send_tabs, perms):
            x = st[:, tab[comm.rank], :].contiguous()
            parts.append(comm.ppermute(x, perm))
            if trace.active:
                sp.add(trace.recv_bytes(comm, x, perm))
    return torch.cat(parts, dim=1)


def halo_interp(comm, maps: HaloMaps, field, ci, w, d2c_map):
    """Departure interpolation and scatter to the DGLL slots with an
    explicit halo exchange, for any owner map.

    comm: a LocalComm of maps.n_shards shards; field (nt, ncell, np2) in
    the global layout; ci (cnn,) the source cell of each continuous node;
    w (cnn, np2) its weights; d2c_map (ncell * np2,) slot -> node. Returns
    the interpolated (nt, ncell, np2) in the global layout: each shard
    computes its own cells' nodes from [its block | halo].

    The JAX package's halo_interp pads the global tail and reshapes the
    global arrays into blocks, which is the block layout of contiguous
    owners only; here every layout goes through maps.perm into block
    order and back."""
    nt, ncell, np2 = field.shape
    dev = field.device
    tabs, perms, remap = maps.tables_on(dev)
    B = maps.block
    perm = torch.as_tensor(maps.perm, device=dev)
    pad = torch.as_tensor(np.arange(B)[None] >= maps.leaf_count[:, None],
                          device=dev)
    d2c = d2c_map.reshape(ncell, np2)

    def body(c):
        s = c.rank
        blk = torch.where(pad[s][None, :, None], 0.0, field[:, perm[s]])
        ext = halo_exchange(c, blk, tabs, perms)
        nodes = d2c[perm[s]].reshape(-1)
        src = ext[:, remap[s][ci[nodes]], :]           # (nt, B*np2, np2)
        vals = torch.sum(src * w[nodes], dim=-1)
        return vals.reshape(nt, B, np2)

    blocks = comm.run(body)
    out = field.new_zeros(field.shape)
    for s, blk in enumerate(blocks):
        n = int(maps.leaf_count[s])
        out[:, torch.as_tensor(maps.leaf_lists[s], device=dev)] = blk[:, :n]
    return out
