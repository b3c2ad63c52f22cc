"""Reduction-tree topology for QLT (compose_tpu.cdr.tree).

The tree lives in flat index arrays: nodes are numbered leaves-first, every
internal node lists its two kids, and nodes are grouped into levels (level =
max(kid levels) + 1). An odd node is promoted to the next level through a
single-kid node (kid1 = -1). The tree depends only on the global cell
numbering, which keeps QLT decomposition-invariant. The level tables are
numpy int32 arrays, equal to the JAX package's; QLT moves them to its
device.
"""

import dataclasses
import functools
import sys

import numpy as np


@dataclasses.dataclass(frozen=True)
class Tree:
    """Flat binary-ish reduction tree over nleaf leaves.

    Node ids: 0..nleaf-1 are leaves; internal nodes follow. `levels` holds
    one (nodes, kids0, kids1) triple of int32 arrays per level, leaves up;
    kids1 may be -1 (single-kid pass-through). The last node is the root.
    """
    nleaf: int
    nnodes: int
    levels: tuple

    @property
    def root(self):
        return self.nnodes - 1


@functools.lru_cache(maxsize=None)
def build(nleaf: int, imbalanced: bool = False) -> Tree:
    """Reduction tree over `nleaf` leaves: adjacent nodes paired level by
    level, or (imbalanced) the reference's recursive 1/3-2/3 split."""
    if imbalanced:
        return _build_imbalanced(nleaf)
    levels = []
    cur = np.arange(nleaf, dtype=np.int32)
    next_id = nleaf
    while len(cur) > 1:
        n_pairs = len(cur) // 2
        k0 = cur[0:2 * n_pairs:2]
        k1 = cur[1:2 * n_pairs:2]
        ids = np.arange(next_id, next_id + n_pairs, dtype=np.int32)
        next_id += n_pairs
        if len(cur) % 2 == 1:
            ids = np.concatenate([ids, np.int32([next_id])])
            k0 = np.concatenate([k0, cur[-1:]])
            k1 = np.concatenate([k1, np.int32([-1])])
            next_id += 1
        levels.append((ids, k0, k1))
        cur = ids
    return Tree(nleaf=nleaf, nnodes=int(next_id), levels=tuple(levels))


def _build_imbalanced(nleaf: int) -> Tree:
    kids = {}
    counter = [nleaf]

    def rec(lo, hi):
        if hi - lo == 1:
            return lo, 0
        nl = max(1, (hi - lo) // 3)
        left, dl = rec(lo, lo + nl)
        right, dr = rec(lo + nl, hi)
        nid = counter[0]
        counter[0] += 1
        lvl = 1 + max(dl, dr)
        kids[nid] = (left, right, lvl)
        return nid, lvl

    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 4 * nleaf + 100))
    try:
        root, depth = rec(0, nleaf)
    finally:
        sys.setrecursionlimit(old)
    nnodes = counter[0]
    by_level = {}
    for nid, (k0, k1, lvl) in kids.items():
        by_level.setdefault(lvl, []).append((nid, k0, k1))
    levels = []
    for lvl in range(1, depth + 1):
        rows = sorted(by_level.get(lvl, []))
        if rows:
            levels.append(tuple(np.array([r[i] for r in rows], dtype=np.int32)
                                for i in range(3)))
    if root != nnodes - 1:
        # Tree.root is the last id: swap root <-> nnodes - 1 everywhere.
        def fix(a):
            a = a.copy()
            a[a == root] = -2
            a[a == nnodes - 1] = root
            a[a == -2] = nnodes - 1
            return a
        levels = [(fix(i), fix(j), np.where(k == -1, -1, fix(k)).astype(
            np.int32)) for i, j, k in levels]
    return Tree(nleaf=nleaf, nnodes=nnodes, levels=tuple(levels))
