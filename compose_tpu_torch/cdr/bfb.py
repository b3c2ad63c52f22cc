"""Bit-for-bit (BFB) tree allreduce (compose_tpu.cdr.bfb).

A distributed sum whose order is fixed by the adjacent-pair binary tree
over the GLOBAL leaf space, so the result is bitwise equal to
ops.reduce.bfb_sum on the assembled array whatever the decomposition. Each
shard's leaves decompose into maximal aligned subtrees of the global tree;
the shard folds each subtree exactly as the global fold would (its
partials are interior node values of the global tree), one all_gather
ships every shard's partials everywhere, and a static plan performs the
remaining adds of the global fold, in the same association, on every
shard. Communication is O(n_shards log n) scalars per reduced row.
"""

import functools

import numpy as np
import torch

from .. import trace
from ..ops.reduce import bfb_sum, next_pow2


def _aligned_segments(lo: int, hi: int):
    """Decompose [lo, hi) into maximal subtree-aligned segments of the
    adjacent-pair tree: each segment is [p*2^j, (p+1)*2^j) with maximal j.
    Returns [(level j, pos p)] in left-to-right order."""
    segs = []
    while lo < hi:
        j = (lo & -lo).bit_length() - 1 if lo else (hi - 1).bit_length()
        while (1 << j) > hi - lo:
            j -= 1
        segs.append((j, lo >> j))
        lo += 1 << j
    return segs


def _pyramid(w):
    """Every level of the adjacent-pair fold of w (length a power of two),
    concatenated leaves first."""
    levels = [w]
    while w.shape[-1] > 1:
        y = w.reshape(w.shape[:-1] + (w.shape[-1] // 2, 2))
        w = y[..., 0] + y[..., 1]
        levels.append(w)
    return torch.cat(levels, dim=-1)


class BfbTreeAllReducer:
    """Distributed completion of bfb_sum over n leaves split among n_shards
    shards: contiguous blocks of `block` leaves (default ceil(n /
    n_shards); ragged when n is not a multiple, the last block's tail
    being padding), or scattered sorted `leaf_lists` (a partition of
    range(n)), each shard's block then being its list padded to `block`.
    Pad slots are never read."""

    def __init__(self, n: int, n_shards: int, block: int = None,
                 leaf_lists=None):
        self.n = n
        self.n_shards = n_shards
        P = next_pow2(n)
        self.P = P
        m = P.bit_length() - 1
        if leaf_lists is None:
            B = -(-n // n_shards) if block is None else block
            self.block = B
            if not (n_shards - 1) * B < n <= n_shards * B <= P:
                raise ValueError(f"BfbTreeAllReducer: {n_shards} blocks of "
                                 f"{B} do not tile {n} leaves")
            seg_lists = [_aligned_segments(s * B, min((s + 1) * B, n))
                         for s in range(n_shards)]
            self._pos_tab = None
            self.leaf_lists = [np.arange(s * B, min((s + 1) * B, n))
                               for s in range(n_shards)]
        else:
            if len(leaf_lists) != n_shards:
                raise ValueError("BfbTreeAllReducer: one leaf list per shard")
            leaf_lists = [np.asarray(l, np.int64) for l in leaf_lists]
            # The leaf lists must partition [0, n): a leaf held twice would
            # be summed twice, a missing one dropped, and the plan's
            # sibling check would not see it.
            allv = np.sort(np.concatenate(leaf_lists))
            if not np.array_equal(allv, np.arange(n)):
                raise ValueError("BfbTreeAllReducer: leaf_lists must "
                                 "partition range(n)")
            B = max(len(l) for l in leaf_lists) if block is None else block
            self.block = B
            seg_lists = []
            pos_tab = np.full((n_shards, B), P, np.int32)  # P = drop slot
            for s, leaves in enumerate(leaf_lists):
                if not (1 <= len(leaves) <= B
                        and (np.diff(leaves) > 0).all()):
                    raise ValueError("BfbTreeAllReducer: each leaf list "
                                     "must be sorted, non-empty and fit "
                                     "the block")
                pos_tab[s, :len(leaves)] = leaves
                brk = np.nonzero(np.diff(leaves) != 1)[0] + 1
                segs = []
                for run in np.split(leaves, brk):
                    segs.extend(_aligned_segments(int(run[0]),
                                                  int(run[-1]) + 1))
                seg_lists.append(segs)
            self._pos_tab = pos_tab
            self.leaf_lists = leaf_lists
        self.seg_lists = seg_lists
        self.max_nseg = max(len(s) for s in seg_lists)
        offsets = []
        off = 0
        for j in range(m + 1):
            offsets.append(off)
            off += P >> j
        # flat_idx[s, i]: shard s's i-th segment partial in the global
        # pyramid layout (levels j = 0..m concatenated; pads point at 0).
        self.flat_idx = np.zeros((n_shards, self.max_nseg), np.int32)
        node_src = {}
        for s, segs in enumerate(seg_lists):
            for i, (j, p) in enumerate(segs):
                self.flat_idx[s, i] = offsets[j] + p
                node_src[(j, p)] = (s, i)
        # Completion plan: the remaining adds of the global fold, bottom-up,
        # (dst, left, right) with None for an all-padding subtree (added as
        # a literal 0.0, as bfb_sum's zero padding is).
        self.plan = []
        nodes = dict(node_src)
        for j in range(m):
            level = sorted(p for (jj, p) in nodes if jj == j)
            done = set()
            for p in level:
                if p in done:
                    continue
                sib = p ^ 1
                done.update((p, sib))
                a = nodes.pop((j, p))
                b = nodes.pop((j, sib), None)
                if b is None:
                    assert sib * (1 << j) >= n, (j, p, sib, n)
                left, right = (a, b) if p % 2 == 0 else (b, a)
                key = ("node", j + 1, p >> 1)
                nodes[(j + 1, p >> 1)] = key
                self.plan.append((key, left, right))
        assert list(nodes) == [(m, 0)], nodes
        self._root_key = nodes[(m, 0)]
        self._compile()
        self._dev = {}

    def _compile(self):
        """The plan as level-batched gathers over one value buffer: the
        gathered partials (shard-major), a zero, then each level's sums."""
        S = self.n_shards * self.max_nseg
        slot = {(s, i): s * self.max_nseg + i
                for s in range(self.n_shards) for i in range(self.max_nseg)}
        slot[None] = S
        nxt = S + 1
        waves = {}
        for dst, a, b in self.plan:
            waves.setdefault(dst[1], []).append((dst, a, b))
        self.waves = []
        for lvl in sorted(waves):
            ops = waves[lvl]
            for k, (dst, _, _) in enumerate(ops):
                slot[dst] = nxt + k
            nxt += len(ops)
            self.waves.append((np.array([slot[a] for _, a, _ in ops]),
                               np.array([slot[b] for _, _, b in ops])))
        self.root_slot = slot[self._root_key]

        # Per shard: the window its block is placed in for the local fold,
        # chosen so every segment stays aligned (global position g sits at
        # g - base), and each segment partial's index in its pyramid.
        self.windows = []
        for s in range(self.n_shards):
            leaves = self.leaf_lists[s]
            if self._pos_tab is None:
                lo, hi = int(leaves[0]), int(leaves[-1]) + 1
                W = next_pow2(2 * (hi - lo)) if hi - lo > 1 else 1
                while lo // W != (hi - 1) // W:
                    W *= 2
                base = lo - lo % W
            else:
                W, base = self.P, 0
            offs, off = [], 0
            w = W
            while w >= 1:
                offs.append(off)
                off += w
                w //= 2
            idx = np.zeros(self.max_nseg, np.int64)
            for i, (j, p) in enumerate(self.seg_lists[s]):
                idx[i] = offs[j] + ((p << j) - base) // (1 << j)
            self.windows.append((W, leaves - base, idx,
                                 np.arange(len(self.seg_lists[s]))))

    def _tables(self, device):
        key = str(device)
        if key not in self._dev:
            def t(a):
                return torch.as_tensor(a, dtype=torch.int64, device=device)
            self._dev[key] = (
                [(W, t(pos), t(idx[:len(real)]))
                 for W, pos, idx, real in self.windows],
                [(t(a), t(b)) for a, b in self.waves])
        return self._dev[key]

    # ------------------------------------------------------------------
    def local_partials(self, x_block, shard_index: int):
        """This shard's aligned-subtree partials (..., max_nseg) of its
        block x_block (..., block); pad slots are ignored, unused partial
        slots hold 0."""
        assert x_block.shape[-1] == self.block, (x_block.shape, self.block)
        wins, _ = self._tables(x_block.device)
        W, pos, idx = wins[shard_index]
        nreal = pos.shape[0]
        w = x_block.new_zeros(x_block.shape[:-1] + (W,))
        w[..., pos] = x_block[..., :nreal]
        part = _pyramid(w)[..., idx]
        if part.shape[-1] < self.max_nseg:
            part = torch.nn.functional.pad(
                part, (0, self.max_nseg - part.shape[-1]))
        return part

    def complete(self, gathered):
        """Run the completion plan on gathered partials (..., n_shards,
        max_nseg); returns the root sum (...,), identical on every shard."""
        _, waves = self._tables(gathered.device)
        V = torch.cat([gathered.reshape(gathered.shape[:-2] + (-1,)),
                       gathered.new_zeros(gathered.shape[:-2] + (1,))],
                      dim=-1)
        for a, b in waves:
            V = torch.cat([V, V[..., a] + V[..., b]], dim=-1)
        return V[..., self.root_slot]

    def allreduce(self, x_block, comm):
        """The global tree sum over the last axis of the block this shard
        (comm.rank) holds, bitwise equal to bfb_sum of the global array."""
        with trace.span("comm.bfb") as sp:
            part = self.local_partials(x_block, comm.rank)
            if trace.active:
                sp.add(trace.gather_bytes(comm, part))
            return self.complete(comm.all_gather(part, dim=part.dim() - 1))


@functools.lru_cache(maxsize=None)
def get_reducer(n: int, n_shards: int,
                block: int = None) -> BfbTreeAllReducer:
    return BfbTreeAllReducer(n, n_shards, block)


def allreduce(x, dim: int = -1, comm=None):
    """Fixed-tree sum along `dim`. Without a communicator this is bfb_sum;
    with one, each shard's bfb_sum is summed over the ranks in rank order
    (not decomposition-invariant: use BfbTreeAllReducer.allreduce for
    that)."""
    s = bfb_sum(x, dim=dim)
    if comm is not None:
        s = comm.sum(s)
    return s
