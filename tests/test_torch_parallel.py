"""The port's multi-device building blocks against the JAX package's
(compose_tpu.parallel.halo, compose_tpu.cdr.bfb, compose_tpu.cdr.
qlt_sharded): integer tables equal exactly (numpy, no compile), and under
LocalComm the BFB allreduce and the sharded QLT bitwise equal to the
port's single-device bfb_sum and QLT. Also the two reference faults the
port repairs: a BFB leaf list that does not partition the leaves, and
halo_interp on a tiled owner map."""

import numpy as np
import pytest
import torch

from compose_tpu.cdr import bfb as bfb_jax
from compose_tpu.cdr import qlt_sharded as sq_jax
from compose_tpu.ops.reduce import bfb_sum as bfb_sum_jax
from compose_tpu.parallel import halo as halo_jax
from compose_tpu_torch.cdr import bfb, qlt as qlt_mod, qlt_sharded
from compose_tpu_torch.ops.reduce import bfb_sum
from compose_tpu_torch.parallel import halo
from compose_tpu_torch.parallel.comm import LocalComm

from torch_parity import meshes

# (ne, n_shards, layout): strips (contiguous, ragged where ncell is not a
# multiple) and 2-D tiles.
LAYOUTS = [(3, 2, "strips"), (3, 8, "strips"), (4, 3, "strips"),
           (5, 8, "strips"), (4, 16, "strips"), (6, 16, "strips"),
           (4, 8, "tiles"), (5, 3, "tiles"), (6, 16, "tiles")]


def _owners(mj, mt, ns, layout):
    if layout == "strips":
        return None, None
    oj = halo_jax.tile_owner(mj, ns)
    ot = halo.tile_owner(mt, ns)
    return oj, ot


def _maps_equal(a, b):
    for k in ("owner", "perm", "leaf_slot", "leaf_count", "send_idx",
              "remap"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k), k)
    assert (a.block, a.ncell_pad, a.contiguous, a.deltas, a.pair_sizes,
            a.halo_size, a.max_send) == (b.block, b.ncell_pad,
                                         b.contiguous, b.deltas,
                                         b.pair_sizes, b.halo_size,
                                         b.max_send)
    for x, y in zip(a.pair_send_idx, b.pair_send_idx):
        np.testing.assert_array_equal(x, y)
    assert a.comm_fraction == b.comm_fraction


@pytest.mark.parametrize("ne,ns,layout", LAYOUTS)
def test_halo_tables_equal_jax(ne, ns, layout):
    mj, mt = meshes(ne)
    oj, ot = _owners(mj, mt, ns, layout)
    if oj is not None:
        np.testing.assert_array_equal(oj, ot)
    hj = halo_jax.HaloMaps(mj, ns, depth=2, owner=oj)
    ht = halo.HaloMaps(mt, ns, depth=2, owner=ot)
    _maps_equal(hj, ht)
    # The slot-level DSS exchange.
    d2c = np.asarray(mj.dgll2cgll)
    slots4 = np.asarray(mj.c2d_idx)[d2c.reshape(-1)]
    mask = np.asarray(mj.c2d_mask)[d2c.reshape(-1)]
    dj = halo_jax.DssSlotExchange(hj, slots4, mask, mj.np2)
    dt = halo.DssSlotExchange(ht, slots4, mask, mt.np2)
    assert dj.halo_slots == dt.halo_slots and dj.perms == dt.perms
    np.testing.assert_array_equal(dj.eslots4, dt.eslots4)
    for x, y in zip(dj.tabs, dt.tabs):
        np.testing.assert_array_equal(x, y)
    assert dj.bytes_per_exchange(3) == dt.bytes_per_exchange(3)
    assert hj.bytes_per_exchange(3, 16) == ht.bytes_per_exchange(3, 16)


@pytest.mark.parametrize("ne,ns,layout", [(4, 8, "strips"), (5, 3, "tiles"),
                                          (6, 16, "tiles")])
def test_measured_need_sets_equal_jax(ne, ns, layout):
    mj, mt = meshes(ne)
    oj, _ = _owners(mj, mt, ns, layout)
    owner = oj if oj is not None else np.arange(mj.ncell) // (
        -(-mj.ncell // ns))
    rng = np.random.default_rng(ne * 100 + ns)
    d2c = np.asarray(mj.dgll2cgll).reshape(-1)
    # Departure cells: each node's cell or a neighbour a few ids away.
    cell_of_node = np.zeros(mj.cnn, np.int64)
    cell_of_node[d2c] = np.repeat(np.arange(mj.ncell), mj.np2)
    ci_list = [np.clip(cell_of_node + rng.integers(-2, 3, mj.cnn), 0,
                       mj.ncell - 1) for _ in range(2)]
    for margin, base in ((0, 1), (1, 0), (1, 1)):
        nj = halo_jax.measured_need_sets(mj, owner, ci_list, d2c, mj.np2,
                                         margin, ns, base)
        nt = halo.measured_need_sets(mt, owner, ci_list, d2c, mt.np2,
                                     margin, ns, base)
        assert [set(map(int, a)) for a in nj] == nt
    hj = halo_jax.HaloMaps(mj, ns, owner=owner, need_sets=nj)
    ht = halo.HaloMaps(mt, ns, owner=owner, need_sets=nt)
    _maps_equal(hj, ht)
    assert ht.coverage_ok(ci_list[0], d2c, mt.np2) == hj.coverage_ok(
        ci_list[0], d2c, mj.np2)


def test_flagship_ne30_shards_over_16_and_32():
    # The ne30 mesh (5400 cells) over 16 and 32 shards: the halo maps, the
    # ragged blocks, the sharded QLT and the BFB reducers build, equal to
    # the JAX package's (its test_flagship_ne30_shards_over_16).
    mj, mt = meshes(30)
    for ns in (16, 32):
        hj = halo_jax.HaloMaps(mj, ns, depth=2)
        ht = halo.HaloMaps(mt, ns, depth=2)
        _maps_equal(hj, ht)
        B = -(-5400 // ns)
        assert ht.block == B and ht.ncell_pad == ns * B
        sj, st = sq_jax.ShardedQLT(5400, ns), qlt_sharded.ShardedQLT(5400, ns)
        assert st.block == B and int(st.leaf_count.sum()) == 5400
        assert (sj.root_slot, sj.top_size, sj.loc_size) == (
            st.root_slot, st.top_size, st.loc_size)
        rj = bfb_jax.BfbTreeAllReducer(5400 * 16, ns, block=B * 16)
        rt = bfb.BfbTreeAllReducer(5400 * 16, ns, block=B * 16)
        assert rt.block == B * 16 and rj.plan == rt.plan
        np.testing.assert_array_equal(rj.flat_idx, rt.flat_idx)


# ---------------------------------------------------------------------------
# BFB tree allreduce.

def _leaf_lists(n, ns, seed):
    """A random partition of range(n) into ns sorted non-empty lists with
    runs of consecutive ids."""
    rng = np.random.default_rng(seed)
    owner = np.repeat(rng.integers(0, ns, -(-n // 5)), 5)[:n]
    owner[:ns] = np.arange(ns)
    return [np.nonzero(owner == s)[0] for s in range(ns)]


BFB_CASES = [(1000, 8, None), (1000, 3, None), (96 * 16, 8, None),
             (150 * 16, 8, 19 * 16), (77, 5, None), (300, 7, "lists"),
             (5400, 16, "lists")]


@pytest.mark.parametrize("n,ns,kind", BFB_CASES)
def test_bfb_allreduce_bitwise(n, ns, kind):
    if kind == "lists":
        lists = _leaf_lists(n, ns, n + ns)
        rj = bfb_jax.BfbTreeAllReducer(n, ns, leaf_lists=lists)
        rt = bfb.BfbTreeAllReducer(n, ns, leaf_lists=lists)
        np.testing.assert_array_equal(np.asarray(rj._pos_tab), rt._pos_tab)
    else:
        rj = bfb_jax.BfbTreeAllReducer(n, ns, block=kind)
        rt = bfb.BfbTreeAllReducer(n, ns, block=kind)
        lists = rt.leaf_lists
    # The segment lists and the completion plan equal the JAX package's.
    assert rj.plan == rt.plan and rj.max_nseg == rt.max_nseg
    np.testing.assert_array_equal(rj.flat_idx, rt.flat_idx)
    rng = np.random.default_rng(n)
    x = rng.standard_normal((3, n)) * 10.0 ** rng.integers(-8, 8, (3, n))
    B = rt.block
    blocks = np.zeros((ns, 3, B))
    for s, l in enumerate(lists):
        blocks[s, :, :len(l)] = x[:, l]
        blocks[s, :, len(l):] = 1e300        # pad slots are never read
    xb = torch.tensor(blocks)
    out = LocalComm(ns, "cpu").run(lambda c: rt.allreduce(xb[c.rank], c))
    ref = bfb_sum(torch.tensor(x))
    for o in out:
        assert torch.equal(o, ref)
    assert np.array_equal(ref.numpy(), np.asarray(bfb_sum_jax(x, axis=-1)))
    # The non-BFB form: each shard's bfb_sum, summed in rank order.
    part = LocalComm(ns, "cpu").run(
        lambda c: bfb.allreduce(torch.tensor(x[:, lists[c.rank]]), comm=c))
    want = sum((bfb_sum(torch.tensor(x[:, l])) for l in lists[1:]),
               bfb_sum(torch.tensor(x[:, lists[0]])))
    assert torch.equal(part[0], want)


def test_bfb_leaf_lists_must_partition():
    # JAX's reducer checks only that each list is sorted and unique
    # (bfb.py:85-95): a leaf past n (here 12 of 12 leaves) builds and is
    # summed into the result. The port raises for any list set that is not
    # a partition of range(n).
    n = 12
    outside = [np.arange(0, 6), np.arange(6, 13)]
    rj = bfb_jax.BfbTreeAllReducer(n, 2, leaf_lists=outside)
    assert rj.block == 7
    with pytest.raises(ValueError):
        bfb.BfbTreeAllReducer(n, 2, leaf_lists=outside)
    for bad in ([np.arange(0, 7), np.arange(6, 12)],        # 6 twice
                [np.arange(0, 5), np.arange(6, 12)]):       # 5 missing
        with pytest.raises(ValueError):
            bfb.BfbTreeAllReducer(n, 2, leaf_lists=bad)


# ---------------------------------------------------------------------------
# Sharded QLT.

def _qlt_inputs(ncells, nt, seed):
    rng = np.random.default_rng(seed)
    r = rng.uniform(0.5, 1.0, ncells)
    qmin = rng.uniform(0, .3, (nt, ncells))
    qmax = qmin + rng.uniform(.2, .5, (nt, ncells))
    Qm = (qmin + (qmax - qmin) * rng.uniform(0, 1, (nt, ncells))) * r \
        + 0.3 * rng.standard_normal((nt, ncells)) * r
    prev = Qm + 0.01 * rng.standard_normal((nt, ncells))
    extra = 0.01 * rng.standard_normal(nt)
    return [torch.tensor(a) for a in (r, Qm, qmin * r, qmax * r, prev,
                                      extra)]


@pytest.mark.parametrize("ncells,ns,owner", [(96, 2, None), (96, 8, None),
                                             (108, 4, None),
                                             (111, 8, "random")])
def test_sharded_qlt_tables_and_bitwise(ncells, ns, owner):
    if owner == "random":
        owner = np.random.default_rng(ncells).integers(0, ns, ncells)
        owner[:ns] = np.arange(ns)
    sj = sq_jax.ShardedQLT(ncells, ns, owner=owner)
    st = qlt_sharded.ShardedQLT(ncells, ns, owner=owner)
    # The level schedules equal the JAX package's.
    for k in ("leaf_idx", "leaf_count", "frontier_idx"):
        np.testing.assert_array_equal(np.asarray(getattr(sj, k)),
                                      getattr(st, k), k)
    assert (sj.loc_size, sj.top_size, sj.root_slot, sj.max_nf, sj.n_top) \
        == (st.loc_size, st.top_size, st.root_slot, st.max_nf, st.n_top)
    for lj, lt in ((sj.local_levels, st.local_levels),
                   (sj.top_levels, st.top_levels)):
        assert len(lj) == len(lt)
        for a, b in zip(lj, lt):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(np.asarray(x), y)
    # Bitwise equal to the single-device QLT, per problem type.
    rhom, Qm, Qmin, Qmax, prev, extra = _qlt_inputs(ncells, 3, ncells + ns)
    comm = LocalComm(ns, "cpu")
    for pt, kw in ((qlt_mod.SHAPEPRESERVE, dict(root_extra=extra)),
                   (qlt_mod.SHAPEPRESERVE | qlt_mod.CONSERVE, {}),
                   (qlt_mod.NONNEGATIVE, {}),
                   (qlt_mod.CONSISTENT, {})):
        ref = qlt_mod.QLT(ncells, pt).run(rhom, Qm, Qmin, Qmax, prev, **kw)
        sh = qlt_sharded.ShardedQLT(ncells, ns, problem_type=pt, owner=owner)
        blk = [sh.scatter_leaves(x).reshape(x.shape[:-1] + (ns, -1))
               for x in (rhom, Qm, Qmin, Qmax, prev)]
        blk[0] = sh.scatter_leaves(rhom, fill=1.0).reshape(ns, -1)
        out = comm.run(lambda c: sh.run(
            c, blk[0][c.rank], *(b[:, c.rank] for b in blk[1:]), **kw))
        got = sh.gather_leaves(torch.cat(out, dim=-1))
        assert torch.equal(got, ref), pt


# ---------------------------------------------------------------------------
# LocalComm and the halo exchange.

def test_local_comm_collectives():
    comm = LocalComm(4, "cpu")
    perm = [(s, (s + 1) % 4) for s in range(4)]

    def fn(c):
        x = torch.full((2,), float(c.rank))
        return (c.ppermute(x, perm), c.ppermute(x, [(0, 2)]),
                c.all_gather(x, dim=1), c.sum(x))

    out = comm.run(fn)
    for r, (p, p02, g, s) in enumerate(out):
        assert torch.equal(p, torch.full((2,), float((r - 1) % 4)))
        assert torch.equal(p02, torch.full((2,), 0.0))
        assert torch.equal(g, torch.arange(4.0).expand(2, 4))
        assert torch.equal(s, torch.full((2,), 6.0))

    def bad(c):
        c.all_gather(torch.zeros(1))
        if c.rank == 2:
            raise KeyError("shard 2")
        return c.all_gather(torch.zeros(1))

    with pytest.raises(KeyError):
        comm.run(bad)


def test_local_comm_under_thread_switching(monkeypatch):
    # More shards than cores, the interpreter switching threads as often as
    # it can: every collective delivers every shard's value of that round,
    # and the launch counter the shards share loses no update.
    import sys
    from compose_tpu_torch import _native

    class NoKernels:
        def __getattr__(self, name):
            return lambda *args: 0

    monkeypatch.setattr(_native, "lib", NoKernels)
    k = _native.Kernel("dss_q_f64")
    n, rounds = 16, 100
    want = torch.arange(n, dtype=torch.float64) * rounds

    def fn(c):
        for i in range(rounds):
            k(stream=None)
            got = c.all_gather(torch.tensor([c.rank * rounds + i],
                                            dtype=torch.float64))
            if not torch.equal(got[:, 0], want + i):
                return False
        return True

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        assert LocalComm(n, "cpu").run(fn) == [True] * n
    finally:
        sys.setswitchinterval(old)
    assert k.launches == n * rounds


@pytest.mark.parametrize("layout", ["strips", "tiles"])
def test_halo_interp_any_owner_map(layout):
    # The departure interpolation through the halo exchange equals the
    # global gather bitwise for strips and for a tiled owner map. The JAX
    # package's halo_interp pads the global tail and reshapes the global
    # arrays into blocks (halo.py:430-438), the block layout of contiguous
    # owners only: with tiles it reads other shards' cells as its own.
    from compose_tpu_torch.transport import gallery
    from compose_tpu_torch.transport.isl import IslConfig, IslTransport

    ne, ns = 6, 8
    _, mt = meshes(ne)
    owner = halo.tile_owner(mt, ns) if layout == "tiles" else None
    model = IslTransport(mt, gallery.create_wind("divergent"),
                         IslConfig(ne=ne, nsub=2))
    _, ci, w = model._departure_data(0.0, 86400.0 * 12 / 120)
    rng = np.random.default_rng(7)
    field = torch.tensor(rng.uniform(0, 1, (3, mt.ncell, mt.np2)))
    maps = halo.HaloMaps(mt, ns, depth=2, owner=owner)
    assert maps.coverage_ok(ci.numpy(), model.d2c_map.numpy(), mt.np2)
    out = halo.halo_interp(LocalComm(ns, "cpu"), maps, field, ci, w,
                           model.d2c_map)
    ref = torch.sum(field[:, ci, :] * w, dim=-1)[:, model.d2c_map].reshape(
        field.shape)
    assert torch.equal(out, ref)
