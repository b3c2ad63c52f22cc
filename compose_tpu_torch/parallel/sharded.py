"""The cell-sharded ISL step: halo exchange, BFB tree reductions, the
sharded QLT, and kernels K2 and K3 on each shard's block
(compose_tpu.parallel.sharded).

Cells are split among the shards of a communicator (parallel/comm.py):
contiguous blocks, ragged ones, or any owner map (halo.tile_owner's 2-D
tiles). Per step and shard the only collectives are

  1. one point-to-point halo exchange of (rho, q) before the departure
     gather (halo.HaloMaps), issued first;
  2. slot-level exchanges of the DSS's foreign coincident slots: rho
     before its DSS, (rho, q) before the tracers' (halo.DssSlotExchange);
  3. the BFB tree sums (cdr/bfb.py), the sharded QLT's frontier gather
     (cdr/qlt_sharded.py), or, for mn2, a gather of the per-cell records
     and the global QP solved on every shard;

every per-cell phase runs on the shard's block. The departure data are
computed for the shard's CGLL nodes only.

Bitwise contract: the interpolation and the rho and tracer CDR are the
single-device step's own phases (transport/isl.py), run on the shard's
block through a cell layout (_ShardCells), so their arithmetic per node
and cell is IslTransport's. The global sums follow
bfb_sum's tree whatever the decomposition, the QLT runs the same tree,
K2 is cell-local, and the DSS merge (K3, dss.dss_q_slots) runs on the
shard's slots followed by the received halo slots, with the coincident
slots in the single device's order. So the sharded step equals
IslTransport.step bitwise. K1 does not run here: its row sums span every
shard, and the global CAAS sums through the BFB allreduce instead
(glbl_caas_gsum), as bitwise equal as K1 is to its plain version.
"""

import numpy as np
import torch

from .. import trace
from ..cdr import qlt as qlt_mod
from ..cdr.bfb import BfbTreeAllReducer, get_reducer
from ..cdr.qlt_sharded import ShardedQLT
from ..transport import dss, spf
from ..transport.cdr_fused import glbl_caas_gsum
from .comm import LocalComm
from .halo import DssSlotExchange, HaloMaps, halo_exchange, measured_need_sets


class _Shard:
    """One shard's static tables on the device."""


class _ShardCells:
    """Shard t's block as the cell layout of the single-device phases
    (transport/isl.MeshCells' interface) for one step on its communicator
    c: the block's tables (F; s2n and jac for ISL, Jt and chol for IR),
    the BFB allreduce over the DGLL slots, the sharded redistribution, the
    slot-exchange DSS, and pad rows zeroed."""

    def __init__(self, sh, c, t):
        self.sh, self.c, self.t = sh, c, t

    def __getattr__(self, name):
        return getattr(self.t, name)

    def gsum(self, x):
        return self.sh.r_slots.allreduce(x, self.c)

    def gsum_cells(self, x):
        return self.gsum(x.reshape(x.shape[:-2] + (-1,)))

    def redistribute(self, rho_mass, Q_min, Q_mass, Q_max, extra):
        return self.sh._redistribute(self.c, self.t, rho_mass, Q_min, Q_mass,
                                     Q_max, extra)

    def dss(self, rows):
        return self.sh._dss(self.c, self.t, rows)

    def zero_pads(self, x):
        return self.sh._zero_pads(self.t, x)


def _slot_exchange(comm, st, tabs, perms):
    """Slot-level DSS exchange: st (C, B*np2) -> (C, B*np2 + H), the
    shard's slots followed by the foreign coincident slots it reads."""
    parts = [st]
    with trace.span("comm.dss_slots") as sp:
        for tab, perm in zip(tabs, perms):
            x = st[:, tab[comm.rank]].contiguous()
            parts.append(comm.ppermute(x, perm))
            if trace.active:
                sp.add(trace.recv_bytes(comm, x, perm))
    return torch.cat(parts, dim=1)


class _Sharded:
    """What the sharded ISL and IR steps share: the communicator, the
    layout (halo maps; per shard its cells, pad rows and its block of the
    mass measure F), the DSS slot tables, the BFB reducer over cells, the
    sharded QLT, and the moves between the global and the block layouts.
    A subclass builds its own per-shard tables and defines
    _body(comm, rho_blk, q_blk, ts, tf) and coverage_ok(ts, tf)."""

    def _setup(self, model, n_shards, comm, maps, F):
        m = model.mesh
        self.model, self.cfg, self.m = model, model.config, m
        self.n_shards = n_shards
        self.comm = LocalComm(n_shards, m.device) if comm is None else comm
        if self.comm.size != n_shards:
            raise ValueError(f"communicator of {self.comm.size} ranks for "
                             f"{n_shards} shards")
        self.maps = mp = maps
        self.B = B = mp.block
        self.pad = mp.ncell_pad - m.ncell
        self.r_cells = self._reducer(1)
        self.sqlt = (ShardedQLT(m.ncell, n_shards,
                                problem_type=qlt_mod.SHAPEPRESERVE,
                                owner=None if mp.contiguous else mp.owner)
                     if self.cfg.filter == "qlt" else None)
        dev, np2 = m.device, m.np2
        d2c = m.dgll2cgll.cpu().numpy().reshape(-1)
        slots4 = m.c2d_idx.cpu().numpy()[d2c]
        mask4 = m.c2d_mask.cpu().numpy()[d2c]
        self.dssx = DssSlotExchange(mp, slots4, mask4, np2)
        self.halo_slots = self.dssx.halo_slots
        self.halo_tabs, self.halo_perms, remap = mp.tables_on(dev)
        self.dss_tabs = [torch.as_tensor(t.astype(np.int64), device=dev)
                         for t in self.dssx.tabs]
        self.dss_perms = self.dssx.perms
        mask4 = mask4.reshape(m.ncell, np2, 4)
        e4 = self.dssx.eslots4.reshape(n_shards, B, np2, 4)
        Ff = F.reshape(-1)
        self.shards = []
        for s in range(n_shards):
            t = _Shard()
            t.n = int(mp.leaf_count[s])
            cells = mp.perm[s]
            pad = np.arange(B) >= t.n
            t.cells = torch.as_tensor(cells, device=dev)
            t.real = torch.as_tensor(mp.leaf_lists[s], device=dev)
            t.padmask = torch.as_tensor(pad, device=dev) if pad.any() \
                else None
            t.remap = remap[s]
            t.F = self._block_table(F, t, 0.0)
            sl = np.where(mask4[cells], e4[s], -1)
            sl[pad] = -1
            t.slots = torch.as_tensor(sl.reshape(-1, 4).astype(np.int32),
                                      device=dev)
            t.F_ext = torch.cat([t.F.reshape(-1), Ff[torch.as_tensor(
                self.dssx.halo_slot_gid[s], device=dev)]])
            self.shards.append(t)
        self._coverage_checked = set()

    def _reducer(self, per_cell):
        """The BFB reducer over the cells (per_cell 1) or the DGLL slots
        (np2) in the block layout."""
        m, mp, B = self.m, self.maps, self.B
        if mp.contiguous:
            return get_reducer(m.ncell * per_cell, self.n_shards,
                               block=B * per_cell)
        return BfbTreeAllReducer(
            m.ncell * per_cell, self.n_shards, block=B * per_cell,
            leaf_lists=[(l[:, None] * per_cell + np.arange(per_cell)[None])
                        .reshape(-1) for l in mp.leaf_lists])

    @staticmethod
    def _block_table(x, t, fill):
        """A shard's block of a per-cell table, `fill` on its pad rows."""
        blk = x[t.cells].clone()
        if t.padmask is not None:
            blk[t.padmask] = fill
        return blk

    def _check_coverage(self, ts, tf):
        key = round(float(tf) - float(ts), 12)
        if key not in self._coverage_checked:
            if not self.coverage_ok(ts, tf):
                raise ValueError(
                    f"{type(self).__name__}: halo depth {self.maps.depth} "
                    f"does not cover the footprint of a dt={key} step; "
                    "increase `depth` or reduce dt")
            self._coverage_checked.add(key)

    def to_block(self, x, s):
        """Shard s's block (..., B, np2) of a global (..., ncell, np2)
        field, pad rows 0."""
        t = self.shards[s]
        return self._zero_pads(t, x[..., t.cells, :])

    def from_blocks(self, blocks, like):
        """The global field from every shard's block."""
        out = like.new_empty(like.shape)
        for t, blk in zip(self.shards, blocks):
            out[..., t.real, :] = blk[..., :t.n, :]
        return out

    @staticmethod
    def _zero_pads(t, x):
        if t.padmask is None:
            return x
        return torch.where(t.padmask[:, None], 0.0, x)

    def step(self, rho, q, ts, tf):
        """One step on global tensors rho (ncell, np2), q (nt, ncell,
        np2); returns the global (rho', q'). Under a DistComm every rank
        passes the global state and gets it back whole."""
        self._check_coverage(ts, tf)
        comm = self.comm
        if isinstance(comm, LocalComm):
            res = comm.run(lambda c: self._body(
                c, self.to_block(rho, c.rank), self.to_block(q, c.rank),
                ts, tf))
        else:
            r = comm.rank
            ro, qo = self._body(comm, self.to_block(rho, r),
                                self.to_block(q, r), ts, tf)
            g_r, g_q = comm.all_gather(ro, 0), comm.all_gather(qo, 0)
            res = [(g_r[s], g_q[s]) for s in range(comm.size)]
        return (self.from_blocks([a for a, _ in res], rho),
                self.from_blocks([b for _, b in res], q))

    def step_blocks(self, rho_blk, q_blk, ts, tf):
        """One step on this rank's blocks (DistComm): rho_blk (B, np2),
        q_blk (nt, B, np2) in block order (to_block), pad rows 0."""
        self._check_coverage(ts, tf)
        return self._body(self.comm, rho_blk, q_blk, ts, tf)

    def _dss(self, c, t, st, weighted=False):
        """The DSS (K3, or K4 in f32) of st (C, B*np2) on the shard's slots
        and the halo slots it receives: weights F, or with `weighted` F
        times row 0 (the density) for the mixing ratios in rows 1.."""
        ext = _slot_exchange(c, st, self.dss_tabs, self.dss_perms)
        if weighted:
            return dss.dss_q_slots(t.F_ext * ext[0], t.F_ext, ext[1:],
                                   t.slots)
        return dss.dss_q_slots(t.F_ext, t.F_ext, ext, t.slots)

    def _redistribute(self, c, t, rho_mass, Q_min, Q_mass, Q_max, extra):
        """spf.MassRedistributor.redistribute on this shard's cells,
        bitwise equal to the single-device call: caas through the BFB
        allreduce, qlt through the sharded QLT, mn2 the global QP on the
        gathered records; pad cells get 0."""
        filt = self.cfg.filter
        if filt == "caas":
            out = glbl_caas_gsum(Q_min, Q_mass, Q_max, extra,
                                 lambda x: self.r_cells.allreduce(x, c))
        elif filt == "qlt":
            squeeze = Q_mass.dim() == 1
            Qm, Qm_min, Qm_max = (torch.atleast_2d(x)
                                  for x in (Q_mass, Q_min, Q_max))
            ex = torch.as_tensor(extra, dtype=Qm.dtype,
                                 device=Qm.device).expand(Qm.shape[:1])
            out = self.sqlt.run(c, rho_mass, Qm, Qm_min, Qm_max,
                                root_extra=ex)
            out = out[0] if squeeze else out
        else:
            # The records of every cell gathered, the global QP solved on
            # every shard (replicated), this shard's cells taken back.
            mp = self.maps
            inv = torch.as_tensor(mp.owner * self.B + mp.leaf_slot,
                                  device=Q_mass.device)

            def gath(v):
                with trace.span("comm.bfb") as sp:
                    g = c.all_gather(v, dim=v.dim() - 1)
                    if trace.active:
                        sp.add(trace.gather_bytes(c, v))
                return g.reshape(v.shape[:-1] + (-1,))[..., inv]

            x = spf.run_mn2(gath(Q_min), gath(Q_mass), gath(Q_max), extra)
            out = x[..., t.cells]
        if t.padmask is not None:
            out = torch.where(t.padmask, 0.0, out)
        return out


def measured_need(model, owner, n_shards: int, step_times,
                  margin_rings: int = 0, base_rings: int = 1):
    """Per-shard remote cells of `model`'s measured departure footprint:
    the departure cells of its (ts, tf) windows `step_times` under the
    cell -> shard map `owner`, united with the ring-`base_rings`
    neighbourhood (halo.measured_need_sets)."""
    m = model.mesh
    ci_list = [model._departure_data(t0, t1)[1].cpu().numpy()
               for (t0, t1) in step_times]
    return measured_need_sets(m, owner, ci_list, model.d2c_map.cpu().numpy(),
                              m.np2, margin_rings, n_shards, base_rings)


class ShardedIsl(_Sharded):
    """Cell-sharded IslTransport step.

    Wraps a single-device IslTransport `model` (its static mesh and basis
    data are reused). Supported: filters caas, qlt, mn2, caas-node and
    none, positive-only; every cell-local limiter; rho_isl on or off; f32
    or f64 geometry and interpolation; timeint exact, line, interp and
    interpline; uniform (and rotated) meshes; f64 or f32. `comm`: a
    LocalComm (default, n_shards shards on the model's device) or a
    DistComm of n_shards ranks. `owner`: a cell -> shard map (default
    contiguous blocks); `depth`: the halo's rings, or `need_sets` the
    per-shard remote cells (see with_measured_halo)."""

    @classmethod
    def with_measured_halo(cls, model, n_shards: int, step_times,
                           owner=None, margin_rings: int = 0,
                           base_rings: int = 1, **kw):
        """A ShardedIsl whose halo is the measured footprint of the run's
        (ts, tf) windows `step_times` united with the ring-`base_rings`
        neighbourhood (measured_need); coverage_ok still guards
        every step size."""
        m = model.mesh
        if owner is None:
            B = -(-m.ncell // n_shards)
            owner = np.arange(m.ncell) // B
        need = measured_need(model, owner, n_shards, step_times,
                             margin_rings, base_rings)
        return cls(model, n_shards, owner=owner, need_sets=need, **kw)

    def __init__(self, model, n_shards: int, depth: int = 2, comm=None,
                 owner=None, need_sets=None):
        m = model.mesh
        if m.nonuni or m.is_subcell:
            raise ValueError("ShardedIsl: uniform meshes only")
        if model.fitext is not None:
            raise ValueError("ShardedIsl: -fitext runs on one device only")
        self._setup(model, n_shards, comm,
                    HaloMaps(m, n_shards, depth, owner=owner,
                             need_sets=need_sets), model.F)
        self.r_slots = self._reducer(m.np2)
        d2c = m.dgll2cgll.cpu().numpy()
        for t in self.shards:
            nodes, s2n = np.unique(d2c[t.cells.cpu().numpy()],
                                   return_inverse=True)
            t.nodes = torch.as_tensor(nodes, device=m.device)
            t.s2n = torch.as_tensor(s2n.reshape(-1), device=m.device)
            t.jac = self._block_table(m.jac_node, t, 1.0)

    def coverage_ok(self, ts, tf):
        """Whether the halo covers this step's departure footprint (a
        single-device departure computation)."""
        _, ci, _ = self.model._departure_data(ts, tf)
        return self.maps.coverage_ok(ci.cpu().numpy(),
                                     self.model.d2c_map.cpu().numpy(),
                                     self.m.np2)

    def bytes_per_step(self, nt: int, itemsize: int = 8):
        """Bytes one shard receives per step: the (rho, q) halo exchange
        and the two DSS slot exchanges (rho; rho and q)."""
        return (self.maps.bytes_per_exchange(nt + 1, self.m.np2, itemsize)
                + self.dssx.bytes_per_exchange(nt + 2, itemsize))

    # ------------------------------------------------------------------
    # The per-shard body: IslTransport's phases on the shard's layout.
    # _interp, _rho_cdr and _tracer_cdr stay methods of their own: the
    # benchmark times each by name (benchmark/harness.py).

    def _interp(self, cells, rho, q, ts, tf):
        """Departure data of the shard's nodes and IslTransport's
        interpolation from [block | halo]: (rho_tgt, q_tgt, each slot's
        source cell in the extended layout, q_ext)."""
        model = self.model
        # Issued first: the exchange needs only the inputs.
        ext = halo_exchange(cells.c, torch.cat([rho[None], q]),
                            self.halo_tabs, self.halo_perms)
        rho_ext, q_ext = ext[0], ext[1:]
        dep, ci, w = model._departure_data(ts, tf, cells.nodes)
        rho_tgt, q_tgt, node_src = model._interp_phase(
            rho, q, dep, cells.remap[ci], w, cells, (rho_ext, q_ext))
        return (cells.zero_pads(rho_tgt), cells.zero_pads(q_tgt), node_src,
                q_ext)

    def _rho_cdr(self, cells, rho, rho_tgt):
        return self.model._rho_cdr(rho, rho_tgt, cells)

    def _tracer_cdr(self, cells, rho, q, rho_tgt, q_tgt, node_src, q_ext):
        return self.model._tracer_cdr(rho, q, rho_tgt, q_tgt, node_src,
                                      cells, q_ext)

    def _body(self, c, rho, q, ts, tf):
        cells = _ShardCells(self, c, self.shards[c.rank])
        with trace.span("isl.step"):
            with trace.span("isl.interp"):
                rho_tgt, q_tgt, node_src, q_ext = self._interp(
                    cells, rho, q, ts, tf)
            with trace.span("isl.rho_cdr"):
                rho_tgt = self._rho_cdr(cells, rho, rho_tgt)
            with trace.span("isl.tracer_cdr"):
                q_new = self._tracer_cdr(cells, rho, q, rho_tgt, q_tgt,
                                         node_src, q_ext)
            with trace.span("isl.dss"):
                nt = q.shape[0]
                st = torch.cat([rho_tgt.reshape(1, -1),
                                q_new.reshape(nt, -1)])
                q_new = self._dss(c, cells.t, st, weighted=True).reshape(
                    q_new.shape)
        return rho_tgt, q_new
