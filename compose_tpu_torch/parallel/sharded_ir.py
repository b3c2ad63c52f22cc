"""The cell-sharded IR/CDG (cell-integrated remap) step
(compose_tpu.parallel.sharded_ir).

IrTransport's step per shard:

  - the (rho, q) source state of the shard's cells and its halo (depth
    rings; a source's candidate ring must lie inside it) moves by the
    point-to-point halo exchange (halo.HaloMaps);
  - the geometry is static, so each shard advects the corner vertices of
    its own source cells (local and halo) itself: elementwise, the same
    bits as the single device's, and no geometry crosses shards;
  - each shard assembles the T blocks of every pair of those sources, in
    global (source, candidate) order, so each source's column sums (p_s_ol
    shares, the facet factor) are complete, and each local target sums
    its pairs in the single device's order (transport/ir.py's
    _TargetTable over the shard's targets);
  - the global CDR sums through the BFB allreduce (caas) or the sharded
    QLT; the limiter runs on the block (K2 for caas); the d2c DSS runs on
    the shard's slots and the received halo slots (K3).

The projection and the CDR are IrTransport's own (_remap_cdr) on the
shard's layout (sharded._ShardCells), so the projection is bitwise equal
to the single device's; so is the full step where the single device's
sums follow the same order.
"""

import numpy as np
import torch

from ..mesh import cubed_sphere
from ..ops import sphere
from ..transport import timeint
from ..transport.ir import _Remap, _TargetTable
from .halo import HaloMaps, halo_exchange
from .sharded import _Sharded, _ShardCells

_DMCS = ("none", "es", "eh", "f", "ef")


class ShardedIr(_Sharded):
    """Cell-sharded IrTransport step. Supported: method ir or cdg; dmc
    none, es, eh, f, ef; filter none, caas or qlt; every cell-local
    limiter; d2c on or off; uniform meshes. (mn2 solves one global QP and
    dmc geh one global equality: single-device paths.) `comm`, `owner`:
    as for ShardedIsl; `depth`: the halo's rings, at least the
    trajectories' CFL plus the candidate ring's 2."""

    def __init__(self, model, n_shards: int, depth: int = 4, comm=None,
                 owner=None):
        cfg, m = model.config, model.mesh
        if cfg.filter not in ("none", "caas", "qlt"):
            raise ValueError(f"ShardedIr: filter {cfg.filter!r}")
        if cfg.dmc not in _DMCS:
            raise ValueError(f"ShardedIr: dmc {cfg.dmc!r}")
        if m.nonuni or m.is_subcell:
            raise ValueError("ShardedIr: uniform meshes only")
        self._setup(model, n_shards, comm,
                    HaloMaps(m, n_shards, depth, owner=owner), model.F_mass)
        mp, ird, dev = self.maps, model.ird, m.device
        self.owner = torch.as_tensor(mp.owner, device=dev)
        self.leaf_slot = torch.as_tensor(mp.leaf_slot, device=dev)
        c2v = ird.cell2vert.cpu().numpy()
        eye = torch.eye(m.np2, dtype=m.dtype, device=dev)
        for s, t in enumerate(self.shards):
            # The sources: local and halo cells in global id order, and
            # where each sits in [block | halo buffer].
            src = np.unique(np.concatenate(
                [mp.leaf_lists[s], np.nonzero(mp.remap[s] >= self.B)[0]]))
            t.src = torch.as_tensor(src, device=dev)
            t.src_pos = torch.as_tensor(mp.remap[s][src].astype(np.int64),
                                        device=dev)
            vids, vmap = np.unique(c2v[src].reshape(-1), return_inverse=True)
            t.vert = ird.vert_xyz[torch.as_tensor(vids, device=dev)]
            t.vmap4 = torch.as_tensor(vmap.reshape(-1, 4), device=dev)
            t.src_corners = m.corners[t.src]
            # The facet transport's one reference factor broadcasts over
            # the cells, as on the single device.
            t.chol = ird.chol_ref[None] if model.facet \
                else self._block_table(ird.chol, t, eye)
            t.Jt = self._block_table(ird.Jt, t, 1.0)

    # ------------------------------------------------------------------
    def coverage_ok(self, ts, tf):
        """Whether every single-device pair with a live overlap candidate
        and a target on shard s has its source among s's sources."""
        model = self.model
        adv = timeint.integrate(model.wind.velocity, ts, tf,
                                model.ird.vert_xyz, self.cfg.nsub)
        ps, pt, pm = (x.cpu().numpy() for x in
                      model._pairs(adv[model.ird.cell2vert]))
        ps, pt = ps[pm], pt[pm]
        ow = self.maps.owner
        for s, t in enumerate(self.shards):
            if not np.isin(ps[ow[pt] == s], t.src.cpu().numpy()).all():
                return False
        return True

    def bytes_per_step(self, nt: int, itemsize: int = 8):
        """Bytes one shard receives per step: the (rho, q) halo exchange
        and, with d2c, the DSS slot exchange of (rho, Q)."""
        n = self.maps.bytes_per_exchange(nt + 1, self.m.np2, itemsize)
        if self.cfg.d2c:
            n += self.dssx.bytes_per_exchange(nt + 1, itemsize)
        return n

    # ------------------------------------------------------------------
    def _remap(self, c, t, ts, tf):
        """This shard's remap data: the _Remap record of the sources with a
        pair onto the shard's cells (their pairs in global (source,
        candidate) order, T blocks, normalized shares and the local
        targets' pair table), and `sel`, those sources' indices into t.src.
        Every pair of a selected source is assembled, so its column sums
        are complete."""
        model, cfg, m = self.model, self.cfg, self.m
        ird = model.ird
        adv_vert = timeint.integrate(model.wind.velocity, ts, tf, t.vert,
                                     cfg.nsub)
        adv_cells = adv_vert[t.vmap4]                       # (E, 4, 3)
        ncand = ird.cands.shape[1]
        ctr = sphere.normalize(torch.mean(adv_cells, dim=1))
        land = cubed_sphere.locate_cell(m, ctr)
        pair_tgt = ird.cands[land]
        pair_mask = ird.cands_mask[land]
        local = pair_mask & (self.owner[pair_tgt] == c.rank)
        sel = torch.nonzero(torch.any(local, dim=1))[:, 0]
        pair_tgt, pair_mask, local = (x[sel].reshape(-1) for x in
                                      (pair_tgt, pair_mask, local))
        adv_cells = adv_cells[sel]
        pair_src = torch.arange(sel.shape[0],
                                device=m.device).repeat_interleave(ncand)
        T, ps_raw = model._assemble_T(adv_cells, pair_src, pair_tgt,
                                      pair_mask,
                                      src_corners=t.src_corners[sel])
        return _Remap(adv_cells=adv_cells, pair_src=pair_src,
                      pair_tgt=pair_tgt, pair_mask=pair_mask, T=T,
                      ps=model._normalize_ps(ps_raw, pair_src),
                      table=_TargetTable(self.leaf_slot[pair_tgt], local,
                                         self.B),
                      src=t.src[sel]), sel

    def _body(self, c, rho, q, ts, tf):
        t = self.shards[c.rank]
        ext = halo_exchange(c, torch.cat([rho[None], q]), self.halo_tabs,
                            self.halo_perms)
        rem, sel = self._remap(c, t, ts, tf)
        ext = ext[:, t.src_pos[sel]]
        rho_tgt, Q_tgt = self.model._remap_cdr(rem, ext[0], ext[1:],
                                               _ShardCells(self, c, t))
        if not self.cfg.d2c:
            return rho_tgt, torch.where(
                rho_tgt[None] == 0, 0.0,
                Q_tgt / torch.where(rho_tgt == 0, 1.0, rho_tgt)[None])
        nt = Q_tgt.shape[0]
        out = self._dss(c, t, torch.cat([rho_tgt.reshape(1, -1),
                                         Q_tgt.reshape(nt, -1)]))
        rho_out = out[0].reshape(rho_tgt.shape)
        Q_out = out[1:].reshape(Q_tgt.shape)
        return rho_out, Q_out / torch.where(rho_out == 0, 1.0, rho_out)[None]


def dryrun_ir_models(device="cuda", ne: int = 4):
    """dryrun_ir's inputs on `device`: (rho, q, dt, [(bar, model)]) with
    rho 1, two tracers, a step of 86400/10 s and its two single-device
    IrTransport configs (ir, dmc es, divergent wind): the projection alone
    (no filter, no d2c; bar 0) and the full step with CDR and DSS
    (caas/caas, d2c; bar 2 ulp, the JAX package's)."""
    from .. import driver
    from ..transport import gallery
    from ..transport.ir import IrConfig, IrTransport

    mesh = cubed_sphere.build(ne, 4, device=device)
    wind = gallery.create_wind("divergent")
    rho = torch.ones((mesh.ncell, mesh.np2), dtype=mesh.dtype,
                     device=mesh.device)
    q = driver.init_tracers(mesh, ("gaussianhills", "cosinebells"))
    eps = float(torch.finfo(mesh.dtype).eps)
    models = [(bar, IrTransport(mesh, wind, IrConfig(
        ne=ne, np_=4, method="ir", dmc="es", nsub=2, **cfg)))
        for bar, cfg in ((0.0, dict(filter="none", limiter="none",
                                    d2c=False)),
                         (2 * eps, dict(filter="caas", limiter="caas",
                                        d2c=True)))]
    return rho, q, 86400.0 / 10, models


def dryrun_ir(n_shards: int, device="cuda", ne: int = 4, comm=None):
    """One sharded IR step of each of dryrun_ir_models' two configs
    against the single-device IrTransport step (the JAX package's
    dryrun_ir): the projection alone bitwise, and the full step with CDR
    and DSS within 2 ulp (the JAX package's bar; the port's is bitwise in
    its tests). `comm`: a LocalComm on `device` (default) or a DistComm of
    n_shards ranks. Raises on a miss; returns the two legs' largest
    differences."""
    rho, q, dt, models = dryrun_ir_models(device, ne)
    diffs = []
    for bar, model in models:
        ref = model.step(rho, q, 0.0, dt)
        out = ShardedIr(model, n_shards, comm=comm).step(rho, q, 0.0, dt)
        d = max(float((a - b).abs().max()) for a, b in zip(out, ref))
        if d > bar:
            raise AssertionError(f"sharded IR ({model.config}): {d} from "
                                 f"the single-device step (bar {bar})")
        diffs.append(d)
    return diffs
