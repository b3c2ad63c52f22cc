"""Direct stiffness summation, gather formulation (compose_tpu.transport.dss)
and `dss_q`, the mixing-ratio DSS merge: K3 in f64, K4 in f32.

Fields carry the DGLL slot axis last, (rows, ndgll). A continuous node's
coincident slots (<= 4) are the columns of mesh.c2d_idx, valid where
mesh.c2d_mask. The merge averages them with weights w, falls back to the
static weights F where the merged w is zero, clips to the slots' range, and
writes the result back to every slot. Tracers use w = F * rho
(`dss_q_gather_t`); a density field uses w = F (`dss_gather_t`).

The wrapper takes the plain PyTorch version for a CPU tensor and launches
the CUDA kernel (csrc/dss_q.cu) of the tensors' dtype for a CUDA tensor:
K3 `dss_q_f64`, or K4 `dss_q_f32` on the single-precision route. CUDA
DTensors (the cell-sharded step of parallel/sharding.py) come whole to
each rank, since a node's slots lie in several cells, and the kernel runs
on the local copy (`_native.on_local`).
`_native.KERNELS[name].launches` counts each kernel's launches. Sums run
in the fixed order ((s0 + s1) + s2) + s3 in both. The kernel is
slot-parallel: it reads each slot's node through `slot_table`, a private
slot-major copy of c2d_idx that leaves the public numbering as it is.

`dss_q_slots` is the same merge on any such slot table: a shard of the
sharded steps passes its own slots followed by the halo slots it received
(the rows of w, F and q) and a table over its own slots only (the
outputs); pad rows (all -1) give 0.
"""

import torch

from .. import _native


def _sum4(x):
    return ((x[..., 0] + x[..., 1]) + x[..., 2]) + x[..., 3]


def dss_q_plain(w, F, q, c2d_idx, c2d_mask, d2c_map):
    """w, F: (ndgll,); q: (nt, ndgll); c2d_idx/c2d_mask: (cnn, 4);
    d2c_map: (ndgll,) slot -> node. Returns the merged (nt, ndgll)."""
    vals = torch.where(c2d_mask, q[:, c2d_idx], 0.0)        # (nt, cnn, 4)
    ws = torch.where(c2d_mask, w[c2d_idx], 0.0)             # (cnn, 4)
    fs = torch.where(c2d_mask, F[c2d_idx], 0.0)
    den = _sum4(ws)
    ok = den > 0
    cg = torch.where(ok, _sum4(ws * vals) / torch.where(ok, den, 1.0),
                     _sum4(fs * vals) / _sum4(fs))
    inf = float("inf")
    mn = torch.amin(torch.where(c2d_mask, vals, inf), dim=-1)
    mx = torch.amax(torch.where(c2d_mask, vals, -inf), dim=-1)
    cg = torch.minimum(torch.maximum(cg, mn), mx)
    return cg[:, d2c_map]


def d2c(dg, c2d_idx, c2d_mask, dgbfi):
    """The dgbfi-weighted average of each continuous node's coincident
    slots, clipped to their range: dg (..., ndgll) -> (..., cnn). Plain
    torch ops on any device (the output path's; no kernel)."""
    vals = dg[..., c2d_idx]                                 # (..., cnn, 4)
    w = torch.where(c2d_mask, dgbfi[c2d_idx], 0.0)
    cg = _sum4(w * vals) / _sum4(w)
    inf = float("inf")
    mn = torch.amin(torch.where(c2d_mask, vals, inf), dim=-1)
    mx = torch.amax(torch.where(c2d_mask, vals, -inf), dim=-1)
    return torch.minimum(torch.maximum(cg, mn), mx)


def slot_table(c2d_idx, c2d_mask, d2c_map):
    """The kernel's slot-major table, built once per mesh: row s is the
    c2d_idx row of slot s's node, c2d_idx[d2c_map[s]], as int32 with -1
    where c2d_mask is False. (ndgll, 4), contiguous, on the mesh's
    device."""
    return torch.where(c2d_mask, c2d_idx, -1)[d2c_map].to(
        torch.int32).contiguous()


def dss_q(w, F, q, c2d_idx, c2d_mask, d2c_map, slots=None):
    """K3 (f64) and K4 (f32). Arguments as dss_q_plain. CPU tensors: the
    plain version. CUDA tensors: the kernel of their dtype, one thread per
    DGLL slot looping over tracers. `slots` is slot_table(c2d_idx,
    c2d_mask, d2c_map), built here if not given; a caller that passes it
    (IslTransport, once per mesh) vouches for it and for F, the static
    tables, which are then not checked again."""
    if not q.is_cuda:
        return dss_q_plain(w, F, q, c2d_idx, c2d_mask, d2c_map)
    args = (w, F, q, c2d_idx, c2d_mask, d2c_map, slots)
    if _native.has_dtensor(*args):
        return _native.on_local(dss_q, args)
    nt, ndgll = q.shape
    dt = q.dtype
    if slots is None:
        slots = slot_table(c2d_idx, c2d_mask, d2c_map)
        _native.require(slots, "slots", torch.int32, (ndgll, 4))
        _native.require(F, "F", dt, (ndgll,))
    out = torch.empty_like(q)
    _native.kernel("dss_q", dt)(
        _native.require(w, "w", dt, (ndgll,)), F.data_ptr(),
        _native.require(q, "q", dt, (nt, ndgll)), slots.data_ptr(),
        out.data_ptr(), nt, ndgll, ndgll, stream=_native.stream_of(q))
    return out


def dss_q_slots_plain(w, F, q, slots):
    """The merge over a slot table: w, F (nin,); q (nt, nin); slots
    (nout, 4) int, row s the coincident slots of output slot s's node in
    c2d_idx's column order, -1 where masked. Returns (nt, nout); a row
    that is all -1 gives 0. Per slot the operations of dss_q_plain."""
    m = slots >= 0
    idx = torch.clamp_min(slots, 0).long()
    vals = torch.where(m, q[:, idx], 0.0)                   # (nt, nout, 4)
    ws = torch.where(m, w[idx], 0.0)
    fs = torch.where(m, F[idx], 0.0)
    den = _sum4(ws)
    ok = den > 0
    cg = torch.where(ok, _sum4(ws * vals) / torch.where(ok, den, 1.0),
                     _sum4(fs * vals) / _sum4(fs))
    inf = float("inf")
    mn = torch.amin(torch.where(m, vals, inf), dim=-1)
    mx = torch.amax(torch.where(m, vals, -inf), dim=-1)
    cg = torch.minimum(torch.maximum(cg, mn), mx)
    return torch.where(m[:, 0], cg, 0.0)


def dss_q_slots(w, F, q, slots):
    """K3 (f64) and K4 (f32) over a slot table, arguments as
    dss_q_slots_plain: the rows of w, F and q (nin) may be longer than the
    table (nout). CPU tensors: the plain version. CUDA tensors: the
    kernel; `slots` must then be contiguous int32."""
    if not q.is_cuda:
        return dss_q_slots_plain(w, F, q, slots)
    nt, nin = q.shape
    nout = slots.shape[0]
    dt = q.dtype
    out = q.new_empty((nt, nout))
    _native.kernel("dss_q", dt)(
        _native.require(w, "w", dt, (nin,)),
        _native.require(F, "F", dt, (nin,)),
        _native.require(q, "q", dt, (nt, nin)),
        _native.require(slots, "slots", torch.int32, (nout, 4)),
        out.data_ptr(), nt, nin, nout, stream=_native.stream_of(q))
    return out


def dss_q_gather_t(rho_dg, q_dg, d2c_map, c2d_idx, c2d_mask, dgbfi,
                   slots=None):
    """Mixing-ratio DSS of (nt, ndgll) tracers with weights dgbfi * rho."""
    return dss_q(dgbfi * rho_dg, dgbfi, q_dg, c2d_idx, c2d_mask, d2c_map,
                 slots)


def dss_gather_t(dg, d2c_map, c2d_idx, c2d_mask, dgbfi, slots=None):
    """DSS of (nt, ndgll) fields with the static weights dgbfi, clipped to
    the coincident range."""
    return dss_q(dgbfi, dgbfi, dg, c2d_idx, c2d_mask, d2c_map, slots)
