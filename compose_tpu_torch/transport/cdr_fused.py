"""The tracer-CDR kernels of the ISL step: K1 `glbl_caas` (global CAAS mass
redistribution over cells) and K2 `limit_caas` (cell-local CAAS limiter).

Same module name as the TPU kernels' home (compose_tpu/transport/
cdr_fused.py). The TPU kernels worked on double-float (hi, lo) f32 pairs
because the TPU has no f64; the H100 has native f64, so both kernels and
their plain versions compute in the tensors' own type (f64, or f32 on the
single-precision route) and the pair glue is gone.

Each wrapper takes the plain PyTorch version for a CPU tensor and launches
the CUDA kernel (compose_tpu_torch/csrc) of the tensors' dtype for a CUDA
tensor (`glbl_caas_f64`/`_f32`, `limit_caas_f64`/`_f32`); it never falls
back. `_native.KERNELS[name].launches` counts each kernel's launches.
CUDA DTensors (the cell-sharded step of parallel/sharding.py) reach the
same kernels on each rank's local tensors (`_native.on_local`): K1 reduces
over every cell, so its rows come whole to each rank; K2 is cell-local and
runs on each rank's cells where the operands are evenly sharded on their
cell axis (`limit_caas_placements`).
"""

import functools

import torch

from .. import _native
from ..ops import local_qp
from ..ops.reduce import bfb_sum, next_pow2


# ---------------------------------------------------------------------------
# K1: global CAAS (compose_tpu's spf.glbl_caas_gsum with gsum = bfb_sum).

def glbl_caas_gsum(Q_min, Q_mass, Q_max, extra_mass, gsum):
    """Closed-form global CAAS over the last (cell) axis with a caller's
    global sum `gsum` (bfb_sum on one device; the sharded steps pass the
    distributed BFB allreduce, cdr/bfb.py, which is bitwise equal). Q_*:
    (..., ncell) or a shard's block of it; extra_mass: (...,). Returns
    masses summing to sum(Q_mass) + extra_mass, inside [Q_min, Q_max]
    when feasible."""
    delta = torch.where(Q_mass < Q_min, Q_min - Q_mass,
                        torch.where(Q_mass > Q_max, Q_max - Q_mass, 0.0))
    m = extra_mass - gsum(delta)
    msd = Q_mass + delta
    v_up = torch.where(Q_mass >= Q_max, 0.0, Q_max - msd)
    v_dn = torch.where(Q_mass <= Q_min, 0.0, msd - Q_min)
    v = torch.where((m > 0)[..., None], v_up, v_dn)
    vsum = gsum(v)
    nz = vsum != 0
    fac = torch.where(nz, m / torch.where(nz, vsum, 1.0), 0.0)
    return msd + fac[..., None] * v


def glbl_caas_plain(Q_min, Q_mass, Q_max, extra_mass):
    """K1's plain version: glbl_caas_gsum with bfb_sum."""
    return glbl_caas_gsum(Q_min, Q_mass, Q_max, extra_mass, bfb_sum)


@functools.lru_cache(maxsize=None)
def glbl_caas_geometry(ncell: int):
    """K1's launch geometry for rows of `ncell` cells: (cluster, warps,
    width, chunks, rounds), powers of two whose product is npad, ncell
    rounded up to a power of two. Each row is a cluster of `cluster` blocks
    of `warps` warps; a warp owns `rounds` x `chunks` aligned chunks of
    `width` (<= 32) cells, and keeps them in registers when rounds == 1.
    Chunks fill to 4, warps to 8, then the cluster to 8 blocks (the
    portable cluster size): rows of up to 8192 cells are read once; larger
    rows take more rounds."""
    npad = next_pow2(ncell)
    width = min(32, npad)
    rest = npad // width
    sizes = []
    for cap in (4, 8, 8):             # chunks, warps, cluster
        sizes.append(min(cap, rest))
        rest //= sizes[-1]
    chunks, warps, cluster = sizes
    return cluster, warps, width, chunks, rest


def glbl_caas(Q_min, Q_mass, Q_max, extra_mass):
    """K1. Q_*: (nt, ncell) or (ncell,), f64 or f32; extra_mass: (nt,) or
    scalar. CPU tensors: the plain version. CUDA tensors: the kernel
    (csrc/glbl_caas.cu) of their dtype, bitwise equal to the plain
    version."""
    if not Q_mass.is_cuda:
        return glbl_caas_plain(Q_min, Q_mass, Q_max, extra_mass)
    if _native.has_dtensor(Q_min, Q_mass, Q_max, extra_mass):
        return _native.on_local(glbl_caas,
                                (Q_min, Q_mass, Q_max, extra_mass))
    dt, shape = Q_mass.dtype, Q_mass.shape
    ncell = shape[-1]
    nt = Q_mass.numel() // max(ncell, 1)
    qmin, qmass, qmax = (x.contiguous() for x in (Q_min, Q_mass, Q_max))
    extra = extra_mass
    if not (torch.is_tensor(extra) and extra.is_cuda and extra.dtype == dt
            and extra.numel() == nt and extra.is_contiguous()):
        extra = torch.as_tensor(extra, dtype=dt, device=Q_mass.device)
        extra = extra.expand(shape[:-1]).contiguous()
    out = torch.empty_like(qmass)
    ptrs = [_native.require(x, n, dt, shape) for x, n in
            ((qmin, "Q_min"), (qmass, "Q_mass"), (qmax, "Q_max"))]
    _native.kernel("glbl_caas", dt)(*ptrs, extra.data_ptr(), out.data_ptr(),
                                    nt, ncell, *glbl_caas_geometry(ncell),
                                    stream=_native.stream_of(qmass))
    return out


# ---------------------------------------------------------------------------
# K2: cell-local CAAS limiter (limit_tracer(limiter="caas", precomp, return_q)
# plus the zero-density select of the ISL CDR).

def limit_caas_plain(rhom, rho, Q, q_min, q_max, b):
    """rhom = F*rho, rho: (ncell, np2); Q, q_min, q_max: (nt, ncell, np2);
    b: (nt, ncell) target cell masses. Returns the limited mixing ratios
    (nt, ncell, np2), inside [q_min, q_max]; rho == 0 nodes take q_min.
    Cell sums are adjacent-pair folds, as in the kernel. Zero-density
    nodes get a vanishing but nonzero weight (the solver divides by it)."""
    a = torch.clamp_min(rhom, 1e-300)
    y = Q * (1.0 / torch.where(rho == 0, 1.0, rho))
    x = local_qp.caas(a, b, q_min, q_max, y)
    return torch.where(rho == 0, q_min, x)


def limit_caas_placements(Q):
    """K2's (input placements, output placements) for a DTensor Q (nt,
    ncell, np2): each rank's cells when Q is sharded on its cell axis and
    the ranks divide the cells evenly (so every shard ends on a cell and
    the shards are equal, as DTensor's local wrap assumes), else None:
    every operand whole on each rank."""
    from torch.distributed.tensor import Shard

    mesh = Q.device_mesh
    if (Q.placements == (Shard(1),) and mesh.ndim == 1
            and Q.shape[1] % mesh.size() == 0):
        return [[Shard(0)]] * 2 + [[Shard(1)]] * 4, [Shard(1)]
    return None, None


def limit_caas(rhom, rho, Q, q_min, q_max, b):
    """K2. Shapes as limit_caas_plain, f64 or f32, any np2 from 4 to 256.
    CPU tensors: the plain version. CUDA tensors: the kernel
    (csrc/limit_caas.cu) of their dtype, bitwise equal to the plain
    version."""
    if not Q.is_cuda:
        return limit_caas_plain(rhom, rho, Q, q_min, q_max, b)
    args = (rhom, rho, Q, q_min, q_max, b)
    if _native.has_dtensor(*args):
        # A plain operand is whole on every rank: shard only DTensors.
        sharded = all(_native.has_dtensor(x) for x in args)
        return _native.on_local(limit_caas, args, *(
            limit_caas_placements(Q) if sharded else (None, None)))
    nt, ncell, np2 = Q.shape
    dt = Q.dtype
    # The contiguous operands stay referenced until the launch is queued.
    ops = [x.contiguous() for x in (rhom, rho, Q, q_min, q_max, b)]
    out = torch.empty_like(ops[2])
    args = [_native.require(x, n, dt, s) for x, n, s in zip(
        ops + [out], ("rhom", "rho", "Q", "q_min", "q_max", "b", "out"),
        [(ncell, np2)] * 2 + [Q.shape] * 3 + [(nt, ncell), Q.shape])]
    _native.kernel("limit_caas", dt)(*args, nt, ncell, np2,
                                     stream=_native.stream_of(Q))
    return out
