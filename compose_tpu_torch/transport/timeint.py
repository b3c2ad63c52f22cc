"""Trajectory (departure point) integration (compose_tpu.transport.timeint):
all nodes in lockstep with `nsub` fixed Dormand-Prince RK5(4) substeps, in
cartesian xyz, then normalized back onto the sphere; the 2-evaluation
midpoint study integrator (`integrate_line`); and the interpolation of a
coarse velocity grid's departure points to the fine nodes
(`interp_departure`).

`integrate` takes the CUDA kernel csrc/dopri5.cu (`dopri5`) for a wind
with a native form (gallery's `native`) on CUDA points, and the eager
chain `integrate_plain` for CPU points and every other wind. The kernel
runs on a contiguous (N, 3) copy of the points, and gives the eager
chain's bits on that copy (the chain's last sum, in sphere.normalize, adds
a strided row in another order than a contiguous one). CUDA DTensors reach
it through `_native.on_local`. The program's trace counters
`trajectory.kernel` and `trajectory.eager` count the calls of each.
"""

import functools

import numpy as np
import torch

from .. import _native, constants, trace
from ..config import np_scalar
from ..ops import sphere
from . import gallery

# Dormand-Prince 5(4) tableau (the reference's ark45).
_C = (0.0, 1.0 / 5, 3.0 / 10, 4.0 / 5, 8.0 / 9, 1.0, 1.0)
_A = (
    (),
    (1.0 / 5,),
    (3.0 / 40, 9.0 / 40),
    (44.0 / 45, -56.0 / 15, 32.0 / 9),
    (19372.0 / 6561, -25360.0 / 2187, 64448.0 / 6561, -212.0 / 729),
    (9017.0 / 3168, -355.0 / 33, 46732.0 / 5247, 49.0 / 176,
     -5103.0 / 18656),
    (35.0 / 384, 0.0, 500.0 / 1113, 125.0 / 192, -2187.0 / 6784,
     11.0 / 84),
)
_B5 = (35.0 / 384, 0.0, 500.0 / 1113, 125.0 / 192, -2187.0 / 6784,
       11.0 / 84, 0.0)


def _dopri5_step(velocity, t0, dt, p):
    # The step coefficients dt*a are rounded in the position dtype, as in
    # the JAX package (an f32 pipeline is not promoted back to f64).
    s = np_scalar(p.dtype)
    dtl = s(dt)
    ks = []
    for i in range(7):
        pi = p
        for j, a in enumerate(_A[i]):
            pi = pi + float(s(dtl * s(a))) * ks[j]
        ks.append(velocity(t0 + _C[i] * dt, pi))
    out = p
    for b, k in zip(_B5, ks):
        if b != 0.0:
            out = out + float(s(dtl * s(b))) * k
    return out


def integrate(velocity, ts: float, tf: float, p, nsub: int = 8):
    """Integrate dp/dt = velocity(t, p) from ts to tf (tf < ts integrates
    backward, as for ISL departure points). p: (..., 3). The kernel for a
    wind with a native form on CUDA points, else the eager chain."""
    wind = getattr(velocity, "__self__", None)
    if getattr(wind, "native", None) is None or not p.is_cuda:
        trace.count("trajectory.eager")
        return integrate_plain(velocity, ts, tf, p, nsub)
    if _native.has_dtensor(p):
        return _native.on_local(
            functools.partial(integrate, velocity, ts, tf, nsub=nsub), (p,),
            *_local_placements(p))
    trace.count("trajectory.kernel")
    return dopri5(wind, ts, tf, p.reshape(-1, 3).contiguous(),
                  nsub).reshape(p.shape)


def _local_placements(p):
    """on_local's (input, output) placements for a DTensor p (..., 3):
    p's own where every rank holds whole points and an equal share of
    them, else None (the points whole on each rank)."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = p.device_mesh
    even = mesh.ndim == 1 and all(
        isinstance(x, Replicate)
        or (isinstance(x, Shard) and x.dim % p.ndim != p.ndim - 1
            and p.shape[x.dim] % mesh.size() == 0) for x in p.placements)
    if even:
        return [list(p.placements)], list(p.placements)
    return None, None


def integrate_plain(velocity, ts: float, tf: float, p, nsub: int = 8):
    """`integrate` as the eager chain of PyTorch ops, for any wind and
    device: the kernel's plain version."""
    dt = (tf - ts) / nsub
    for i in range(nsub):
        p = _dopri5_step(velocity, ts + i * dt, dt, p)
    return sphere.normalize(p)


_LAUNCH_SUBSTEPS = 8        # csrc/dopri5.cu's kSub


def dopri5_table(wind, ts: float, tf: float, dtype, nsub: int):
    """The time-only scalars of integrate_plain(wind.velocity, ts, tf, p,
    nsub) for points of `dtype`, rounded as the eager chain rounds them and
    held in float64: (head, trig). head: wind.vscale / T, 1 / T and 2 pi
    (cast to `dtype`), 1 / R (divided in `dtype`, as PyTorch divides by a
    scalar), then dt a_ij for the 21 a_ij of _A row by row and dt b_j for
    the 7 of _B5. trig (nsub, 7, 3): per substep and stage, time_trig at
    the stage's time."""
    s = np_scalar(dtype)
    T = wind.T
    dt = (tf - ts) / nsub
    dtl = s(dt)
    head = [s(wind.vscale / T), s(1 / T), s(2 * np.pi),
            s(1.0) / s(constants.earth_radius_m)]
    head += [s(dtl * s(a)) for row in _A for a in row]
    head += [s(dtl * s(b)) for b in _B5]
    trig = [gallery.time_trig(ts + i * dt + c * dt, T, dtype)
            for i in range(nsub) for c in _C]
    return (np.array(head, dtype=np.float64),
            np.array(trig, dtype=np.float64).reshape(nsub, len(_C), 3))


def dopri5(wind, ts: float, tf: float, p, nsub: int = 8):
    """The kernel csrc/dopri5.cu: integrate_plain(wind.velocity, ts, tf, p,
    nsub), bitwise, for a wind with a native form and a contiguous CUDA
    tensor p (N, 3) of f64 or f32. One launch per 8 substeps, on the
    current stream; the last normalizes."""
    code = getattr(wind, "native", None)
    if code is None:
        raise ValueError(f"dopri5: {type(wind).__name__} has no native form")
    kernel = _native.kernel("dopri5", p.dtype)
    if p.dim() != 2 or p.shape[1] != 3:
        raise ValueError(f"dopri5: expected points (N, 3), got "
                         f"{tuple(p.shape)}")
    n = p.shape[0]
    _native.require(p, "p", p.dtype, (n, 3))
    head, trig = dopri5_table(wind, ts, tf, p.dtype, nsub)
    stream = _native.stream_of(p)
    for s0 in range(0, nsub, _LAUNCH_SUBSTEPS):
        part = trig[s0:s0 + _LAUNCH_SUBSTEPS]
        table = np.concatenate([head, part.reshape(-1)])
        out = torch.empty_like(p)
        kernel(p.data_ptr(), out.data_ptr(), n, len(part),
               int(s0 + len(part) == nsub), code, table.ctypes.data,
               stream=stream)
        p = out
    return p


def integrate_line(velocity, ts: float, tf: float, p):
    """The 'line' study integrator: a 2-iteration midpoint fixed point, two
    velocity evaluations per transport step."""
    trace.count("trajectory.eager")
    dt = tf - ts
    th = 0.5 * (ts + tf)
    uh = p
    for _ in range(2):
        f = velocity(th, uh)
        uh = p + (0.5 * dt) * f
    return sphere.normalize(p + dt * f)


def interp_departure(vw, cells):
    """sum_k vw[..., k] * cells[..., k, :] as an explicit left-to-right
    chain. vw: (..., m); cells: (..., m, 3)."""
    acc = vw[..., 0, None] * cells[..., 0, :]
    for k in range(1, vw.shape[-1]):
        acc = acc + vw[..., k, None] * cells[..., k, :]
    return acc
