"""Trajectory (departure point) integration (compose_tpu.transport.timeint):
all nodes in lockstep with `nsub` fixed Dormand-Prince RK5(4) substeps, in
cartesian xyz, then normalized back onto the sphere; the 2-evaluation
midpoint study integrator (`integrate_line`); and the interpolation of a
coarse velocity grid's departure points to the fine nodes
(`interp_departure`).
"""

from ..config import np_scalar
from ..ops import sphere

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
    backward, as for ISL departure points). p: (..., 3)."""
    dt = (tf - ts) / nsub
    for i in range(nsub):
        p = _dopri5_step(velocity, ts + i * dt, dt, p)
    return sphere.normalize(p)


def integrate_line(velocity, ts: float, tf: float, p):
    """The 'line' study integrator: a 2-iteration midpoint fixed point, two
    velocity evaluations per transport step."""
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
