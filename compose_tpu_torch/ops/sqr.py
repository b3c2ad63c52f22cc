"""Spherical-quad <-> reference-square maps (compose_tpu.ops.sqr).

The normalized bilinear map of a cell's 4 corners,
    f(a, b) = sum_i c_i N_i(a, b),  q(a, b) = f / |f|,
on [-1, 1]^2, and its inverse by a fixed-trip masked Newton iteration:
every point iterates `max_its` times and converged points stop moving.
`corners` has shape (..., 4, 3), CCW from (a, b) = (-1, -1).
"""

import torch

from . import sphere

# sphere_to_ref's default Newton tolerance: 100 eps_f64.
TOL = 1e2 * torch.finfo(torch.float64).eps


def _shape_fns(a, b):
    qtr = 0.25
    return torch.stack([qtr * (1 - a) * (1 - b), qtr * (1 + a) * (1 - b),
                        qtr * (1 + a) * (1 + b), qtr * (1 - a) * (1 + b)],
                       dim=-1)


def _shape_fns_da(a, b):
    qtr = 0.25
    return torch.stack([-qtr * (1 - b), qtr * (1 - b), qtr * (1 + b),
                        -qtr * (1 + b)], dim=-1)


def _shape_fns_db(a, b):
    qtr = 0.25
    return torch.stack([-qtr * (1 - a), -qtr * (1 + a), qtr * (1 + a),
                        qtr * (1 - a)], dim=-1)


def _combine(N, corners):
    """sum_i N[..., i] corners[..., i, :] -> (..., 3)."""
    return torch.sum(N[..., :, None] * corners, dim=-2)


def ref_to_bilinear(corners, a, b):
    return _combine(_shape_fns(a, b), corners)


def ref_to_sphere(corners, a, b):
    return sphere.normalize(ref_to_bilinear(corners, a, b))


def _sphere_jacobian(corners, a, b):
    """Point on the sphere and the Jacobian columns (s_a, s_b) of the
    normalized bilinear map."""
    s = _combine(_shape_fns(a, b), corners)
    sa = _combine(_shape_fns_da(a, b), corners)
    sb = _combine(_shape_fns_db(a, b), corners)
    r2 = torch.clamp_min(sphere.norm2(s)[..., None],
                         torch.finfo(s.dtype).tiny)
    r = torch.sqrt(r2)
    sa = (sa - s * (sphere.dot(s, sa)[..., None] / r2)) / r
    sb = (sb - s * (sphere.dot(s, sb)[..., None] / r2)) / r
    return s / r, sa, sb


def _solve_Jxr(sa, sb, r):
    """Least-squares solve of [sa sb] dx = r by Gram-Schmidt QR, guarded
    against degenerate Jacobians."""
    tiny = torch.finfo(sa.dtype).tiny
    n1 = torch.clamp_min(sphere.norm(sa), tiny)
    q1 = sa / n1[..., None]
    alpha = sphere.dot(q1, sb)
    v2 = sb - alpha[..., None] * q1
    n2 = torch.clamp_min(sphere.norm(v2), tiny)
    q2 = v2 / n2[..., None]
    qtr1 = sphere.dot(q1, r)
    qtr2 = sphere.dot(q2, r)
    db = qtr2 / n2
    da = (qtr1 - alpha * db) / n1
    return da, db


def sphere_to_ref(corners, q, max_its: int = 10, tol: float = None,
                  a0=None, b0=None):
    """Invert ref_to_sphere by `max_its` masked Newton iterations from the
    warm start (a0, b0) (zeros if not given). Returns (a, b)."""
    if tol is None:
        tol = TOL
    tol2 = tol * tol
    a = torch.zeros(q.shape[:-1], dtype=q.dtype, device=q.device) \
        if a0 is None else a0
    b = torch.zeros(q.shape[:-1], dtype=q.dtype, device=q.device) \
        if b0 is None else b0
    lim = 1e3
    for _ in range(max_its):
        s, sa, sb = _sphere_jacobian(corners, a, b)
        r = s - q
        active = sphere.norm2(r) > tol2
        da, db = _solve_Jxr(sa, sb, r)
        a = torch.clamp(torch.where(active, a - da, a), -lim, lim)
        b = torch.clamp(torch.where(active, b - db, b), -lim, lim)
    return a, b


def bilinear_jacobian_norm(corners, a, b):
    """|J| of the corner-bilinear sphere map at (a, b)."""
    _, sa, sb = _sphere_jacobian(corners, a, b)
    return sphere.norm(sphere.cross(sa, sb))
