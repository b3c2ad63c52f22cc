"""Sphere geometry primitives on tensors whose last axis is the 3-vector
(compose_tpu.ops.sphere)."""

import torch


def dot(a, b):
    return torch.sum(a * b, dim=-1)


def norm2(a):
    return dot(a, a)


def norm(a):
    return torch.sqrt(norm2(a))


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def normalize(a):
    return a / norm(a)[..., None]


def ll2xyz(lat, lon, radius=1.0):
    """Latitude/longitude (radians) -> unit-sphere cartesian, stacked last."""
    coslat = torch.cos(lat)
    return torch.stack([radius * torch.cos(lon) * coslat,
                        radius * torch.sin(lon) * coslat,
                        radius * torch.sin(lat)], dim=-1)


def xyz2ll(p):
    """Cartesian -> (lat, lon) in radians."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    lat = torch.atan2(z, torch.sqrt(x * x + y * y))
    lon = torch.atan2(y, x)
    return lat, lon


def great_circle_dist(lat1, lon1, lat2, lon2, radius=1.0):
    """Great-circle distance via atan2(|a x b|, a.b)."""
    a = ll2xyz(lat1, lon1)
    b = ll2xyz(lat2, lon2)
    return radius * torch.atan2(norm(cross(a, b)), dot(a, b))


def tri_jacobian(v1, v2, v3, bary):
    """|J| of (barycentric coords on a flat triangle) -> sphere at `bary`
    (..., 3), and the sphere point."""
    q = (bary[..., 0:1] * v1 + bary[..., 1:2] * v2 + bary[..., 2:3] * v3)
    r2 = torch.clamp_min(norm2(q)[..., None], torch.finfo(q.dtype).tiny)
    r = torch.sqrt(r2)
    sphere_p = q / r
    e1 = v1 - v3
    e2 = v2 - v3
    t1 = e1 / r - q * (dot(q, e1)[..., None] / (r2 * r))
    t2 = e2 / r - q * (dot(q, e2)[..., None] / (r2 * r))
    return norm(cross(t1, t2)), sphere_p
