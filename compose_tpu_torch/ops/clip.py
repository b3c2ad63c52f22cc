"""Batched spherical Sutherland-Hodgman polygon clipping
(compose_tpu.ops.clip).

Every (target cell, source candidate) pair clips in lockstep with
fixed-size vertex buffers (MAX_NVERT = 8) and masked emission. Per input
vertex j of an edge pass, slot 2j holds the intersection of the chord
s -> p with the clip great circle (when the chord crosses it) and slot
2j+1 holds p (when p is inside); a masked compaction packs the emitted
slots in that order, which fixes the fan triangulation downstream.
Non-emitting slots are zeroed first, so the NaN of a degenerate
intersection cannot leak into the sums.

inside(v) = n . (v - a) >= 0 is anchored at an edge point a, so the edge's
own endpoints test exactly 'on'; the intersection parameter is clamped to
[0, 1] and the point renormalized to the sphere.
"""

import torch

from . import sphere

MAX_NVERT = 8


def _clip_one_edge(verts, n, ce1, cen):
    """One pass against the half-space with inward normal `cen` anchored at
    `ce1`. verts: (..., 8, 3); n: (...,) int; ce1, cen: (..., 3)."""
    idx = torch.arange(MAX_NVERT, device=verts.device)
    valid = idx < n[..., None]                                  # (..., 8)
    prev_idx = torch.where(idx == 0,
                           torch.clamp_min(n - 1, 0)[..., None], idx - 1)
    s = torch.gather(verts, -2, prev_idx[..., None].expand(verts.shape))
    p = verts
    cen_ = cen[..., None, :]
    d_p = sphere.dot(cen_, p - ce1[..., None, :])
    d_s = sphere.dot(cen_, s - ce1[..., None, :])
    in_p = d_p >= 0
    in_s = d_s >= 0

    num = sphere.dot(cen_, ce1[..., None, :] - s)
    den = sphere.dot(cen_, p - s)
    alpha = torch.where((num == 0) | (den == 0), 0.0,
                        num / torch.where(den == 0, 1.0, den))
    alpha = torch.clamp(alpha, 0.0, 1.0)
    raw = s + alpha[..., None] * (p - s)
    nrm = sphere.norm(raw)
    inter = raw / torch.where(nrm == 0, 1.0, nrm)[..., None]

    emit_int = valid & (in_p != in_s)
    emit_p = valid & in_p
    inter = torch.where(emit_int[..., None], inter, 0.0)
    p = torch.where(emit_p[..., None], p, 0.0)
    flags = torch.stack([emit_int, emit_p], dim=-1).reshape(
        emit_int.shape[:-1] + (2 * MAX_NVERT,))
    vals = torch.stack([inter, p], dim=-2).reshape(
        inter.shape[:-2] + (2 * MAX_NVERT, 3))
    pos = torch.cumsum(flags.to(torch.int64), dim=-1) - 1       # (..., 16)
    keep = flags & (pos < MAX_NVERT)
    # Compaction: each kept slot lands at its emission position. A slot
    # position receives exactly one kept value (or none: zero), so the
    # scatter has no colliding adds.
    tgt = torch.where(keep, pos, MAX_NVERT)                     # 8 = discard
    out = torch.zeros(vals.shape[:-2] + (MAX_NVERT + 1, 3), dtype=verts.dtype,
                      device=verts.device)
    out.scatter_(-2, tgt[..., None].expand(vals.shape), vals)
    n_out = torch.clamp_max(torch.sum(flags, dim=-1), MAX_NVERT).to(n.dtype)
    return out[..., :MAX_NVERT, :], n_out


def clip_against_poly(clip_verts, clip_nmls, poly, n):
    """Clip `poly` (..., 8, 3) with `n` (...,) valid vertices against the
    4-edge spherical polygon `clip_verts` (..., 4, 3) with inward edge
    normals `clip_nmls` (..., 4, 3). Returns (verts, n_out); n_out == 0
    means an empty intersection."""
    for e in range(4):
        poly, n = _clip_one_edge(poly, n, clip_verts[..., e, :],
                                 clip_nmls[..., e, :])
    return poly, n


def polygon_area(verts, n, bary, qw):
    """Area of the (possibly empty) clipped polygons by triangle-fan
    quadrature over (v0, vk, vk+1), k = 1..n-2."""
    total = torch.zeros(n.shape, dtype=verts.dtype, device=verts.device)
    for k in range(1, MAX_NVERT - 1):
        act = k + 1 < n
        jac, _ = sphere.tri_jacobian(
            verts[..., 0, :][..., None, :], verts[..., k, :][..., None, :],
            verts[..., k + 1, :][..., None, :], bary[None, :, :])
        contrib = 0.5 * torch.sum(qw * jac, dim=-1)
        total = total + torch.where(act, contrib, 0.0)
    return total
