"""tests/test_degenerate_clip.py's checks on the port's clip
(compose_tpu_torch/ops/clip.py) and IR assembly, against compose_tpu on
the same inputs, CPU, f64: the ne3 mesh overlapped with a copy of itself
rotated by angles from 0 to 0.42 rad (17 decades down to 4.2e-17, where
edges coincide to an ulp), or moved by a small rotation about an
equatorial axis (the reference's translations); every (advected,
Eulerian) cell pair clipped, the overlap areas summed; and the zero-flow
comparison of the IR T blocks with the mass matrices (compare_MT).

Tolerances: the summed area within 1e-8 of 4 pi (the reference's bar),
and within 1e-12 of JAX's sum on the same vertices (the same clip in
another framework: the degenerate branches decide alike); the zero-flow
T: rd(T_diag, M) < 1e-6 (the quadrature's accuracy on the spherical
Jacobian, the JAX test's bar), off-diagonal blocks < 1e-10 of M, the pair
pattern symmetric, and the same pairs as JAX with T within that 1e-6 of
JAX's blocks in the same norm. Under zero flow the overlaps' edges
coincide: an ulp decides how the clipped polygon's vertices repeat and so
its fan triangulation, and the two packages' blocks differ at the
quadrature's accuracy, not at roundoff.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from compose_tpu.mesh import ir_data as ird_jax
from compose_tpu.ops import clip as clip_jax
from compose_tpu.ops import quadrature as quad_jax
from compose_tpu_torch.mesh import ir_data as ird_torch
from compose_tpu_torch.ops import clip as clip_torch

from test_degenerate_clip import ANGLES, AXIS, _rotation
from torch_parity import ir_models, meshes, np_, t64


@pytest.fixture(scope="module")
def areas():
    """total_area(R) for both packages: the rotated vertices, each
    package's pairs of every advected cell with every Eulerian cell."""
    mj, mt = meshes(3)
    ij, it = ird_jax.build(mj), ird_torch.build(mt)
    n = mj.ncell
    tgt = np.repeat(np.arange(n), n)
    src = np.tile(np.arange(n), n)
    bary, qw = quad_jax.get_coef(20)
    jb, jqw = jnp.asarray(bary), jnp.asarray(qw)
    clip_vj = ij.vert_xyz[ij.cell2vert]

    @jax.jit
    def area_jax(adv_vert):
        adv = adv_vert[ij.cell2vert]
        poly = jnp.concatenate([adv, jnp.zeros_like(adv)], axis=-2)
        n0 = jnp.full((n,), 4, jnp.int32)
        vo, no = clip_jax.clip_against_poly(clip_vj[tgt], ij.edge_nmls[tgt],
                                            poly[src], n0[src])
        return jnp.sum(clip_jax.polygon_area(vo, no, jb, jqw, qw.shape[0]))

    clip_vt = it.vert_xyz[it.cell2vert]
    tb, tw = t64(bary), t64(qw)
    tt, st = torch.as_tensor(tgt), torch.as_tensor(src)

    def area_torch(adv_vert):
        adv = adv_vert[it.cell2vert]
        poly = torch.cat([adv, torch.zeros_like(adv)], dim=-2)
        vo, no = clip_torch.clip_against_poly(
            clip_vt[tt], it.edge_nmls[tt], poly[st],
            torch.full((n * n,), 4, dtype=torch.int64))
        return float(clip_torch.polygon_area(vo, no, tb, tw).sum())

    vert = np.asarray(ij.vert_xyz)
    assert np.abs(vert - np_(it.vert_xyz)).max() <= 1e-15

    def both(axis, angle):
        adv = vert @ _rotation(axis, angle).T
        adv /= np.linalg.norm(adv, axis=-1, keepdims=True)
        return float(area_jax(jnp.asarray(adv))), area_torch(t64(adv))

    return both


def _check(aj, at):
    assert abs(at - 4 * np.pi) / (4 * np.pi) < 1e-8, at
    assert abs(at - aj) <= 1e-12, (at, aj)


@pytest.mark.parametrize("angle", ANGLES,
                         ids=[f"angle={a:.1e}" for a in ANGLES])
def test_overlap_area_4pi_under_degenerate_rotation(areas, angle):
    _check(*areas(AXIS, angle))


def test_overlap_area_4pi_under_degenerate_translation(areas):
    for mag in (4.2e-17, 4.2e-11, 4.2e-5, 4.2e-2):
        _check(*areas(np.array([0.0, 1.0, 0.0]), mag))


def test_compare_MT_zero_flow():
    # The IR T blocks under zero flow (the advected cells are the Eulerian
    # ones): each target's only overlap is itself, and its block is the
    # quadrature mass matrix.
    mj, sj, st = ir_models(4, 4, "geometric", dict(method="ir"))
    ird = st.ird
    adv = ird.vert_xyz[ird.cell2vert]
    ps, pt, pm = st._pairs(adv)
    T, _ = st._assemble_T(adv, ps, pt, pm)
    Tj, _ = sj._assemble_T(jnp.asarray(np_(adv)), *(jnp.asarray(np_(x))
                                                    for x in (ps, pt, pm)))
    Tn, Tjn = np_(T), np.asarray(Tj)
    M = np_(torch.einsum('cik,cjk->cij', ird.chol, ird.chol))
    assert np.sqrt(np.sum((Tn - Tjn) ** 2) / np.sum(M ** 2)) < 1e-6
    ps, pt, pm = np_(ps), np_(pt), np_(pm)
    num = den = 0.0
    for c in range(mj.ncell):
        sel = np.where(pm & (pt == c) & (ps == c))[0]
        assert len(sel) == 1
        num += float(np.sum((Tn[sel[0]] - M[c]) ** 2))
        den += float(np.sum(M[c] ** 2))
        offs = np.where(pm & (pt == c) & (ps != c))[0]
        if len(offs):
            assert np.abs(Tn[offs]).max() < 1e-10 * np.abs(M[c]).max()
    assert np.sqrt(num / den) < 1e-6
    pairs = set(zip(pt[pm].tolist(), ps[pm].tolist()))
    assert all((s, t) in pairs for (t, s) in pairs)
