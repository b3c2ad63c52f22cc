"""The cell-integrated remap's building blocks in the port against
compose_tpu on the CPU: triangle quadrature, polygon clipping, subcell
meshes and their point location, the IR tables, and the winds and initial
conditions the IR golden rows use; and the mixed `isl` method's step
(IrTransport.remap_rho, then IslTransport.step with rho_tgt) against the
JAX one, 2 steps of one day at ne3 (see test_torch_ir_step.py), 1e-12.

Tolerances:
  - quadrature tables: equal bitwise (copied digit for digit);
  - clip: n_out equal exactly, vertices 1e-14 (the same arithmetic in both
    frameworks, a few ulp apart); the overlaps of a ne3 mesh with itself
    tile the sphere: their areas sum to 4 pi within 1e-13;
  - IR tables: integer tables equal exactly, float tables 1e-13 relative
    to each table's largest entry (the mass matrices come from the same
    quadrature through torch and XLA f64 kernels);
  - subcell locate: cell ids equal exactly; coordinates 1e-12: the parent
    coordinates stop after 6 Newton iterations, a few 1e-14 apart where a
    point starts far from its root, and the subcell rescale multiplies by
    2 / (break spacing), 4 on the np5 uniform breaks;
  - winds and initial conditions: 1e-15 absolute.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from compose_tpu import driver as driver_jax
from compose_tpu.mesh import cubed_sphere as cs_jax
from compose_tpu.mesh import ir_data as ird_jax
from compose_tpu.ops import clip as clip_jax
from compose_tpu.ops import quadrature as quad_jax
from compose_tpu.transport import gallery as gallery_jax
from compose_tpu.transport.isl import IslConfig as IslCfgJ
from compose_tpu.transport.isl import IslTransport as IslJ
from compose_tpu_torch.mesh import cubed_sphere as cs_torch
from compose_tpu_torch.mesh import ir_data as ird_torch
from compose_tpu_torch.ops import clip as clip_torch
from compose_tpu_torch.ops import quadrature as quad_torch
from compose_tpu_torch.transport import gallery as gallery_torch
from compose_tpu_torch.transport.isl import IslConfig as IslCfgT
from compose_tpu_torch.transport.isl import IslTransport as IslT

from torch_parity import DAY, ICS4, OPTIONAL, err, ir_models, meshes, np_, t64


@pytest.mark.parametrize("order", [4, 6, 8, 12, 14, 16, 18, 20, 7, 10])
def test_get_coef_equal(order):
    # The published orders come from the tables, 7 and 10 from the Duffy
    # fallback.
    bj, wj = quad_jax.get_coef(order)
    bt, wt = quad_torch.get_coef(order)
    assert np.array_equal(bj, bt) and np.array_equal(wj, wt)
    assert abs(wt.sum() - 1.0) < 1e-14


def _clip_inputs(seed, npair=3000):
    """Target cells of a ne3 mesh with their inward normals, and source
    quads: the candidate cells' corners moved by up to a quarter cell."""
    mj, _ = meshes(3)
    ird = ird_jax.build(mj)
    rng = np.random.default_rng(seed)
    cands = np.asarray(ird.cands)
    tgt = rng.integers(0, mj.ncell, npair)
    src = cands[tgt, rng.integers(0, 9, npair)]
    verts = np.asarray(ird.vert_xyz)[np.asarray(ird.cell2vert)]
    quad = verts[src] + rng.uniform(-0.08, 0.08, (npair, 4, 3))
    quad /= np.linalg.norm(quad, axis=-1, keepdims=True)
    poly = np.concatenate([quad, np.zeros_like(quad)], axis=1)
    n0 = np.where(rng.random(npair) < 0.05, 0, 4).astype(np.int32)
    return verts[tgt], np.asarray(ird.edge_nmls)[tgt], poly, n0


@pytest.mark.parametrize("seed", [1, 2])
def test_clip_against_poly(seed):
    cv, cn, poly, n0 = _clip_inputs(seed)
    vj, nj = clip_jax.clip_against_poly(*map(jnp.asarray, (cv, cn, poly, n0)))
    vt, nt = clip_torch.clip_against_poly(
        t64(cv), t64(cn), t64(poly), torch.tensor(n0, dtype=torch.int64))
    assert np.array_equal(np.asarray(nj), np_(nt))
    assert np.abs(np.asarray(vj) - np_(vt)).max() <= 1e-14
    # Some pairs clip to an empty set, some to more than four vertices.
    assert (np_(nt) == 0).any() and (np_(nt) > 4).any()


def test_polygon_area_tiles_the_sphere():
    _, mt = meshes(3)
    ird = ird_torch.build(mt)
    nc = mt.ncell
    tgt = torch.arange(nc).repeat_interleave(ird.cands.shape[1])
    src = ird.cands.reshape(-1)
    v = ird.vert_xyz[ird.cell2vert]
    poly = torch.cat([v[src], torch.zeros_like(v[src])], dim=1)
    n0 = torch.where(ird.cands_mask.reshape(-1), 4, 0)
    vo, no = clip_torch.clip_against_poly(v[tgt], ird.edge_nmls[tgt], poly,
                                          n0)
    bary, qw = (t64(x) for x in quad_torch.get_coef(18))
    area = clip_torch.polygon_area(vo, no, bary, qw)
    assert abs(float(area.sum()) - 4 * np.pi) <= 1e-13
    # Each cell overlaps itself whole, its neighbours on sets of zero area.
    assert abs(float(area[src == tgt].sum()) - 4 * np.pi) <= 1e-13


IRD_CASES = [(3, 3, None, "geometric"), (3, 3, 4, "geometric"),
             (3, 4, None, "geometric"), (3, 4, 4, "geometric"),
             (2, 4, None, "gllsubcell")]


@pytest.mark.parametrize("ne,n,tq,mesh_type", IRD_CASES)
def test_ir_data_tables(ne, n, tq, mesh_type):
    mj, mt = meshes(ne, n, mesh_type=mesh_type)
    dj = ird_jax.build(mj, tq_order=tq)
    dt = ird_torch.build(mt, tq_order=tq)
    for k in ird_torch.FIELDS:
        a, b = np.asarray(getattr(dj, k)), np_(getattr(dt, k))
        assert a.shape == b.shape, k
        if a.dtype.kind in "bi":
            assert np.array_equal(a, b), k
        else:
            assert np.abs(a - b).max() <= 1e-13 * np.abs(a).max(), k


@pytest.mark.parametrize("mesh_type,ne,n", [("gllsubcell", 2, 4),
                                            ("runisubcell", 2, 5)])
def test_subcell_mesh_and_locate(mesh_type, ne, n):
    # The port's own build against the JAX one, then point location.
    mj = cs_jax.build(ne, n, mesh_type=mesh_type)
    mt = cs_torch.build(ne, n, device="cpu", mesh_type=mesh_type)
    assert (mt.ne, mt.np_, mt.sub_parent_ne) == (mj.ne, mj.np_, ne)
    for k in ("dgll2cgll", "c2d_idx", "corners", "dgbfi_gll",
              "dgbfi_sphere") + OPTIONAL:
        a, b = getattr(mj, k), getattr(mt, k)
        if a is None:
            assert b is None, k
            continue
        assert np.abs(np.asarray(a) - np_(b)).max() <= 1e-14, k
    rng = np.random.default_rng(ne * n)
    p = rng.normal(size=(3000, 3))
    p /= np.linalg.norm(p, axis=-1, keepdims=True)
    cj, aj, bj = cs_jax.locate(mj, jnp.asarray(p))
    ct, at, bt = cs_torch.locate(mt, t64(p))
    assert np.array_equal(np.asarray(cj), np_(ct))
    assert np.abs(np.asarray(aj) - np_(at)).max() <= 1e-12
    assert np.abs(np.asarray(bj) - np_(bt)).max() <= 1e-12
    assert np.array_equal(np.asarray(cs_jax.locate_cell(mj, jnp.asarray(p))),
                          np_(cs_torch.locate_cell(mt, t64(p))))


def test_gallery_additions():
    rng = np.random.default_rng(5)
    p = rng.normal(size=(500, 3))
    p /= np.linalg.norm(p, axis=-1, keepdims=True)
    wj = gallery_jax.create_wind("nondivergent")
    wt = gallery_torch.create_wind("nondivergent")
    for t in (0.0, 3.7e5, 8.64e5):
        assert np.abs(np.asarray(wj.velocity(t, jnp.asarray(p)))
                      - np_(wt.velocity(t, t64(p)))).max() <= 1e-15
    lat = rng.uniform(-1.5, 1.5, 500)
    lon = rng.uniform(-np.pi, np.pi, 500)
    for name in ("correlatedcosinebells", "constant"):
        a = gallery_jax.initial_condition(name, jnp.asarray(lat),
                                          jnp.asarray(lon))
        b = gallery_torch.initial_condition(name, t64(lat), t64(lon))
        assert np.abs(np.asarray(a) - np_(b)).max() <= 1e-15, name


@pytest.mark.parametrize("flt,lim", [("qlt", "mn2"), ("caas", "caas")])
def test_mixed_isl_step_vs_jax(flt, lim):
    # The density by remap_rho (ir, dmc eh), the tracers by ISL with it as
    # the target density; the mixed DSS of density and tracer masses.
    mj, sj, st = ir_models(3, 4, "geometric", dict(method="ir", dmc="eh",
                                                 filter="none",
                                                 limiter="none"))
    icfg = dict(ne=3, np_=4, filter=flt, limiter=lim, rho_isl=False, nsub=2,
                dmc="f")
    ij = IslJ(mj, gallery_jax.create_wind("divergent"), IslCfgJ(**icfg))
    it = IslT(st.mesh, gallery_torch.create_wind("divergent"),
              IslCfgT(**icfg))
    qj = driver_jax.init_tracers(mj, ICS4)
    rj = jnp.ones((mj.ncell, mj.np2))
    rt, qt = t64(rj), t64(qj)
    for s in range(2):
        ts, tf = s * DAY, (s + 1) * DAY
        gj, gt = sj.remap_rho(rj, ts, tf), st.remap_rho(rt, ts, tf)
        assert err(gj, gt) <= 1e-12
        rj, qj = ij.step(rj, qj, ts, tf, rho_tgt=gj)
        rt, qt = it.step(rt, qt, ts, tf, rho_tgt=gt)
        assert err(rj, rt) <= 1e-12 and err(qj, qt) <= 1e-12, s
    with pytest.raises(ValueError):
        IslT(st.mesh, gallery_torch.create_wind("divergent"),
             IslCfgT(ne=3)).step(rt, qt, 0.0, DAY, rho_tgt=rt)
