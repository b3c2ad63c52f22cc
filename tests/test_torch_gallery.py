"""Wind, trajectories and initial conditions of the PyTorch port against
compose_tpu, on seeded sphere points and the CGLL nodes of a small mesh.

f64 tolerances cover libm differences between XLA and torch (an ulp or two
in sin/cos/atan2 and the scalar time trig). Trajectories are held to
1e-13 after 2 DoPri5 substeps of a 4-day step; the f32 route to f32
roundoff scaled by the same chain. The winds of the other ODEs, the other
initial conditions (at the ne4 CGLL nodes): 1e-14 relative to the largest
value. The toy chemistry's ICs and tendency are differences of two
quantities of the size of r = k1/4 (det - r, cl - det + r): XLA contracts
their products into FMAs and torch does not, so they agree to a few ulp
of that size, not of the result (held to 4 eps of it).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from compose_tpu import driver as driver_jax
from compose_tpu.ops import sphere as sphere_jax
from compose_tpu.transport import gallery as gallery_jax
from compose_tpu.transport import timeint as timeint_jax
from compose_tpu_torch import driver as driver_torch
from compose_tpu_torch.ops import sphere as sphere_torch
from compose_tpu_torch.transport import gallery as gallery_torch
from compose_tpu_torch.transport import timeint as timeint_torch

from torch_parity import ICS4, meshes, np_, t64

DAY = 86400.0
EPS = np.finfo(np.float64).eps


def _points(n=500, seed=13):
    p = np.random.default_rng(seed).normal(size=(n, 3))
    p /= np.linalg.norm(p, axis=-1, keepdims=True)
    p[0] = (0.0, 0.0, 1.0)            # a pole: the tangent-frame guard
    return p


@pytest.mark.parametrize("t", [0.0, 1.3 * DAY, 7.9 * DAY])
def test_divergent_velocity_f64(t):
    p = _points()
    vj = np.asarray(gallery_jax.DivergentWindField().velocity(
        jnp.asarray(t), jnp.asarray(p)))
    vt = np_(gallery_torch.create_wind("divergent").velocity(t, t64(p)))
    assert np.abs(vj - vt).max() <= 1e-13 * np.abs(vj).max()


def test_divergent_velocity_f32():
    p = _points().astype(np.float32)
    t = 2.5 * DAY
    vj = np.asarray(gallery_jax.DivergentWindField().velocity(
        jnp.asarray(t, jnp.float32), jnp.asarray(p)))
    vt = gallery_torch.DivergentWindField().velocity(
        t, t64(p).float())
    assert vj.dtype == np.float32 and str(vt.dtype) == "torch.float32"
    assert np.abs(vj - np_(vt)).max() <= 1e-5 * np.abs(vj).max()


@pytest.mark.parametrize("f32", [False, True])
def test_integrate(f32):
    mj, mt = meshes(3)
    tf, ts = 4 * DAY, 0.0
    nodes = np.asarray(mj.cgll_xyz)
    if f32:
        nodes = nodes.astype(np.float32)
    wind_j = gallery_jax.DivergentWindField()
    dj = np.asarray(timeint_jax.integrate(wind_j.velocity, tf, ts,
                                          jnp.asarray(nodes), 2))
    pt = t64(nodes).float() if f32 else t64(nodes)
    dt = np_(timeint_torch.integrate(gallery_torch.DivergentWindField()
                                     .velocity, tf, ts, pt, 2))
    assert dj.dtype == dt.dtype
    assert np.abs(dj - dt).max() <= (1e-5 if f32 else 1e-13)
    assert np.abs(np.linalg.norm(dt, axis=-1) - 1).max() <= \
        (1e-6 if f32 else 1e-15)


def test_xyz2ll():
    p = _points()
    latj, lonj = sphere_jax.xyz2ll(jnp.asarray(p))
    latt, lont = sphere_torch.xyz2ll(t64(p))
    assert np.abs(np.asarray(latj) - np_(latt)).max() <= 1e-15
    assert np.abs(np.asarray(lonj) - np_(lont)).max() <= 1e-15


@pytest.mark.parametrize("name", ICS4)
def test_initial_conditions(name):
    # The ICs are smooth except slottedcylinders, which is piecewise
    # constant: there the two may differ only where a point sits within
    # 1e-12 of the slot or cylinder edge (none do at these points).
    mj, mt = meshes(3)
    lat, lon = sphere_jax.xyz2ll(mj.cgll_xyz)
    uj = np.asarray(gallery_jax.initial_condition(name, lat, lon))
    ut = np_(gallery_torch.initial_condition(name, t64(lat), t64(lon)))
    assert ut.dtype == np.float64
    assert np.abs(uj - ut).max() <= 1e-14


def test_init_tracers():
    mj, mt = meshes(4)
    qj = np.asarray(driver_jax.init_tracers(mj, list(ICS4)))
    qt = np_(driver_torch.init_tracers(mt, list(ICS4)))
    assert qt.shape == qj.shape == (4, mj.ncell, 16)
    assert np.abs(qj - qt).max() <= 1e-14


NEW_WINDS = ("nondivergenthack", "rotate", "movingvortices", "dcmip1d3ll",
             "testfn")
NEW_ICS = ("zero", "vortextracer", "equatorstep", "equatorsmoothstep",
           "slotcyltrig", "smoothbelts", "cbandsc", "toychem1", "toychem2")


def _rel(a, b):
    a = np.asarray(a)
    return np.abs(a - np_(b)).max() / max(np.abs(a).max(), 1e-300)


@pytest.mark.parametrize("name", NEW_WINDS)
def test_other_winds(name):
    p = _points(seed=17)
    wj = gallery_jax.create_wind(name)
    wt = gallery_torch.create_wind(name)
    for t in (0.0, 1.3 * DAY, 7.9 * DAY):
        vj = wj.velocity(jnp.asarray(t), jnp.asarray(p))
        assert _rel(vj, wt.velocity(t, t64(p))) <= 1e-14, (name, t)


def _toychem_scale(lat, lon, cl, cl2, dt):
    """The size of the toy chemistry's cancelling terms at each point: r
    for the ICs; el (cl + det + r)(det + r) for the tendency."""
    r = np.asarray(gallery_jax._k_vals(lat, lon)[0]) / 4
    if cl is None:
        return r
    det = np.sqrt(r * r + 2 * r * (cl + cl2))
    x = det * dt
    el = np.where(x > 0, -np.expm1(-4 * x) / np.where(x > 0, x, 1.0), 4.0)
    return el * (cl + det + r) * (det + r)


@pytest.mark.parametrize("name", NEW_ICS)
def test_other_initial_conditions(name):
    mj, _ = meshes(4)
    lat, lon = sphere_jax.xyz2ll(mj.cgll_xyz)
    uj = gallery_jax.initial_condition(name, lat, lon)
    ut = gallery_torch.initial_condition(name, t64(lat), t64(lon))
    assert np_(ut).dtype == np.float64
    if name.startswith("toychem"):
        scale = _toychem_scale(lat, lon, None, None, None)
        assert np.all(np.abs(np.asarray(uj) - np_(ut))
                      <= 4 * EPS * scale.max())
    else:
        assert _rel(uj, ut) <= 1e-14


def test_moving_vortices_tracer_and_toychem_tendency():
    mj, _ = meshes(4)
    lat, lon = sphere_jax.xyz2ll(mj.cgll_xyz)
    for t in (0.0, 3.1 * DAY, 12 * DAY):
        assert _rel(gallery_jax.MovingVortices.calc_tracer(t, lat, lon),
                    gallery_torch.MovingVortices.calc_tracer(
                        t, t64(lat), t64(lon))) <= 1e-14
    rng = np.random.default_rng(3)
    cl = rng.uniform(0.0, 4e-6, lat.shape)
    cl2 = 4e-6 - cl
    for dt in (1800.0, 8640.0):
        tj = gallery_jax.toychem_tendency(lat, lon, jnp.asarray(cl),
                                          jnp.asarray(cl2), dt)
        tt = gallery_torch.toychem_tendency(t64(lat), t64(lon), t64(cl),
                                            t64(cl2), dt)
        scale = _toychem_scale(lat, lon, cl, cl2, dt)
        for a, b in zip(tj, tt):
            assert np.all(np.abs(np.asarray(a) - np_(b))
                          <= 4 * EPS * scale.max())


def test_moving_vortices_step_vs_jax():
    # tests/test_moving_vortices.py's configuration (filter and limiter
    # none, rho by ISL) at ne3, 2 steps of one day: the port's step
    # against JAX's (1e-12), and the vortex tracer against its analytic
    # field (the card runs the ne10 case, test_torch_cuda.py).
    from compose_tpu.transport.isl import IslConfig as CfgJ
    from compose_tpu.transport.isl import IslTransport as IslJ
    from compose_tpu_torch.transport.isl import IslConfig as CfgT
    from compose_tpu_torch.transport.isl import IslTransport as IslT

    mj, mt = meshes(3)
    kw = dict(ne=3, filter="none", limiter="none", nsub=2)
    sj = IslJ(mj, gallery_jax.create_wind("movingvortices"), CfgJ(**kw))
    st = IslT(mt, gallery_torch.create_wind("movingvortices"), CfgT(**kw))
    qj = driver_jax.init_tracers(mj, ("vortextracer",))
    rj = jnp.ones((mj.ncell, mj.np2))
    qt, rt = t64(qj), t64(rj)
    for s in range(2):
        rj, qj = sj.step(rj, qj, s * DAY, (s + 1) * DAY)
        rt, qt = st.step(rt, qt, s * DAY, (s + 1) * DAY)
        assert np.abs(np.asarray(qj) - np_(qt)).max() <= 1e-12
        assert np.abs(np.asarray(rj) - np_(rt)).max() <= 1e-12
    lat, lon = sphere_torch.xyz2ll(mt.cell_nodes_xyz.reshape(-1, 3))
    exact = gallery_torch.MovingVortices.calc_tracer(2 * DAY, lat, lon)
    assert float((qt.reshape(-1) - exact).abs().max()) < 0.2
