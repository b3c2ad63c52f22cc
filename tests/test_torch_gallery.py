"""Wind, trajectories and initial conditions of the PyTorch port against
compose_tpu, on seeded sphere points and the CGLL nodes of a small mesh.

f64 tolerances cover libm differences between XLA and torch (an ulp or two
in sin/cos/atan2 and the scalar time trig). Trajectories are held to
1e-13 after 2 DoPri5 substeps of a 4-day step; the f32 route to f32
roundoff scaled by the same chain.
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
