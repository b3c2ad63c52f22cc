"""The slice as a whole: the port's ISL step (pisl; CAAS/CAAS, and the
default CDR QLT/mn2 with caas/mn2 and mn2/mn2) and driver against
compose_tpu on the CPU at ne4.

- all-f64: pointwise within 1e-12 of the JAX step after each of 3 steps
  (both are f64; they differ by XLA/torch summation order and libm, plus
  the JAX CPU DSS taking FaceDss's roll path, which agrees with the gather
  formulation to roundoff; ~7e-14 seen), for every filter/limiter pair;
- f32 geometry + interpolation: the invariants of the f64 CDR (mass and
  bounds exactly as the f64 route), and a solution-level bound of 1e-4
  (f32 trajectories round differently in XLA and torch, and the weights
  carry that noise, ~1e-5 seen);
- driver.run at test_smoke_caas_ne4's and test_interp_f32_invariants'
  configs and with its defaults, and the Observer invariants of both
  packages.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from compose_tpu import diagnostics as diag_jax
from compose_tpu import driver as driver_jax
from compose_tpu.transport import gallery as gallery_jax
from compose_tpu.transport.isl import IslConfig as CfgJ
from compose_tpu.transport.isl import IslTransport as IslJ
from compose_tpu_torch import diagnostics as diag_torch
from compose_tpu_torch import driver as driver_torch
from compose_tpu_torch.transport import gallery as gallery_torch
from compose_tpu_torch.transport.isl import IslConfig as CfgT
from compose_tpu_torch.transport.isl import IslTransport as IslT

from torch_parity import ICS4, meshes, np_

NSTEPS = 3
DT = 86400.0 * 12 / NSTEPS


def _run_both(dtype, filter="caas", limiter="caas"):
    """3 steps of both steps from the same state; returns the per-step
    (rho_j, q_j, rho_t, q_t) as numpy, and F."""
    mj, mt = meshes(4)
    kw = dict(ne=4, filter=filter, limiter=limiter, nsub=2,
              geom_dtype=dtype, interp_dtype=dtype)
    sj = IslJ(mj, gallery_jax.create_wind("divergent"), CfgJ(**kw))
    st = IslT(mt, gallery_torch.create_wind("divergent"), CfgT(**kw))
    qj = driver_jax.init_tracers(mj, list(ICS4))
    qt = driver_torch.init_tracers(mt, list(ICS4))
    rj = jnp.ones((mj.ncell, mj.np2))
    rt = torch.ones((mt.ncell, mt.np2), dtype=torch.float64)
    out = [(np.asarray(rj), np.asarray(qj), np_(rt), np_(qt))]
    for s in range(NSTEPS):
        rj, qj = sj.step(rj, qj, s * DT, (s + 1) * DT)
        rt, qt = st.step(rt, qt, s * DT, (s + 1) * DT)
        out.append((np.asarray(rj), np.asarray(qj), np_(rt), np_(qt)))
    return out, np.asarray(mj.dgbfi_gll)


@pytest.fixture(scope="module")
def runs():
    return {d: _run_both(d) for d in ("f64", "f32")}


def _invariants(states, F, k):
    """Per step: relative mass change of each tracer, and the bounds
    excess over the previous step's global range (k = 2 port, 0 JAX)."""
    mass_err, bounds_err = 0.0, 0.0
    for prev, cur in zip(states[:-1], states[1:]):
        r0, q0, r1, q1 = prev[k], prev[k + 1], cur[k], cur[k + 1]
        m0 = (F * r0 * q0).sum((1, 2))
        m1 = (F * r1 * q1).sum((1, 2))
        mass_err = max(mass_err, np.max(np.abs(m1 - m0) / np.abs(m0)))
        lo, hi = q0.min((1, 2)), q0.max((1, 2))
        bounds_err = max(bounds_err,
                         np.max(lo - q1.min((1, 2))), np.max(q1.max((1, 2))
                                                             - hi), 0.0)
    return mass_err, bounds_err


def test_step_f64_matches_jax(runs):
    states, F = runs["f64"]
    for rj, qj, rt, qt in states[1:]:
        assert rt.shape == rj.shape and qt.shape == qj.shape
        assert np.all(np.isfinite(qt)) and np.all(np.isfinite(rt))
        assert np.abs(rj - rt).max() <= 1e-12
        assert np.abs(qj - qt).max() <= 1e-12
    for k in (0, 2):
        mass_err, bounds_err = _invariants(states, F, k)
        assert mass_err < 1e-12 and bounds_err < 5e-13


@pytest.mark.parametrize("filter,limiter", [("qlt", "mn2"), ("caas", "mn2"),
                                            ("mn2", "mn2")])
def test_step_cdr_f64_matches_jax(filter, limiter):
    states, F = _run_both("f64", filter, limiter)
    for rj, qj, rt, qt in states[1:]:
        assert np.all(np.isfinite(qt)) and np.all(np.isfinite(rt))
        assert np.abs(rj - rt).max() <= 1e-12
        assert np.abs(qj - qt).max() <= 1e-12
    for k in (0, 2):
        mass_err, bounds_err = _invariants(states, F, k)
        assert mass_err < 1e-12 and bounds_err < 5e-13


def test_step_f32_route_invariants(runs):
    states, F = runs["f32"]
    mass_err, bounds_err = _invariants(states, F, 2)
    assert mass_err < 1e-12
    assert bounds_err == 0.0
    for rj, qj, rt, qt in states[1:]:
        assert np.abs(rj - rt).max() <= 1e-4
        assert np.abs(qj - qt).max() <= 1e-4
    # The f32 route stays at solution level with the f64 route.
    q64 = runs["f64"][0][-1][3]
    assert np.abs(states[-1][3] - q64).max() <= 1e-4


def test_driver_smoke_caas_ne4():
    # test_smoke_caas_ne4's config and checks, and the JAX run's l2.
    kw = dict(ne=4, np_=4, nsteps=3, ics=("gaussianhills",), filter_="caas",
              limiter="caas", nsub=2, verbose=False)
    out = driver_torch.run(device="cpu", **kw)
    assert out.cv_gll <= 5e-14
    assert out.max_step_mass_err < 1e-12
    assert out.max_step_bounds_err < 5e-13
    assert out.l2_err < 0.5
    ref = driver_jax.run(**kw)
    assert abs(out.l2_err - ref.l2_err) <= 1e-12
    assert abs(out.min_e - ref.min_e) <= 1e-12
    assert abs(out.max_e - ref.max_e) <= 1e-12


def test_driver_defaults_match_jax():
    # Both packages' defaults are the pisl QLT filter and mn2 limiter.
    kw = dict(ne=4, nsteps=3, nsub=2)
    out = driver_torch.run(device="cpu", **kw)
    ref = driver_jax.run(**kw)
    assert abs(out.l2_err - ref.l2_err) <= 1e-12
    assert abs(out.min_e - ref.min_e) <= 1e-12
    assert abs(out.max_e - ref.max_e) <= 1e-12
    assert out.max_step_mass_err < 1e-12 and out.max_step_bounds_err < 5e-13


def test_driver_interp_f32_invariants():
    # test_interp_f32_invariants' config and checks, on the port.
    kw = dict(ne=4, np_=4, nsteps=3, ics=("cosinebells",), filter_="caas",
              limiter="caas", nsub=2, verbose=False, device="cpu")
    out32 = driver_torch.run(geom_dtype="f32", interp_dtype="f32", **kw)
    out64 = driver_torch.run(**kw)
    assert out32.cv_gll < 5e-14
    assert out32.max_step_bounds_err == 0.0
    assert abs(out32.l2_err - out64.l2_err) < 1e-4


def test_observer_invariants(runs):
    # Both packages' Observers over the f64 run: mass < 1e-12 for rho and
    # every tracer, tracer bounds < 5e-13.
    states, _ = runs["f64"]
    mj, mt = meshes(4)
    names = ["rho"] + [f"q{i}" for i in range(len(ICS4))]
    oj = diag_jax.Observer(mj.dgbfi_gll, mj.dgbfi_sphere, names)
    ot = diag_torch.Observer(mt.dgbfi_gll, mt.dgbfi_sphere, names)
    for s, (rj, qj, rt, qt) in enumerate(states):
        oj.add_obs(s * DT, jnp.asarray(rj), list(jnp.asarray(qj)))
        ot.add_obs(s * DT, torch.tensor(rt), list(torch.tensor(qt)))
    ok, mass_err, bounds_err = ot.check()
    assert ok and mass_err < 1e-12 and bounds_err < 5e-13
    # compose_tpu's check bounds every field, rho too, which a divergent
    # flow moves; hold its tracer fields to the same bars.
    rho_j, oj.fields = oj.fields[0], oj.fields[1:]
    _, mass_j, bounds_j = oj.check()
    m = np.asarray(rho_j.mass_gll)
    assert mass_j < 1e-12 and bounds_j < 5e-13
    assert np.max(np.abs(np.diff(m)) / np.abs(m[1:])) < 1e-12
    for fj, ft in zip(oj.fields, ot.fields[1:]):
        assert np.allclose(fj.mass_gll, ft.mass_gll, rtol=1e-13, atol=0)


def test_unported_config_raises():
    # Every precision route is ported: mixed geometry/interpolation
    # precisions, and the single-precision route of the cell-integrated
    # methods, of p-refinement and of the physics grid, all run. What
    # raises is what compose_tpu refuses too: a target density needs the
    # mixed method's rho_isl=False, and a -pve filter an ISL-family method;
    # unknown precisions are a ValueError.
    mj, mt = meshes(4)
    rho = torch.ones((mt.ncell, mt.np2), dtype=torch.float64)
    q = driver_torch.init_tracers(mt, ["gaussianhills"])
    for geom, interp in (("f32", "f64"), ("f64", "f32")):
        sm = IslT(mt, gallery_torch.create_wind("divergent"),
                  CfgT(ne=4, geom_dtype=geom, interp_dtype=interp, nsub=1))
        r1, q1 = sm.step(rho, q, 0.0, 3600.0)
        assert r1.dtype == q1.dtype == torch.float64
        assert bool(torch.isfinite(q1).all())
    with pytest.raises(ValueError):
        IslT(mt, gallery_torch.create_wind("divergent"),
             CfgT(ne=4, geom_dtype="f16"))
    st = IslT(mt, gallery_torch.create_wind("divergent"), CfgT(ne=4))
    with pytest.raises(ValueError):
        st.step(rho, q, 0.0, 3600.0, rho_tgt=rho)
    for kw in (dict(prefine=5), dict(method="ir"), dict(method="cdg"),
               dict(method="isl"), dict(pg=2, ics=("toychem1", "toychem2"))):
        out = driver_torch.run(ne=2, nsteps=1, nsub=1, device="cpu",
                               verbose=False, x64=False, **kw)
        assert np.isfinite(out.l2_err) and np.isfinite(out.cv)
    for kw in (dict(method="ir", filter_="qlt-pve"),
               dict(method="cdg", filter_="caas-pve")):
        with pytest.raises(ValueError, match="ISL-family"):
            driver_torch.run(ne=2, nsteps=1, device="cpu", **kw)
        with pytest.raises(ValueError, match="ISL-family"):
            driver_jax.run(ne=2, nsteps=1, verbose=False, **kw)
