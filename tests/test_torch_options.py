"""The ISL options of the port against compose_tpu on the CPU: the limiters
(caags, the cell-local QLT, bound expansion), the -fitext bound relaxation,
the line and interp trajectories, and one IslTransport.step case per
option at ne <= 3, nsub 2, 2 steps, f64. Then the JAX package's non-slow
driver tests of these options, at their sizes and with their asserts, on
the port.

Tolerances:
  - limiters, integrate_line, interp_departure: 1e-13 (both f64;
    summation orders differ);
  - FitExtremum.calc: flags equal, values 1e-12: the interior critical
    point's Newton divides by the Hessian's determinant, which amplifies
    the fit coefficients' ~1e-16 summation differences in ill-conditioned
    cells (7e-13 seen at np8);
  - the step: 1e-12 pointwise against the JAX step after each step (~1e-13
    seen at np12), and the Observer bars in the measure the option
    conserves: mass < 1e-12, tracer bounds < 5e-13 (nonnegativity for a
    positive-only filter). Filter none and -fitext change the bounds (no
    limiter; sub-grid extrema), and filter none the mass, so those bars
    are not held there.
  - The caags case uses the plateau-free initial conditions gaussianhills
    and xyztrig: CAAGS picks its direction by y < q_max (or y > q_min) on
    the unclipped y, and where a node's y sits on its bound (the 0.1
    background of slottedcylinders and cosinebells) a 1-ulp difference
    between the frameworks' interpolations flips that choice, and the cell
    then differs at O(1e-2) in both directions (the limiter itself agrees
    at 1e-15 on the same inputs; test_limit_tracer_vs_jax).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from compose_tpu import driver as driver_jax
from compose_tpu.transport import gallery as gallery_jax
from compose_tpu.transport import limiter as limiter_jax
from compose_tpu.transport import timeint as timeint_jax
from compose_tpu.transport.fit_extremum import FitExtremum as FitJ
from compose_tpu.transport.isl import IslConfig as CfgJ
from compose_tpu.transport.isl import IslTransport as IslJ
from compose_tpu_torch import diagnostics as diag_torch
from compose_tpu_torch import driver as driver_torch
from compose_tpu_torch.transport import gallery as gallery_torch
from compose_tpu_torch.transport import limiter as limiter_torch
from compose_tpu_torch.transport import timeint as timeint_torch
from compose_tpu_torch.transport.fit_extremum import FitExtremum as FitT
from compose_tpu_torch.transport.isl import IslConfig as CfgT
from compose_tpu_torch.transport.isl import IslTransport as IslT

from torch_parity import meshes, np_, t64

ROT = ((0.11111, -0.051515, 1.0), 0.142314 * np.pi)
ICS3 = ("gaussianhills", "slottedcylinders", "cosinebells")
SMOOTH = ("gaussianhills", "xyztrig")


def _jax_lqlt_trees():
    # compose_tpu builds a cell-local QLT tree lazily and caches it; built
    # inside a jit trace, the cached table is a tracer that the next trace
    # cannot use. Build the trees before any JAX limiter runs.
    for n in limiter_jax._TREE_DESC:
        limiter_jax._get_lqlt_tree(n)


_jax_lqlt_trees()


# ---------------------------------------------------------------------------
# Limiters, bound expansion, FitExtremum, trajectories.

def _limiter_inputs(seed, nt=3, ncell=20, np2=16, zero_density=False):
    rng = np.random.default_rng(seed)
    F = rng.uniform(0.5, 1.5, (ncell, np2))
    rho = rng.uniform(0.5, 1.5, (ncell, np2))
    if zero_density:
        rho[rng.random((ncell, np2)) < 0.05] = 0.0
    qmin = rng.uniform(0.0, 0.5, (nt, ncell, np2))
    qmax = qmin + rng.uniform(0.0, 0.5, (nt, ncell, np2))
    Q = rng.uniform(-0.2, 1.2, (nt, ncell, np2)) * rho
    extra = rng.uniform(-0.5, 0.5, (nt, ncell))
    return F, rho, Q, qmin, qmax, extra


@pytest.mark.parametrize("expand", [False, True], ids=["strict", "expand"])
@pytest.mark.parametrize("limiter,np2", [("caas", 16), ("caas", 36),
                                         ("mn2", 16), ("caags", 16),
                                         ("qlt", 16), ("qlt", 64),
                                         ("qlt", 36)])
def test_limit_tracer_vs_jax(limiter, np2, expand):
    # qlt at np2 36 has no tree (np6): the plain np2-node QP.
    F, rho, Q, qmin, qmax, extra = _limiter_inputs(np2, np2=np2)
    fj = jax.vmap(lambda Qi, lo, hi, d: limiter_jax.limit_tracer(
        jnp.asarray(F), jnp.asarray(rho), Qi, lo, hi, d, limiter=limiter,
        expand_bounds_allowed=expand))
    xj = np.asarray(fj(*map(jnp.asarray, (Q, qmin, qmax, extra))))
    xt = np_(limiter_torch.limit_tracer(
        t64(F), t64(rho), t64(Q), t64(qmin), t64(qmax), t64(extra),
        limiter=limiter, expand_bounds_allowed=expand))
    assert np.abs(xj - xt).max() <= 1e-13


def test_expand_bounds_vs_jax():
    F, rho, Q, qmin, qmax, extra = _limiter_inputs(7)
    rhom = F * rho
    Qm_tot = (Q * F).sum(-1) + 3 * extra
    Qm_min, Qm_max = (qmin * rhom).sum(-1), (qmax * rhom).sum(-1)
    lo, hi = Qm_tot < Qm_min, Qm_tot > Qm_max
    assert lo.any() and hi.any() and not (lo | hi).all()
    ex = Qm_tot - np.where(lo, Qm_min, Qm_max)
    args = (rhom, qmin, qmax, ex, lo, hi, rhom.sum(-1))
    mj = limiter_jax._expand_bounds(*map(jnp.asarray, args))
    mt = limiter_torch._expand_bounds(*(torch.tensor(a) for a in args))
    for a, b in zip(mj, mt):
        assert np.abs(np.asarray(a) - np_(b)).max() <= 1e-13
    # Rows inside their bounds keep them exactly.
    keep = ~(lo | hi)
    assert np.array_equal(np_(mt[0])[keep], qmin[keep])
    assert np.array_equal(np_(mt[1])[keep], qmax[keep])


@pytest.mark.parametrize("n", [4, 6, 8])
def test_fit_extremum_vs_jax(n):
    # Smooth cell data (quadratic bumps plus noise) so that some fits pass.
    rng = np.random.default_rng(n)
    x = np.asarray(FitJ(n).gx)
    X, Y = np.meshgrid(x, x, indexing="xy")
    c = rng.uniform(-1, 1, (200, 6))
    y = (c[:, 0, None, None] * X ** 2 + c[:, 1, None, None] * Y ** 2
         + c[:, 2, None, None] * X * Y + c[:, 3, None, None] * X
         + c[:, 4, None, None] * Y + c[:, 5, None, None])
    y = y.reshape(200, n * n) + rng.normal(0, 1e-3, (200, n * n))
    rj = FitJ(n).calc(jnp.asarray(y))
    rt = FitT(n).calc(t64(y))
    assert np.array_equal(np.asarray(rj[2]), np_(rt[2]))
    assert 0 < np_(rt[2]).sum() < 200
    for a, b in zip(rj[:2], rt[:2]):
        assert np.abs(np.asarray(a) - np_(b)).max() <= 1e-12


def test_integrate_line_and_interp_departure_vs_jax():
    rng = np.random.default_rng(4)
    p = rng.normal(size=(500, 3))
    p /= np.linalg.norm(p, axis=-1, keepdims=True)
    wj = gallery_jax.create_wind("divergent")
    wt = gallery_torch.create_wind("divergent")
    dj = np.asarray(timeint_jax.integrate_line(wj.velocity, 86400.0, 0.0,
                                               jnp.asarray(p)))
    dt = np_(timeint_torch.integrate_line(wt.velocity, 86400.0, 0.0, t64(p)))
    assert np.abs(dj - dt).max() <= 1e-13
    vw = rng.uniform(-0.2, 1.0, (500, 16))
    cells = rng.normal(size=(500, 16, 3))
    aj = np.asarray(timeint_jax.interp_departure(jnp.asarray(vw),
                                                 jnp.asarray(cells)))
    at = np_(timeint_torch.interp_departure(t64(vw), t64(cells)))
    assert np.abs(aj - at).max() <= 1e-13


# ---------------------------------------------------------------------------
# The step, one case per option.

# id: (ne, np, mesh options, config, ICs, Observer measure or None)
STEP_CASES = {
    "np6_qlt": (2, 6, {}, dict(filter="qlt", limiter="mn2"), ICS3, "gll"),
    "np8_caas_interp_es": (2, 8, {}, dict(filter="caas", limiter="caas",
                                          timeint="interp", dmc="es"),
                           ICS3, "sphere"),
    "np12_none": (2, 12, {}, dict(filter="none", limiter="none"), ICS3,
                  None),
    "caasnode_eh": (2, 4, {}, dict(filter="caas-node", limiter="caas",
                                   dmc="eh"), ICS3, "gll"),
    "caasnode_es_np8": (2, 8, {}, dict(filter="caas-node", limiter="caas",
                                       dmc="es"), ICS3, "sphere"),
    "none": (3, 4, {}, dict(filter="none", limiter="none"), ICS3, None),
    "qlt_pve": (3, 4, {}, dict(filter="qlt", limiter="mn2",
                               positive_only=True), ICS3, "gll"),
    "fitext": (3, 4, {}, dict(filter="caas", limiter="caas", fitext=True),
               ICS3, "gll"),
    "line": (3, 4, {}, dict(filter="caas", limiter="caas", timeint="line"),
             ICS3, "gll"),
    "interpline": (2, 6, {}, dict(filter="caas", limiter="caas",
                                  timeint="interpline"), ICS3, "gll"),
    "rotate": (3, 4, dict(rotate=ROT), dict(filter="caas", limiter="caas",
                                            rotate=ROT), ICS3, "gll"),
    "nonuni": (3, 4, dict(nonuni=True), dict(filter="caas", limiter="caas"),
               ICS3, "gll"),
    "pislu": (3, 4, {}, dict(filter="caas", limiter="caas", basis="Gll"),
              ICS3, "gll"),
    "caags": (3, 4, {}, dict(filter="caas", limiter="caags"), SMOOTH, "gll"),
    "lqlt": (3, 4, {}, dict(filter="caas", limiter="qlt"), ICS3, "gll"),
    "rho_held": (3, 4, {}, dict(filter="caas", limiter="caas",
                                rho_isl=False), ICS3, "gll"),
}
NSTEPS = 2
DT = 86400.0 * 12 / 6


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_step_option_matches_jax(case):
    ne, np_p, mesh_kw, cfg, ics, measure = STEP_CASES[case]
    mj, mt = meshes(ne, np_p, **mesh_kw)
    kw = dict(ne=ne, np_=np_p, nsub=2, **cfg)
    sj = IslJ(mj, gallery_jax.create_wind("divergent"), CfgJ(**kw))
    st = IslT(mt, gallery_torch.create_wind("divergent"), CfgT(**kw))
    qj = driver_jax.init_tracers(mj, list(ics))
    qt = driver_torch.init_tracers(mt, list(ics))
    rj = jnp.ones((mj.ncell, mj.np2))
    rt = torch.ones((mt.ncell, mt.np2), dtype=torch.float64)
    names = ["rho"] + [f"q{i}" for i in range(len(ics))]
    obs = diag_torch.Observer(mt.dgbfi_gll, mt.dgbfi_sphere, names)
    obs.add_obs(0.0, rt, list(qt))
    for s in range(NSTEPS):
        rj, qj = sj.step(rj, qj, s * DT, (s + 1) * DT)
        rt, qt = st.step(rt, qt, s * DT, (s + 1) * DT)
        obs.add_obs((s + 1) * DT, rt, list(qt))
        assert np.all(np.isfinite(np_(qt))) and np.all(np.isfinite(np_(rt)))
        assert np.abs(np.asarray(rj) - np_(rt)).max() <= 1e-12
        assert np.abs(np.asarray(qj) - np_(qt)).max() <= 1e-12
    if measure is None:
        return
    ok, mass_err, bounds_err = obs.check(measure=measure)
    assert mass_err < 1e-12
    if cfg.get("positive_only"):
        assert min(min(f.min_) for f in obs.fields[1:]) >= 0.0
    elif not cfg.get("fitext"):
        assert ok and bounds_err < 5e-13


def test_unknown_option_values_raise():
    _, mt = meshes(2)
    for bad in (dict(filter="qlt2"), dict(limiter="caas-node"),
                dict(timeint="rk4")):
        with pytest.raises(ValueError):
            IslT(mt, gallery_torch.create_wind("divergent"),
                 CfgT(ne=2, **bad))


# ---------------------------------------------------------------------------
# compose_tpu's non-slow driver tests of these options, on the port.

def test_positive_only_smoke():
    out = driver_torch.run(ne=4, np_=4, nsteps=3, ics=("slottedcylinders",),
                           filter_="qlt-pve", limiter="mn2", nsub=2,
                           verbose=False, device="cpu")
    assert out.min_e >= 0.0
    assert out.max_e <= 2.0
    assert out.cv_gll <= 5e-14
    assert out.max_step_mass_err < 1e-12
    kw = dict(ne=4, np_=4, nsteps=3, ics=("slottedcylinders",),
              limiter="mn2", nsub=2, verbose=False, device="cpu")
    out_cp = driver_torch.run(filter_="caas-pve", **kw)
    out_c = driver_torch.run(filter_="caas", **kw)
    assert out_cp.l2_err == out_c.l2_err


def test_pisl_local_qlt_limiter():
    out = driver_torch.run(ne=4, np_=4, nsteps=3, ics=("cosinebells",),
                           filter_="caas", limiter="qlt", verbose=False,
                           device="cpu")
    assert out.max_step_bounds_err == 0.0
    assert out.cv_gll < 5e-14


def test_nonuniform_mesh_transport():
    out = driver_torch.run(ne=5, np_=4, nsteps=3, ics=("gaussianhills",),
                           filter_="caas", limiter="caas", nonuni=True,
                           verbose=False, device="cpu")
    assert out.cv_gll < 5e-14
    assert out.max_step_bounds_err < 5e-13
    assert out.l2_err < 0.5


def test_line_timeint():
    out = driver_torch.run(ne=4, np_=4, nsteps=3, ics=("gaussianhills",),
                           filter_="caas", limiter="caas", timeint="line",
                           verbose=False, device="cpu")
    assert out.cv_gll < 5e-14
    assert out.max_step_bounds_err < 5e-13
    out = driver_torch.run(ne=3, np_=6, nsteps=3, ics=("gaussianhills",),
                           filter_="caas", limiter="caas",
                           timeint="interpline", verbose=False, device="cpu")
    assert out.cv_gll < 5e-14


def test_driver_dmc_es_checks_the_sphere_measure():
    # dmc es conserves the sphere measure: the per-step check and cv hold
    # there (the GLL measure drifts), as in compose_tpu's driver.
    kw = dict(ne=3, np_=4, nsteps=2, ics=("gaussianhills",), filter_="caas",
              limiter="caas", nsub=2, dmc="es", verbose=False)
    out = driver_torch.run(device="cpu", **kw)
    ref = driver_jax.run(**kw)
    assert out.max_step_mass_err < 1e-12 and out.cv < 5e-14
    assert abs(out.l2_err - ref.l2_err) <= 1e-12
    assert abs(out.max_step_mass_err - ref.max_step_mass_err) <= 1e-14
