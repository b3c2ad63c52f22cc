"""The default pisl CDR's pieces against compose_tpu on the CPU: the QLT
reduction tree, QLT (SHAPEPRESERVE, with root_extra), the spf filters qlt
and mn2, and the mn2 tracer limiter.

f64: <= 1e-13 relative (torch and XLA order some sums differently, and the
mn2 Newton stops at a 1e1 eps residual). f32 (compose_tpu under
jax.enable_x64(False), the same f32 inputs): <= 1e-5 relative, since the
mn2 Newton then never meets its f64-eps tolerance and runs to max_its, and
each f32 rounding difference moves the iterate by an ulp or two. Both: the
total mass to roundoff, and the bounds where the problem is feasible.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from compose_tpu.cdr import qlt as qlt_jax
from compose_tpu.cdr import tree as tree_jax
from compose_tpu.transport import limiter as limiter_jax
from compose_tpu.transport import spf as spf_jax
from compose_tpu_torch.cdr import qlt as qlt_torch
from compose_tpu_torch.cdr import tree as tree_torch
from compose_tpu_torch.transport import limiter as limiter_torch
from compose_tpu_torch.transport import spf as spf_torch

DTYPES = {"f64": (np.float64, torch.float64, 1e-13),
          "f32": (np.float32, torch.float32, 1e-5)}


def _jax_x64(dt):
    """The JAX precision context of a case: x64 as configured for f64,
    off for f32 (every f64 in the JAX package is then f32)."""
    return jax.enable_x64(dt == "f64")


def _rel(out, ref):
    return np.abs(out - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("nleaf,imbalanced", [(24, False), (96, False),
                                              (5400, False), (96, True)])
def test_tree_tables_equal(nleaf, imbalanced):
    tj = tree_jax.build(nleaf, imbalanced)
    tt = tree_torch.build(nleaf, imbalanced)
    assert (tt.nleaf, tt.nnodes, tt.root) == (tj.nleaf, tj.nnodes, tj.root)
    assert len(tt.levels) == len(tj.levels)
    for lt, lj in zip(tt.levels, tj.levels):
        for a, b in zip(lt, lj):
            assert np.array_equal(a, np.asarray(b))


def _records(rng, nt, ncell):
    """Per-cell masses with infeasible cells; tracers 0 and 1 globally
    feasible after the root extra, tracer 2 above sum(max)."""
    rhom = rng.uniform(0.5, 1.5, ncell)
    qmin = rng.uniform(0.0, 0.5, (nt, ncell))
    qmax = qmin + rng.uniform(0.1, 0.5, (nt, ncell))
    Qmin, Qmax = rhom * qmin, rhom * qmax
    Qm = rhom * rng.uniform(-0.1, 1.1, (nt, ncell))
    tgt = Qmin.sum(1) + np.array([0.3, 0.7, 1.2]) * (Qmax - Qmin).sum(1)
    return rhom, Qm, Qmin, Qmax, tgt - Qm.sum(1)


def _check_mass_bounds(out, Qm, Qmin, Qmax, extra, np_dt,
                       infeasible_mass=True):
    """Total mass to roundoff (on globally infeasible rows too unless
    `infeasible_mass` is False: mn2 then returns the nearest bound corner),
    and the bounds on the feasible rows."""
    eps = np.finfo(np_dt).eps
    out = out.astype(np.float64)
    tgt = Qm.astype(np.float64).sum(-1) + extra
    feasible = (Qmin.sum(-1) <= tgt) & (tgt <= Qmax.sum(-1))
    assert feasible.any() and not feasible.all()
    mass_ok = np.abs(out.sum(-1) - tgt) <= 1e2 * eps * np.abs(out).sum(-1)
    assert np.all(mass_ok | (~feasible & (not infeasible_mass)))
    tol = 1e2 * eps * np.abs(Qmax).max()
    assert np.all((out >= Qmin - tol)[feasible])
    assert np.all((out <= Qmax + tol)[feasible])


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_qlt_run_vs_jax(dt):
    np_dt, t_dt, rtol = DTYPES[dt]
    rhom, Qm, Qmin, Qmax, extra = (
        x.astype(np_dt) for x in _records(np.random.default_rng(5), 3, 96))
    with _jax_x64(dt):
        ref = np.asarray(qlt_jax.QLT(96).run(
            *(jnp.asarray(x) for x in (rhom, Qm, Qmin, Qmax)),
            root_extra=jnp.asarray(extra)))
    assert ref.dtype == np_dt
    out = qlt_torch.QLT(96).run(
        *(torch.tensor(x, dtype=t_dt) for x in (rhom, Qm, Qmin, Qmax)),
        root_extra=torch.tensor(extra, dtype=t_dt)).numpy()
    assert out.dtype == np_dt
    assert _rel(out, ref) <= rtol
    _check_mass_bounds(out, Qm, Qmin, Qmax, extra.astype(np.float64), np_dt)


def test_qlt_other_problem_types_raise():
    # Every cedr problem type is ported (test_torch_cedr.py holds each
    # against JAX); what still raises is a bitmask with none of
    # shapepreserve, consistent and nonnegative, which JAX's run refuses
    # too. The once-refused types run here on the spf records.
    for pt in (0, qlt_torch.CONSERVE):
        with pytest.raises(ValueError):
            qlt_torch.QLT(24, problem_type=pt)
    rhom, Qm, Qmin, Qmax, _ = _records(np.random.default_rng(2), 3, 24)
    for pt in (qlt_torch.CONSERVE | qlt_torch.SHAPEPRESERVE,
               qlt_torch.CONSISTENT, qlt_torch.NONNEGATIVE):
        args = (rhom, Qm, Qmin, Qmax, Qm)
        ref = np.asarray(qlt_jax.QLT(24, problem_type=pt).run(
            *(jnp.asarray(x) for x in args)))
        out = qlt_torch.QLT(24, problem_type=pt).run(
            *(torch.tensor(x) for x in args)).numpy()
        assert _rel(out, ref) <= 1e-13


@pytest.mark.parametrize("method", ["qlt", "mn2"])
@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_mass_redistributor_vs_jax(method, dt):
    # The tracer CDR's call, (nt, ncell) records and (nt,) extra masses,
    # and the rho CDR's, (ncell,) records and a scalar extra mass.
    np_dt, t_dt, rtol = DTYPES[dt]
    rhom, Qm, Qmin, Qmax, extra = (
        x.astype(np_dt) for x in _records(np.random.default_rng(9), 3, 96))
    calls = [(rhom, Qmin, Qm, Qmax, extra),
             (rhom, Qmin[0], Qm[0], Qmax[0], extra[0])]
    for args in calls:
        with _jax_x64(dt):
            ref = np.asarray(spf_jax.MassRedistributor(96, method).redistribute(
                *(jnp.asarray(x) for x in args)))
        out = spf_torch.MassRedistributor(96, method).redistribute(
            *(torch.tensor(x, dtype=t_dt) for x in args)).numpy()
        assert out.shape == ref.shape and out.dtype == ref.dtype == np_dt
        assert _rel(out, ref) <= rtol
    full = spf_torch.MassRedistributor(96, method).redistribute(
        *(torch.tensor(x, dtype=t_dt) for x in calls[0])).numpy()
    _check_mass_bounds(full, Qm, Qmin, Qmax, extra.astype(np.float64), np_dt,
                       infeasible_mass=method == "qlt")


def _limiter_inputs(rng, nt, ncell, zero_density, np2=16):
    F = rng.uniform(0.5, 1.5, (ncell, np2)) * 1e-3
    rho = rng.uniform(0.5, 1.5, (ncell, np2))
    if zero_density:
        rho[rng.random((ncell, np2)) < 0.03] = 0.0
    qmin = rng.uniform(0.0, 0.5, (nt, ncell, np2))
    qmax = qmin + rng.uniform(0.0, 0.5, (nt, ncell, np2))
    Q = rng.uniform(-0.2, 1.2, (nt, ncell, np2)) * rho
    rhom = F * rho
    # Cell targets, some outside [sum rhom qmin, sum rhom qmax].
    b = (rhom * rng.uniform(-0.1, 1.1, (nt, ncell, np2))).sum(-1)
    return F, rho, Q, qmin, qmax, rhom, b


@pytest.mark.parametrize("zero_density", [False, True])
@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_limit_tracer_mn2_vs_jax(dt, zero_density):
    np_dt, t_dt, rtol = DTYPES[dt]
    F, rho, Q, qmin, qmax, rhom, b = (x.astype(np_dt) for x in _limiter_inputs(
        np.random.default_rng(31), 3, 40, zero_density))
    Qmin = (rhom * qmin).sum(-1)
    Qmax = (rhom * qmax).sum(-1)
    Qmass = (F * Q).sum(-1)
    args = (Q, qmin, qmax, b - Qmass, b, Qmin, Qmax)
    with _jax_x64(dt):
        lim = jax.vmap(lambda Qi, lo, hi, di, qt, qn, qx:
                       limiter_jax.limit_tracer(
                           jnp.asarray(F), jnp.asarray(rho), Qi, lo, hi, di,
                           limiter="mn2", precomp=(jnp.asarray(rhom), qt, qn,
                                                   qx), return_q=True))
        x = np.asarray(lim(*(jnp.asarray(a) for a in args)))
    # The ISL CDR's zero-density select, which the port's limit_tracer
    # applies itself.
    ref = np.where(rho[None] == 0, qmin, x)
    T = [torch.tensor(a, dtype=t_dt) for a in (F, rho) + args]
    out = limiter_torch.limit_tracer(
        T[0], T[1], T[2], T[3], T[4], T[5], limiter="mn2",
        precomp=(torch.tensor(rhom, dtype=t_dt), T[6], T[7], T[8]),
        return_q=True).numpy()
    assert out.dtype == np_dt
    # In f32 the weight floor 1e-300 rounds to 0: a zero-density node makes
    # w/a = 0/0 and its cell's QP NaN, in both packages alike.
    nan = np.isnan(ref)
    assert np.array_equal(np.isnan(out), nan)
    assert nan.any() == (dt == "f32" and zero_density)
    ok = ~nan
    assert np.abs(out - ref)[ok].max() <= rtol * np.abs(ref[ok]).max()
    assert np.all((out >= qmin)[ok]) and np.all((out <= qmax)[ok])
    feasible = (b >= Qmin) & (b <= Qmax) & ~nan.any(-1)
    mass = (rhom.astype(np.float64) * out).sum(-1)
    scale = np.maximum(np.abs(b), (rhom * np.abs(out)).sum(-1))
    assert feasible.any()
    eps = np.finfo(np_dt).eps
    assert np.all((np.abs(mass - b) <= 1e2 * eps * scale)[feasible])
