"""The standalone CEDR of the port against compose_tpu on the CPU:
cdr/caas.run, QLT with every problem type and Qm_prev, the reference's
randomized battery, the 1-D periodic transport demo and the spf
redistribution contract, all in f64.

Tolerances:
  - caas.run against JAX: 2 ulp of the largest mass (the same sums on the
    same tree; XLA may contract a multiply-add into an FMA);
  - QLT against JAX: 1e2 eps relative to the largest mass (the node
    solves divide and compare, and a 1-ulp difference in a node's mass
    moves its kids' by a few ulp);
  - the randomized battery (cedr_test_randomized.cpp) at its own bars:
    local bounds exact (3 ulp in the global safety check), bitwise
    no-change, global mass 1e2 eps;
  - the 1-D transport and spf contracts at the JAX tests' own bars.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from compose_tpu.cdr import caas as caas_jax
from compose_tpu.cdr import qlt as qlt_jax
from compose_tpu_torch.cdr import caas as caas_torch
from compose_tpu_torch.cdr import qlt as qlt_torch
from compose_tpu_torch.ops.reduce import bfb_sum
from compose_tpu_torch.transport import spf as spf_torch

import torch_parity  # noqa: F401  (one torch thread per test process)
from test_cdr_randomized import PTS, check, generate, make_tracers, perturb
from test_transport1d import cubic_interp_periodic

EPS = np.finfo(np.float64).eps


def t64(x):
    return torch.tensor(np.asarray(x), dtype=torch.float64)


def _stack(data, group, key):
    return np.stack([data[t.idx][key] for t in group])


def _battery(ncells, seed, keep=lambda t: True):
    rng = np.random.default_rng(seed)
    tracers = [t for t in make_tracers() if keep(t)]
    rhom, data = generate(rng, ncells, tracers)
    for t in tracers:
        perturb(rng, t, rhom, data[t.idx], ncells)
    return tracers, rhom, data


@pytest.mark.parametrize("prev", [False, True])
def test_caas_run_vs_jax(prev):
    tracers, _, data = _battery(111, 3, lambda t: bool(
        t.problem_type & qlt_torch.SHAPEPRESERVE))
    args = [_stack(data, tracers, k) for k in ("Qm", "Qm_min", "Qm_max")]
    Qp = _stack(data, tracers, "Qm_prev") if prev else None
    ref = np.asarray(caas_jax.run(*map(jnp.asarray, args),
                                  Qm_prev=None if Qp is None
                                  else jnp.asarray(Qp)))
    out = caas_torch.run(*map(t64, args),
                         Qm_prev=None if Qp is None else t64(Qp)).numpy()
    assert np.abs(out - ref).max() <= 2 * EPS * np.abs(ref).max()


@pytest.mark.parametrize("pt", PTS)
def test_qlt_problem_type_vs_jax(pt):
    tracers, rhom, data = _battery(111, 5, lambda t: t.problem_type == pt)
    args = [_stack(data, tracers, k)
            for k in ("Qm", "Qm_min", "Qm_max", "Qm_prev")]
    ref = np.asarray(qlt_jax.QLT(111, problem_type=pt).run(
        jnp.asarray(rhom), *map(jnp.asarray, args)))
    out = qlt_torch.QLT(111, problem_type=pt).run(t64(rhom),
                                                  *map(t64, args)).numpy()
    assert np.abs(out - ref).max() <= 1e2 * EPS * np.abs(ref).max()


@pytest.mark.parametrize("ncells,imbalanced", [(11, False), (111, False),
                                               (111, True), (64, False)])
def test_qlt_randomized(ncells, imbalanced):
    tracers, rhom, data = _battery(ncells, 42 + ncells)
    out = {}
    for pt in PTS:
        group = [t for t in tracers if t.problem_type == pt]
        solver = qlt_torch.QLT(ncells, problem_type=pt,
                               imbalanced_tree=imbalanced)
        res = solver.run(t64(rhom), *(t64(_stack(data, group, k)) for k in
                                      ("Qm", "Qm_min", "Qm_max", "Qm_prev")))
        for k, t in enumerate(group):
            out[t.idx] = res[k].numpy()
    assert check(tracers, rhom, data, out) == 0


@pytest.mark.parametrize("ncells", [11, 111])
def test_caas_randomized(ncells):
    tracers, rhom, data = _battery(
        ncells, 7 + ncells, lambda t: bool(
            t.problem_type & qlt_torch.SHAPEPRESERVE) and t.local_should_hold)
    out = {}
    for conserve in (False, True):
        group = [t for t in tracers
                 if bool(t.problem_type & qlt_torch.CONSERVE) == conserve]
        res = caas_torch.run(
            *(t64(_stack(data, group, k)) for k in ("Qm", "Qm_min", "Qm_max")),
            Qm_prev=t64(_stack(data, group, "Qm_prev")) if conserve else None)
        for k, t in enumerate(group):
            out[t.idx] = res[k].numpy()
    assert check(tracers, rhom, data, out) == 0


@pytest.mark.parametrize("method", ["qlt_shape", "qlt_nonneg", "caas"])
def test_transport1d(method):
    # tests/test_transport1d.py on the port's solvers, its bars unchanged.
    n, nsteps, u = 111, 150, 0.8
    x = np.arange(n, dtype=float)
    q0 = np.where(np.abs(x - n / 3) < n / 10, 1.0, 0.1)
    q0 += 0.5 * np.exp(-((x - 2 * n / 3) / (n / 15)) ** 2)
    rho = t64(np.ones(n))
    pt = {"qlt_shape": qlt_torch.SHAPEPRESERVE | qlt_torch.CONSERVE
          | qlt_torch.CONSISTENT,
          "qlt_nonneg": qlt_torch.NONNEGATIVE | qlt_torch.CONSERVE}
    solver = qlt_torch.QLT(n, problem_type=pt[method]) if method in pt \
        else None
    q = q0.copy()
    mass0 = q.sum()
    gmin, gmax = q0.min(), q0.max()
    for _ in range(nsteps):
        q_new, lo, hi = cubic_interp_periodic(q, x - u)
        Qm, Qm_min, Qm_max, Qm_prev = (t64(a[None]) for a in
                                       (q_new, lo, hi, q))
        if solver is None:
            out = caas_torch.run(Qm, Qm_min, Qm_max, Qm_prev=Qm_prev)
        else:
            out = solver.run(rho, Qm, Qm_min, Qm_max, Qm_prev)
        q = out[0].numpy()
        assert abs(q.sum() - mass0) / abs(mass0) < 1e2 * EPS * nsteps
        if method != "qlt_nonneg":
            assert q.min() >= gmin - 1e-12
            assert q.max() <= gmax + 1e-12
        else:
            assert q.min() >= -3 * EPS
    ref = np.roll(q0, int(round(u * nsteps)) % n)
    l2 = np.sqrt(np.mean((q - ref) ** 2)) / np.sqrt(np.mean(ref ** 2))
    assert l2 < 0.35, l2


# tests/test_spf.py on the port's spf.MassRedistributor, its bars unchanged.
def _random_problem(ncell, rng):
    rho_mass = rng.uniform(0.5, 1.5, ncell)
    q_min = rng.uniform(0.0, 0.4, ncell)
    q_max = q_min + rng.uniform(0.2, 0.6, ncell)
    t = rng.uniform(-0.2, 1.2, ncell)
    Q_min, Q_max = rho_mass * q_min, rho_mass * q_max
    return rho_mass, Q_min, Q_min + t * (Q_max - Q_min), Q_max


def _redistribute(method, ncell, rho_mass, Q_min, Q, Q_max, extra):
    mrd = spf_torch.MassRedistributor(ncell, method)
    return mrd.redistribute(t64(rho_mass), t64(Q_min), t64(Q), t64(Q_max),
                            extra).numpy()


@pytest.mark.parametrize("method", ["caas", "qlt", "mn2"])
@pytest.mark.parametrize("ncell", [96, 101])
def test_spf_redistribute_contract(method, ncell):
    rho_mass, Q_min, Q, Q_max = _random_problem(ncell,
                                                np.random.default_rng(7))
    extra = 0.01 * float(Q.sum())
    out = _redistribute(method, ncell, rho_mass, Q_min, Q, Q_max,
                        t64(extra))
    tot_in = float(bfb_sum(t64(Q))) + extra
    assert abs(out.sum() - tot_in) < 1e-12 * abs(tot_in)
    assert (out - Q_min).min() > -1e-12
    assert (Q_max - out).min() > -1e-12


@pytest.mark.parametrize("method", ["caas", "qlt", "mn2"])
def test_spf_no_change_when_feasible(method):
    ncell = 64
    rng = np.random.default_rng(3)
    rho_mass = rng.uniform(0.5, 1.5, ncell)
    Q = rho_mass * rng.uniform(0.2, 0.8, ncell)
    out = _redistribute(method, ncell, rho_mass, rho_mass * 0.1, Q,
                        rho_mass * 0.9, t64(0.0))
    assert np.abs(out - Q).max() < 1e-13


def test_spf_qlt_root_mass_contract_at_saturation():
    ncell = 128
    rng = np.random.default_rng(11)
    rho_mass = rng.uniform(0.5, 1.5, ncell)
    Q_max = rho_mass.copy()
    Q = Q_max.copy()
    Q[17] = 0.5 * Q_max[17]
    extra = 0.5 * (Q_max[17] - Q[17])
    out = _redistribute("qlt", ncell, rho_mass, np.zeros(ncell), Q, Q_max,
                        t64(extra))
    tot_in = float(bfb_sum(t64(Q))) + extra
    assert abs(out.sum() - tot_in) < 1e-12 * abs(tot_in)
    assert (Q_max - out).min() > -1e-12
    assert abs(out[17] - (Q[17] + extra)) < 1e-10


def test_spf_qlt_batched_tracers():
    ncell, nt = 96, 5
    rng = np.random.default_rng(5)
    rho_mass = rng.uniform(0.5, 1.5, ncell)
    Q_max = np.broadcast_to(rho_mass, (nt, ncell)).copy()
    Q = rho_mass * rng.uniform(0.2, 0.8, (nt, ncell))
    extra = 0.01 * Q.sum(axis=-1)
    out = _redistribute("qlt", ncell, rho_mass, np.zeros((nt, ncell)), Q,
                        Q_max, t64(extra))
    for t in range(nt):
        tot = float(bfb_sum(t64(Q[t]))) + extra[t]
        assert abs(out[t].sum() - tot) < 1e-12 * abs(tot)
    assert out.min() > -1e-12
    assert (Q_max - out).min() > -1e-12
