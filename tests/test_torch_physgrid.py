"""The physics grid of the port (transport/physgrid.PhysgridOps) against
compose_tpu on the CPU, and the JAX package's physgrid contracts
(tests/test_physgrid.py) on the port.

Tolerances:
  - the fv2gll operator, the FV Jacobians, gll2fv and fv2gll (rho and the
    limited mixing ratios) of every variant: 1e-13 relative to each
    array's largest entry (the setup solves are the same numpy code; the
    remaps' einsums and the CAAS sums round differently in torch and XLA);
  - the contracts at the JAX tests' own bars.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from compose_tpu import driver as driver_jax
from compose_tpu.transport.physgrid import PhysgridOps as PgJ
from compose_tpu_torch import driver as driver_torch
from compose_tpu_torch.transport.physgrid import PhysgridOps as PgT

from torch_parity import meshes, np_, t64

VARIANTS = [(typ, n) for typ in ("idem", "l2", "l2ep", "elrecon")
            for n in (1, 2, 3, 4) if not (typ in ("l2ep", "elrecon")
                                          and n == 1)]


def _rel(a, b):
    a = np.asarray(a)
    return np.abs(a - np_(b)).max() / np.abs(a).max()


def _state(mj, seed=0):
    rng = np.random.default_rng(seed)
    rho = 1.0 + 0.1 * rng.random((mj.ncell, mj.np2))
    q = np.asarray(driver_jax.init_tracers(mj, ("cosinebells",
                                                "gaussianhills")))
    return rho, q


@pytest.mark.parametrize("typ,nphys", VARIANTS)
def test_physgrid_ops_vs_jax(typ, nphys):
    ne = 3 if nphys == 3 else 2
    mj, mt = meshes(ne)
    oj, ot = PgJ(mj, nphys, typ), PgT(mt, nphys, typ)
    assert _rel(oj.op_p_to_d, ot.op_j) <= 1e-13
    assert _rel(oj.fv_met, ot.fv_met) <= 1e-13
    assert _rel(oj.M_dp, ot.M_dp_j) <= 1e-13
    rho, q = _state(mj)
    for limiter in ("caas", "none"):
        rj, qj = oj.gll2fv(jnp.asarray(rho), jnp.asarray(q), limiter)
        rt, qt = ot.gll2fv(t64(rho), t64(q), limiter)
        assert _rel(rj, rt) <= 1e-13 and _rel(qj, qt) <= 1e-13
        rj, qj = oj.fv2gll(rj, qj, limiter=limiter)
        rt, qt = ot.fv2gll(rt, qt, limiter=limiter)
        assert _rel(rj, rt) <= 1e-13 and _rel(qj, qt) <= 1e-13


@pytest.fixture(scope="module")
def setup():
    _, mt = meshes(4)
    pg = PgT(mt, nphys=2)
    rho = 1.0 + 0.1 * torch.sin(3.0 * mt.cell_nodes_xyz[..., 0]).reshape(
        mt.ncell, mt.np2)
    q = driver_torch.init_tracers(mt, ("cosinebells", "gaussianhills"))
    return mt, pg, rho, q


def test_gll2fv_mass_conservation(setup):
    mesh, pg, rho, q = setup
    rho_p, q_p = pg.gll2fv(rho, q, limiter="none")
    m_gll = float(torch.sum(mesh.dgbfi_gll * rho))
    m_fv = float(torch.sum(pg.M_pp_j[None] * pg.fv_met * rho_p))
    assert abs(m_fv - m_gll) / abs(m_gll) < 2e-3
    Qg = float(torch.sum(mesh.dgbfi_gll[None] * q * rho[None]))
    Qf = float(torch.sum((pg.M_pp_j[None] * pg.fv_met)[None] * q_p
                         * rho_p[None]))
    assert abs(Qf - Qg) / abs(Qg) < 2e-3


def test_fv_gll_fv_idempotent(setup):
    mesh, pg, rho, q = setup
    rho_p, q_p = pg.gll2fv(rho, q, limiter="none")
    rho_d, q_d = pg.fv2gll(rho_p, q_p, limiter="none")
    rho_p2, q_p2 = pg.gll2fv(rho_d, q_d, limiter="none")
    assert float(torch.max(torch.abs(rho_p2 - rho_p))) < 1e-11
    assert float(torch.max(torch.abs(q_p2 - q_p))) < 1e-10


def test_constant_preserved(setup):
    mesh, pg, rho, q = setup
    c = torch.full_like(q[:1], 0.42)
    rho_p, c_p = pg.gll2fv(rho, c)
    assert float(torch.max(torch.abs(c_p - 0.42))) < 1e-12
    _, c_d = pg.fv2gll(rho_p, c_p)
    assert float(torch.max(torch.abs(c_d - 0.42))) < 1e-12


def test_limiter_bounds(setup):
    mesh, pg, rho, q = setup
    _, q_p = pg.gll2fv(rho, q, limiter="caas")
    qmin = torch.amin(q, dim=-1)
    qmax = torch.amax(q, dim=-1)
    assert float(torch.max(q_p - qmax[..., None])) < 1e-12
    assert float(torch.min(q_p - qmin[..., None])) > -1e-12


@pytest.mark.parametrize("typ", ["l2", "l2ep", "elrecon"])
@pytest.mark.parametrize("nphys", [2, 3, 4])
def test_fv2gll_variants_constant_and_mass(typ, nphys):
    _, mt = meshes(3)
    ops = PgT(mt, nphys, typ)
    op = ops.op_p_to_d
    nf2 = nphys * nphys
    assert np.abs(op @ np.ones(nf2) - 1.0).max() < 1e-13
    p = np.random.default_rng(0).uniform(0.5, 2.0, nf2)
    m_fv = (4.0 / nf2) * p.sum()
    m_gll = (np_(ops.w_dd) * (op @ p)).sum()
    assert abs(m_gll - m_fv) / m_fv < 1e-13


def test_fv2gll_l2ep_perimeter_mass():
    _, mt = meshes(3)
    ops = PgT(mt, 2, "l2ep")
    p = np.random.default_rng(1).uniform(0.5, 2.0, 4)
    sub = ops.M_dp.T @ (ops.op_p_to_d @ p)
    assert np.abs(sub - p).max() < 1e-12


def test_physgrid_coupled_toychem():
    # tests/test_transport_e2e.py::test_physgrid_coupled_toychem on the
    # port: the toy chemistry on the pg2 grid keeps the tracers within
    # [0, 4e-6]; and the run's tracers against the JAX run's (1e-12).
    kw = dict(ne=4, np_=4, nsteps=3, ics=("toychem1", "toychem2"),
              filter_="caas", limiter="caas", nsub=2, pg=2, verbose=False)
    out = driver_torch.run(device="cpu", **kw)
    assert out.min_e >= 0.0
    assert out.max_e <= 4.0000001e-06
    ref = driver_jax.run(**kw)
    assert abs(out.l2_err - ref.l2_err) <= 1e-12
    assert abs(out.max_e - ref.max_e) <= 1e-12 * ref.max_e
