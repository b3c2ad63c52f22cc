"""Reductions and the plain versions of the port's three kernels against
compose_tpu's references (CPU, where every kernel wrapper takes its plain
PyTorch version):

  - bfb_sum / bfb_sum_cells: bitwise (the same IEEE adds in the same tree);
  - K1 glbl_caas vs spf.glbl_caas: <= 2 ulp, mass to 1e2 eps, bounds when
    feasible to roundoff. The sums are bitwise (same bfb tree); the last
    op differs because XLA's CPU backend contracts (mass + delta) + fac*v
    into one FMA (1 ulp seen), which the port never does;
  - K2 limit_caas vs limiter.limit_tracer(caas, precomp, return_q): 1e-14
    (the 16-node cell sums are adjacent-pair folds here, XLA's order
    there), bounds exactly, cell mass to 1e2 eps;
  - K3 dss_q vs dss.dss_q_gather_t and FaceDss.dss_q: 1e-15 relative
    (summation order of <= 4 terms), output inside the slot range exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from compose_tpu.ops import local_qp as local_qp_jax
from compose_tpu.ops import reduce as reduce_jax
from compose_tpu.transport import dss as dss_jax
from compose_tpu.transport import limiter as limiter_jax
from compose_tpu.transport import spf as spf_jax
from compose_tpu.transport.dss_face import FaceDss
from compose_tpu_torch.ops import local_qp as local_qp_torch
from compose_tpu_torch.ops import reduce as reduce_torch
from compose_tpu_torch.transport import cdr_fused, dss as dss_torch
from compose_tpu_torch.transport import limiter as limiter_torch

from torch_parity import meshes, np_, t64

EPS = np.finfo(np.float64).eps


def ulps(a, b):
    return np.max(np.abs(a - b) / np.spacing(np.maximum(np.abs(a),
                                                        np.abs(b))))


@pytest.mark.parametrize("n", [1, 2, 7, 96, 1000, 5400])
def test_bfb_sum_bitwise(n):
    x = np.random.default_rng(n).normal(size=(3, n)) * 1e3
    assert np.array_equal(np.asarray(reduce_jax.bfb_sum(jnp.asarray(x))),
                          np_(reduce_torch.bfb_sum(t64(x))))
    assert np.array_equal(
        np.asarray(reduce_jax.bfb_sum(jnp.asarray(x.T), axis=0)),
        np_(reduce_torch.bfb_sum(t64(x.T), dim=0)))


@pytest.mark.parametrize("shape", [(96, 16), (2, 3, 96, 16), (5, 9)])
def test_bfb_sum_cells_bitwise(shape):
    x = np.random.default_rng(3).uniform(-1, 1, shape)
    assert np.array_equal(np.asarray(reduce_jax.bfb_sum_cells(jnp.asarray(x))),
                          np_(reduce_torch.bfb_sum_cells(t64(x))))


def _records(rng, nt, ncell, feasible):
    mn = rng.uniform(0.0, 1.0, (nt, ncell))
    mx = mn + rng.uniform(0.1, 1.0, (nt, ncell))
    ms = rng.uniform(-0.5, 2.5, (nt, ncell))        # out-of-bounds cells
    if feasible:
        tgt = mn.sum(1) + rng.uniform(0.2, 0.8, nt) * (mx - mn).sum(1)
    else:
        tgt = mx.sum(1) * 1.5                          # above sum(max)
    return mn, ms, mx, tgt - ms.sum(1)


@pytest.mark.parametrize("feasible", [True, False])
def test_glbl_caas_plain_vs_jax(feasible):
    mn, ms, mx, ex = _records(np.random.default_rng(17), 3, 96, feasible)
    ref = np.asarray(spf_jax.glbl_caas(*(jnp.asarray(a) for a in
                                         (mn, ms, mx, ex))))
    out = np_(cdr_fused.glbl_caas(*(t64(a) for a in (mn, ms, mx, ex))))
    assert ulps(out, ref) <= 2
    tgt = ms.sum(1) + ex
    assert np.all(np.abs(out.sum(1) - tgt) <= 1e2 * EPS * np.abs(tgt))
    if feasible:
        assert np.all(out >= mn - 1e2 * EPS * np.abs(mn))
        assert np.all(out <= mx + 1e2 * EPS * np.abs(mx))


def test_glbl_caas_single_row():
    # The rho CDR's call: (ncell,) records and a scalar extra mass.
    mn, ms, mx, ex = _records(np.random.default_rng(2), 1, 96, True)
    ref = np.asarray(spf_jax.glbl_caas(jnp.asarray(mn[0]), jnp.asarray(ms[0]),
                                       jnp.asarray(mx[0]), float(ex[0])))
    out = cdr_fused.glbl_caas(t64(mn[0]), t64(ms[0]), t64(mx[0]),
                              torch.tensor(ex[0], dtype=torch.float64))
    assert out.shape == (96,) and ulps(np_(out), ref) <= 2


def _limiter_inputs(rng, nt, ncell, np2=16):
    F = rng.uniform(0.5, 1.5, (ncell, np2)) * 1e-3
    rho = rng.uniform(0.5, 1.5, (ncell, np2))
    rho[rng.random((ncell, np2)) < 0.05] = 0.0           # zero-density nodes
    qmin = rng.uniform(0.0, 0.5, (nt, ncell, np2))
    qmax = qmin + rng.uniform(0.0, 0.5, (nt, ncell, np2))
    Q = rng.uniform(-0.2, 1.2, (nt, ncell, np2)) * rho
    rhom = F * rho
    # Cell targets, some outside [sum rhom qmin, sum rhom qmax].
    b = (rhom * rng.uniform(-0.1, 1.1, (nt, ncell, np2))).sum(-1)
    return F, rho, Q, qmin, qmax, rhom, b


def test_limit_caas_plain_vs_jax():
    F, rho, Q, qmin, qmax, rhom, b = _limiter_inputs(
        np.random.default_rng(23), 3, 40)
    Qmin = (rhom * qmin).sum(-1)
    Qmax = (rhom * qmax).sum(-1)
    Qmass = (F * Q).sum(-1)
    lim = jax.vmap(lambda Qi, lo, hi, di, qt, qn, qx:
                   limiter_jax.limit_tracer(
                       jnp.asarray(F), jnp.asarray(rho), Qi, lo, hi, di,
                       limiter="caas", precomp=(jnp.asarray(rhom), qt, qn,
                                                qx), return_q=True))
    x = lim(*(jnp.asarray(a) for a in (Q, qmin, qmax, b - Qmass, b, Qmin,
                                       Qmax)))
    ref = np.where(rho[None] == 0, qmin, np.asarray(x))
    out = np_(limiter_torch.limit_tracer(
        t64(F), t64(rho), t64(Q), t64(qmin), t64(qmax), t64(b - Qmass),
        precomp=(t64(rhom), t64(b), t64(Qmin), t64(Qmax)), return_q=True))
    assert np.abs(out - ref).max() <= 1e-14
    assert np.all(out >= qmin) and np.all(out <= qmax)
    feasible = (b >= Qmin) & (b <= Qmax)
    mass = (rhom * out).sum(-1)
    scale = np.maximum(np.abs(b), (rhom * np.abs(out)).sum(-1))
    assert feasible.any()
    assert np.all((np.abs(mass - b) <= 1e2 * EPS * scale)[feasible])


def _zero_density_rho(mesh_j, rng, frac=0.1):
    """Nodal density with every slot of some continuous nodes zero (the
    K3 F-weighted fallback) and some isolated zero slots."""
    ndg = mesh_j.ncell * mesh_j.np2
    rho = rng.uniform(0.5, 1.5, ndg)
    idx, mask = np.asarray(mesh_j.c2d_idx), np.asarray(mesh_j.c2d_mask)
    nodes = rng.choice(mesh_j.cnn, int(frac * mesh_j.cnn), replace=False)
    rho[idx[nodes][mask[nodes]]] = 0.0
    rho[rng.random(ndg) < 0.02] = 0.0
    return rho


@pytest.mark.parametrize("ne", [3, 4])
def test_dss_q_plain_vs_jax(ne):
    mj, mt = meshes(ne)
    rng = np.random.default_rng(ne)
    nt, ndg = 3, mj.ncell * mj.np2
    rho = _zero_density_rho(mj, rng)
    q = rng.uniform(0.0, 1.0, (nt, ndg))
    F = np.asarray(mj.dgbfi_gll).reshape(-1)
    out = np_(dss_torch.dss_q_gather_t(t64(rho), t64(q),
                                       mt.dgll2cgll.reshape(-1), mt.c2d_idx,
                                       mt.c2d_mask, t64(F)))
    ref_g = np.asarray(dss_jax.dss_q_gather_t(
        jnp.asarray(rho), jnp.asarray(q), mj.dgll2cgll.reshape(-1),
        mj.c2d_idx, mj.c2d_mask, jnp.asarray(F)))
    ref_f = np.asarray(FaceDss.build(mj).dss_q(
        jnp.asarray(rho.reshape(mj.ncell, -1)),
        jnp.asarray(q.reshape(nt, mj.ncell, -1)))).reshape(nt, -1)
    for ref in (ref_g, ref_f):
        assert np.abs(out - ref).max() <= 1e-15 * np.abs(ref).max()
    vals = q[:, np.asarray(mj.c2d_idx)]
    mask = np.asarray(mj.c2d_mask)
    d2c = np.asarray(mj.dgll2cgll).reshape(-1)
    lo = np.where(mask, vals, np.inf).min(-1)[:, d2c]
    hi = np.where(mask, vals, -np.inf).max(-1)[:, d2c]
    assert np.all(out >= lo) and np.all(out <= hi)
    # Continuity: every slot of a node holds the same value.
    assert np.array_equal(out, out[:, np.asarray(mj.cgll_rep)][:, d2c])


@pytest.mark.parametrize("ne", [3, 4])
def test_dss_rho_plain_vs_jax(ne):
    # The density DSS: weights F, no fallback (F > 0).
    mj, mt = meshes(ne)
    f = np.random.default_rng(30 + ne).uniform(0.5, 1.5, (1, mj.ncell * 16))
    F = np.asarray(mj.dgbfi_gll).reshape(-1)
    out = np_(dss_torch.dss_gather_t(t64(f), mt.dgll2cgll.reshape(-1),
                                     mt.c2d_idx, mt.c2d_mask, t64(F)))
    ref_g = np.asarray(dss_jax.dss_gather_t(
        jnp.asarray(f), mj.dgll2cgll.reshape(-1), mj.c2d_idx, mj.c2d_mask,
        jnp.asarray(F)))
    ref_f = np.asarray(FaceDss.build(mj).dss(
        jnp.asarray(f.reshape(mj.ncell, -1)))).reshape(1, -1)
    for ref in (ref_g, ref_f):
        assert np.abs(out - ref).max() <= 1e-15 * np.abs(ref).max()


@pytest.mark.parametrize("qp_branch", [False, True])
def test_limit_density_vs_jax(qp_branch):
    # Without the QP branch the arithmetic is elementwise plus 16-term
    # sums (1e-15); the mn2 QP branch iterates to its residual tolerance
    # (1e1 eps relative), held to 1e-13.
    rng = np.random.default_rng(41)
    ncell = 24
    F = rng.uniform(0.5, 1.5, (ncell, 16)) * 1e-3
    rho = rng.uniform(-0.1, 1.0, (ncell, 16))
    extra = rng.uniform(-0.5, 0.5, ncell) * 1e-3
    if not qp_branch:
        rho = np.abs(rho) + 0.5
        extra = np.abs(extra) * 1e-3
    ref = np.asarray(limiter_jax.limit_density(
        jnp.asarray(F), jnp.asarray(rho), jnp.asarray(extra)))
    out = np_(limiter_torch.limit_density(t64(F), t64(rho), t64(extra)))
    assert np.abs(out - ref).max() <= (1e-13 if qp_branch else 1e-15)
    assert np.all(out >= 0)
    mass = (F * out).sum(-1)
    tgt = (F * rho).sum(-1) + extra
    assert np.all(np.abs(mass - tgt) <= 1e2 * EPS * np.abs(tgt).max())


def _qp_inputs(seed, shape=(4, 30, 16)):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 1.5, shape)
    xlo = rng.uniform(0.0, 0.5, shape)
    xhi = xlo + rng.uniform(0.0, 0.5, shape)
    y = rng.uniform(-0.2, 1.2, shape)
    # Targets inside and outside [sum a xlo, sum a xhi].
    b = (a * rng.uniform(-0.1, 1.1, shape)).sum(-1)
    return a, b, xlo, xhi, y


def test_caas_gsum_vs_jax():
    # The caas-node global CAAS over all DGLL slots with bfb_sum: the sums
    # are bitwise (same tree), the rest elementwise; 1e-13 stated.
    a, b, xlo, xhi, y = _qp_inputs(21, (3, 1350))
    b = (a * (0.3 * xlo + 0.7 * xhi)).sum(-1) * np.array([0.9, 1.0, 1.2])
    xj = local_qp_jax.caas_gsum(*map(jnp.asarray, (a, b, xlo, xhi, y)),
                                gsum=reduce_jax.bfb_sum)
    xt = local_qp_torch.caas_gsum(*map(t64, (a, b, xlo, xhi, y)),
                                  gsum=reduce_torch.bfb_sum)
    assert np.abs(np.asarray(xj) - np_(xt)).max() <= 1e-13
    assert np.all(np_(xt) >= xlo) and np.all(np_(xt) <= xhi)


def test_clip_and_weighted_sum_vs_jax():
    a, b, xlo, xhi, y = _qp_inputs(22)
    xj = local_qp_jax.clip_and_weighted_sum(*map(jnp.asarray,
                                                 (a, b, xlo, xhi, y)))
    xt = local_qp_torch.clip_and_weighted_sum(*map(t64, (a, b, xlo, xhi, y)))
    assert np.abs(np.asarray(xj) - np_(xt)).max() <= 1e-13
    assert np.all(np_(xt) >= xlo) and np.all(np_(xt) <= xhi)


@pytest.mark.parametrize("method", ["caas", "mn2"])
def test_solve_1eq_nonneg_vs_jax(method):
    # Lanes with b < 0 are infeasible (info -1, y returned).
    a, b, _, _, y = _qp_inputs(23)
    b = b - np.median(b)
    assert (b < 0).any() and (b >= 0).any()
    w = np.random.default_rng(24).uniform(0.5, 1.5, a.shape)
    xj, ij = local_qp_jax.solve_1eq_nonneg(*map(jnp.asarray, (a, b, y, w)),
                                           method=method)
    xt, it = local_qp_torch.solve_1eq_nonneg(*map(t64, (a, b, y, w)),
                                             method=method)
    assert np.array_equal(np.asarray(ij), np_(it))
    assert np.abs(np.asarray(xj) - np_(xt)).max() <= 1e-13
