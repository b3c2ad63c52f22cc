"""The single-precision route against compose_tpu with x64 off
(jax.enable_x64(False), the counterpart of COMPOSE_TPU_X64=0), on the CPU
at ne4: the mesh tables, K4's plain version, the ISL step and the driver.

- mesh: the port's f32 tables are its f64 tables rounded once; the JAX
  package computes them in f32, so they agree to a few f32 ulp;
- K4 dss_q (f32) vs FaceDss.dss_q and the multi-tracer FaceDss.dss, JAX's
  XLA roll path (its CPU route of the TPU kernel): <= 4 f32 ulp relative
  (the port divides num / den; the XLA path multiplies by 1 / den2 and
  merges in another order), the clip bounds exactly;
- the step, caas/caas and qlt/mn2, both packages on the JAX package's f32
  tables: pointwise <= 1e-4 after each of 3 steps (f32 trajectories round
  differently in XLA and torch), per-step mass change < 1e-6 (measured in
  f64), bounds excess 0;
- driver.run(x64=False): l2 within 1e-5 of the JAX x64-off driver.run.
"""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from compose_tpu import driver as driver_jax
from compose_tpu.mesh import cubed_sphere as cs_jax
from compose_tpu.transport import gallery as gallery_jax
from compose_tpu.transport.dss_face import FaceDss
from compose_tpu.transport.isl import IslConfig as CfgJ
from compose_tpu.transport.isl import IslTransport as IslJ
from compose_tpu_torch import driver as driver_torch
from compose_tpu_torch.mesh import cubed_sphere as cs_torch
from compose_tpu_torch.transport import dss as dss_torch
from compose_tpu_torch.transport import gallery as gallery_torch
from compose_tpu_torch.transport.isl import IslConfig as CfgT
from compose_tpu_torch.transport.isl import IslTransport as IslT

from torch_parity import ICS4, jax_tables, np_

F32 = torch.float32
NSTEPS = 3
DT = 86400.0 * 12 / NSTEPS


@contextlib.contextmanager
def x64_off():
    """compose_tpu with x64 off, with a mesh cache of its own: its meshes
    are cached without regard to the precision they were built in."""
    saved = cs_jax._BUILD_CACHE
    cs_jax._BUILD_CACHE = {}
    try:
        with jax.enable_x64(False):
            yield
    finally:
        cs_jax._BUILD_CACHE = saved


_MESHES = {}


def meshes32(ne):
    """(JAX mesh built with x64 off, port mesh loaded from its f32 tables
    on the CPU)."""
    if ne not in _MESHES:
        with x64_off():
            mj = cs_jax.build(ne, 4)
        mt = cs_torch.from_numpy(jax_tables(mj), "cpu", dtype=F32)
        _MESHES[ne] = (mj, mt)
    return _MESHES[ne]


def test_mesh_f32_tables():
    mj, _ = meshes32(4)
    m64 = cs_torch.build(4, 4, device="cpu")
    m32 = cs_torch.build(4, 4, device="cpu", dtype=F32)
    assert m32.dtype == F32 and m64.dtype == torch.float64
    for name in ("corners", "cgll_xyz", "jac_node", "dgbfi_gll",
                 "dgbfi_sphere"):
        t32, t64 = getattr(m32, name), getattr(m64, name)
        assert t32.dtype == F32
        assert torch.equal(t32, t64.to(F32))
        ref = np.asarray(getattr(mj, name))
        assert ref.dtype == np.float32
        assert np.abs(np_(t32) - ref).max() <= 8 * np.finfo(np.float32).eps \
            * np.abs(ref).max()
    for name in ("dgll2cgll", "c2d_idx", "c2d_mask", "cgll_rep"):
        assert torch.equal(getattr(m32, name), getattr(m64, name))


def _slot_range(q, mj):
    vals = q[:, np.asarray(mj.c2d_idx)]
    mask = np.asarray(mj.c2d_mask)
    d2c = np.asarray(mj.dgll2cgll).reshape(-1)
    return (np.where(mask, vals, np.inf).min(-1)[:, d2c],
            np.where(mask, vals, -np.inf).max(-1)[:, d2c])


def _ulp4(out, ref):
    return np.all(np.abs(out - ref) <= 4 * np.spacing(np.abs(ref)))


def test_dss_q_f32_plain_vs_jax():
    mj, mt = meshes32(4)
    rng = np.random.default_rng(4)
    nt, ndg = 3, mj.ncell * mj.np2
    rho = rng.uniform(0.5, 1.5, ndg)
    # Every slot of some continuous nodes zero (the F-weighted fallback),
    # and some isolated zero slots.
    idx, mask = np.asarray(mj.c2d_idx), np.asarray(mj.c2d_mask)
    nodes = rng.choice(mj.cnn, mj.cnn // 10, replace=False)
    rho[idx[nodes][mask[nodes]]] = 0.0
    rho[rng.random(ndg) < 0.02] = 0.0
    rho = rho.astype(np.float32)
    q = rng.uniform(0.0, 1.0, (nt, ndg)).astype(np.float32)
    with x64_off():
        ref = np.asarray(FaceDss.build(mj).dss_q(
            jnp.asarray(rho.reshape(mj.ncell, -1)),
            jnp.asarray(q.reshape(nt, mj.ncell, -1)))).reshape(nt, -1)
    assert ref.dtype == np.float32
    out = np_(dss_torch.dss_q_gather_t(
        torch.tensor(rho), torch.tensor(q), mt.dgll2cgll.reshape(-1),
        mt.c2d_idx, mt.c2d_mask, mt.dgbfi_gll.reshape(-1)))
    assert out.dtype == np.float32
    assert _ulp4(out, ref)
    lo, hi = _slot_range(q, mj)
    assert np.all(out >= lo) and np.all(out <= hi)


def test_dss_f32_multi_tracer_plain_vs_jax():
    # FaceDss.dss of (nt, ncell, np2) fields with the static weights F.
    mj, mt = meshes32(4)
    nt, ndg = 4, mj.ncell * mj.np2
    f = np.random.default_rng(40).uniform(0.5, 1.5, (nt, ndg)).astype(
        np.float32)
    with x64_off():
        ref = np.asarray(FaceDss.build(mj).dss(
            jnp.asarray(f.reshape(nt, mj.ncell, -1)))).reshape(nt, -1)
    assert ref.dtype == np.float32
    out = np_(dss_torch.dss_gather_t(
        torch.tensor(f), mt.dgll2cgll.reshape(-1), mt.c2d_idx, mt.c2d_mask,
        mt.dgbfi_gll.reshape(-1)))
    assert _ulp4(out, ref)
    lo, hi = _slot_range(f, mj)
    assert np.all(out >= lo) and np.all(out <= hi)


CDRS = [("caas", "caas"), ("qlt", "mn2")]


@pytest.fixture(scope="module")
def runs32():
    """Per config, 3 steps of both packages in f32 from the same state:
    the per-step (rho_j, q_j, rho_t, q_t) as numpy, and F."""
    mj, mt = meshes32(4)
    out = {}
    for filt, lim in CDRS:
        kw = dict(ne=4, filter=filt, limiter=lim, nsub=2)
        st = IslT(mt, gallery_torch.create_wind("divergent"), CfgT(**kw))
        rt = torch.ones((mt.ncell, mt.np2), dtype=F32)
        qt = driver_torch.init_tracers(mt, list(ICS4))
        states = []
        with x64_off():
            sj = IslJ(mj, gallery_jax.create_wind("divergent"), CfgJ(**kw))
            rj = jnp.ones((mj.ncell, mj.np2))
            qj = driver_jax.init_tracers(mj, list(ICS4))
            states.append((np.asarray(rj), np.asarray(qj), np_(rt), np_(qt)))
            for s in range(NSTEPS):
                rj, qj = sj.step(rj, qj, s * DT, (s + 1) * DT)
                rt, qt = st.step(rt, qt, s * DT, (s + 1) * DT)
                states.append((np.asarray(rj), np.asarray(qj), np_(rt),
                               np_(qt)))
        out[(filt, lim)] = states
    return out, np.asarray(mj.dgbfi_gll).astype(np.float64)


@pytest.mark.parametrize("cdr", CDRS, ids=["caas-caas", "qlt-mn2"])
def test_step_f32_route_matches_jax_x64_off(runs32, cdr):
    runs, F = runs32
    states = runs[cdr]
    for rj, qj, rt, qt in states:
        assert rt.dtype == qt.dtype == rj.dtype == qj.dtype == np.float32
        assert rt.shape == rj.shape and qt.shape == qj.shape
    for rj, qj, rt, qt in states[1:]:
        assert np.all(np.isfinite(qt)) and np.all(np.isfinite(rt))
        assert np.abs(rj - rt).max() <= 1e-4
        assert np.abs(qj - qt).max() <= 1e-4
    for k in (0, 2):   # JAX's states, then the port's, in f64
        for prev, cur in zip(states[:-1], states[1:]):
            r0, q0, r1, q1 = (x.astype(np.float64) for x in
                              (prev[k], prev[k + 1], cur[k], cur[k + 1]))
            m0 = (F * r0 * q0).sum((1, 2))
            m1 = (F * r1 * q1).sum((1, 2))
            assert np.max(np.abs(m1 - m0) / np.abs(m0)) < 1e-6
            assert np.all(q1.min((1, 2)) >= q0.min((1, 2)))
            assert np.all(q1.max((1, 2)) <= q0.max((1, 2)))


@pytest.mark.parametrize("filt,lim", CDRS)
def test_driver_x64_off_matches_jax(filt, lim):
    kw = dict(ne=4, nsteps=3, nsub=2, ics=("gaussianhills", "cosinebells"),
              filter_=filt, limiter=lim, verbose=False)
    out = driver_torch.run(x64=False, device="cpu", **kw)
    with x64_off():
        ref = driver_jax.run(**kw)
    assert abs(out.l2_err - ref.l2_err) <= 1e-5
    assert out.max_step_mass_err < 1e-6
    assert out.max_step_bounds_err == 0.0
    assert 0.1 < out.l2_err < 0.2
