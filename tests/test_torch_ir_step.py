"""IrTransport.step of the port against the JAX step on the CPU, one case
per option set (the mixed `isl` method's step is in test_torch_ir.py).
Both packages get the same tables: the port's mesh and IR data are loaded
from the JAX mesh's and IrData's numpy arrays (torch_parity.ir_models).
ne3 (ne2 for the subcell meshes, refined to ne6 np2), nsub 2, 4 tracers,
2 steps of one day, f64.

Tolerance: 1e-12 pointwise on rho and every tracer after each step (the
frameworks' f64 kernels differ by a few ulp in the quadrature sums and the
triangular solves; ~1e-14 seen). The one-day step keeps the advected
cells from folding at ne3: at four days the unfiltered remap divides by
densities near 0.02, and the nondivergent flow folds cells, where a 1-ulp
difference in a clip decides which overlap a point falls in.
"""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp

from compose_tpu import driver as driver_jax
from compose_tpu_torch.mesh import cubed_sphere as cs_torch
from compose_tpu_torch.ops.reduce import bfb_sum
from compose_tpu_torch.transport import gallery as gallery_torch
from compose_tpu_torch.transport import ir as ir_torch

from torch_parity import DAY, ICS4, err, ir_models, meshes, np_, t64

# id: (ne, np, mesh_type, IrConfig options)
CASES = {
    "ir_none_d2c": (3, 4, "geometric", dict(method="ir")),
    "cdg_es_qlt_mn2": (3, 4, "geometric", dict(method="cdg", dmc="es",
                                               filter="qlt", limiter="mn2")),
    "ir_f_caas_caas": (3, 4, "geometric", dict(method="ir", dmc="f",
                                               filter="caas",
                                               limiter="caas")),
    "ir_geh_nod2c": (3, 4, "geometric", dict(method="ir", dmc="geh",
                                             d2c=False)),
    "ir_eh_caas_mn2": (3, 4, "geometric", dict(method="ir", dmc="eh",
                                               filter="caas", limiter="mn2",
                                               d2c=False)),
    "cdg_ef_mn2_caags": (3, 4, "geometric", dict(method="cdg", dmc="ef",
                                                 filter="mn2",
                                                 limiter="caags",
                                                 d2c=False)),
    "cdg_f_qlt_caas_np3": (3, 3, "geometric", dict(method="cdg", dmc="f",
                                                   filter="qlt",
                                                   limiter="caas")),
    "gllsubcell_cdg_ef": (2, 4, "gllsubcell", dict(method="cdg", dmc="ef",
                                                   filter="qlt",
                                                   limiter="mn2", tq=4,
                                                   d2c=False)),
    "runisubcell_cdg_ef": (2, 4, "runisubcell", dict(method="cdg", dmc="ef",
                                                     filter="caas",
                                                     limiter="caags", tq=4)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_ir_step_vs_jax(case):
    ne, n, mesh_type, cfg = CASES[case]
    mj, sj, st = ir_models(ne, n, mesh_type, cfg)
    qj = driver_jax.init_tracers(mj, ICS4)
    rj = jnp.ones((mj.ncell, mj.np2))
    rt, qt = t64(rj), t64(qj)
    for s in range(2):
        rj, qj = sj.step(rj, qj, s * DAY, (s + 1) * DAY)
        rt, qt = st.step(rt, qt, s * DAY, (s + 1) * DAY)
        assert err(rj, rt) <= 1e-12 and err(qj, qt) <= 1e-12, (s, case)
    assert rt.shape == (mj.ncell, mj.np2) and qt.shape == (4, mj.ncell,
                                                          mj.np2)
    if cfg.get("filter", "none") != "none":
        # Filtered: the tracers stay in the initial range.
        q0 = np.asarray(driver_jax.init_tracers(mj, ICS4))
        lo, hi = q0.min(axis=(1, 2)), q0.max(axis=(1, 2))
        qn = np_(qt)
        assert (qn.min(axis=(1, 2)) >= lo - 5e-13).all()
        assert (qn.max(axis=(1, 2)) <= hi + 5e-13).all()


@pytest.mark.parametrize("method", ["cdg", "ir"])
def test_facet_f_mass_holds_whatever_the_factor(method):
    # Under dmc f the port enforces both facet identities (T's column sums
    # = w2 through the facet factor, w2' Mref^-1 = 1' through the pinned
    # solve), so the mass drift does not depend on the last bits of the
    # mass-matrix factor, which differ between machines: a few ulp of noise
    # on chol_ref leaves the drift of 6 steps at ne4 under 1e-15 (relative;
    # each defect the identities remove is a few ulp per step).
    mesh = cs_torch.build(4, 4, device="cpu")
    st = ir_torch.IrTransport(mesh, gallery_torch.create_wind("divergent"),
                              ir_torch.IrConfig(ne=4, nsub=2, method=method,
                                                dmc="f", d2c=False))
    rng = np.random.default_rng(7)
    L = st.ird.chol_ref
    noise = 1 + rng.integers(-3, 4, tuple(L.shape)) * 2.2e-16
    st.ird = dataclasses.replace(st.ird, chol_ref=L * t64(noise))
    rho = t64(np.ones((mesh.ncell, mesh.np2)))
    q = t64(np.asarray(driver_jax.init_tracers(meshes(4)[0], ICS4[:1])))

    def mass(rho, q):
        return float(bfb_sum((mesh.dgbfi_gll * rho * q[0]).reshape(-1)))

    m0 = mass(rho, q)
    for s in range(6):
        rho, q = st.step(rho, q, s * DAY, (s + 1) * DAY)
    assert abs(mass(rho, q) - m0) / m0 < 1e-15


@pytest.mark.parametrize("dmc", ["none", "es"])
def test_cdg_mass_under_table_noise(dmc):
    # CDG under dmc none and es solves with the per-cell sphere mass
    # matrices (IrData.chol). The same few ulp of noise on their factors
    # moves the drift over 3 steps at ne3, in IrTransport.F_mass (the
    # sphere measure), by under 1e-15: no table-dependent drift as under
    # dmc f. es conserves to roundoff with and without the noise; none
    # does not enforce the mass, and its drift is the T quadrature's, the
    # same with the noise.
    mesh = cs_torch.build(3, 4, device="cpu")
    q0 = t64(np.asarray(driver_jax.init_tracers(meshes(3)[0], ICS4[:1])))
    drift = {}
    for noisy in (False, True):
        st = ir_torch.IrTransport(
            mesh, gallery_torch.create_wind("divergent"),
            ir_torch.IrConfig(ne=3, nsub=2, method="cdg", dmc=dmc,
                              d2c=False))
        assert st.F_mass is mesh.dgbfi_sphere
        if noisy:
            rng = np.random.default_rng(7)
            L = st.ird.chol
            noise = 1 + rng.integers(-3, 4, tuple(L.shape)) * 2.2e-16
            st.ird = dataclasses.replace(st.ird, chol=L * t64(noise))
        rho, q = t64(np.ones((mesh.ncell, mesh.np2))), q0

        def mass(rho, q):
            return float(bfb_sum((st.F_mass * rho * q[0]).reshape(-1)))

        m0 = mass(rho, q)
        for s in range(3):
            rho, q = st.step(rho, q, s * DAY, (s + 1) * DAY)
        drift[noisy] = (mass(rho, q) - m0) / m0
    assert abs(drift[True] - drift[False]) < 1e-15
    if dmc == "es":
        assert abs(drift[True]) < 1e-15
