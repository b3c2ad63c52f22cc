"""The p-refinement experiments of the port (transport/prefine.py and
driver.run(prefine=...)) against compose_tpu on the CPU, at ne3 with a
fine np6 grid over the np4 v grid, nsub 2, 4 tracers.

Tolerances:
  - the v grid's integer tables: equal exactly; the fine grid's
    interpolated Jacobians Jt_f and its Homme measure F_f: 1e-15 absolute
    (one 16-term contraction, summed in another order);
  - two steps of each experiment: rho, q and the carried state (exp 5:
    the fine rho and q; exp 1: the v-grid rho) within 1e-12 of JAX after
    each step (the frameworks round the departure points, the basis
    weights and the CDR sums differently; ~2e-14 seen);
  - driver.run at test_prefine_experiments' bars, a prefine-5 dmc es
    run's per-step mass in the sphere measure it conserves (< 1e-12), and
    the regression battery's ten prefine-5 rows at their own bars.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from compose_tpu import driver as driver_jax
from compose_tpu.transport import gallery as gallery_jax
from compose_tpu.transport import prefine as prefine_jax
from compose_tpu_torch import driver as driver_torch
from compose_tpu_torch.transport import gallery as gallery_torch
from compose_tpu_torch.transport import prefine as prefine_torch

from test_regression_battery import ROWS
from torch_parity import DAY, ICS4, err, meshes, np_, t64

CASES = {
    "exp5_caas_eh": dict(experiment=5, filter="caas", limiter="caas",
                         dmc="eh"),
    "exp5_caasnode_es": dict(experiment=5, filter="caas-node",
                             limiter="caas", dmc="es"),
    "exp1_caas_f": dict(experiment=1, filter="caas", limiter="caas",
                        dmc="f"),
}


def _models(cfg):
    mj, mt = meshes(3, 6)
    kw = dict(ne=3, np_=6, nsub=2, **cfg)
    sj = prefine_jax.PRefineTransport(mj, gallery_jax.create_wind(
        "divergent"), prefine_jax.PRefineConfig(**kw))
    st = prefine_torch.PRefineTransport(mt, gallery_torch.create_wind(
        "divergent"), prefine_torch.PRefineConfig(**kw))
    return mj, sj, st


def test_v_grid_and_fine_measure_vs_jax():
    _, sj, st = _models(CASES["exp1_caas_f"])
    for k in ("dgll2cgll", "cgll_rep", "c2d_idx", "c2d_mask"):
        assert np.array_equal(np.asarray(getattr(sj.mesh_v, k)),
                              np_(getattr(st.mesh_v, k))), k
    assert np.array_equal(np.asarray(sj.own_cell_f), np_(st.own_cell_f))
    assert st.mesh_v.basis_name == "GllOffsetNodal"
    assert err(sj.Jt_f, st.Jt_f) <= 1e-15 and err(sj.F_f, st.F_f) <= 1e-15
    assert err(sj.vw_f, st.vw_f) <= 1e-15
    assert err(sj.C2F, st.C2F) <= 1e-15 and err(sj.F2C, st.F2C) <= 1e-15


@pytest.mark.parametrize("case", list(CASES))
def test_prefine_step_vs_jax(case):
    cfg = CASES[case]
    mj, sj, st = _models(cfg)
    m = sj.mesh_v if cfg["experiment"] == 5 else mj
    qj = driver_jax.init_tracers(m, ICS4)
    rj = jnp.ones((m.ncell, m.np2))
    rt, qt = t64(rj), t64(qj)
    state_j = state_t = None
    for s in range(2):
        rj, qj, state_j = sj.step(rj, qj, s * DAY, (s + 1) * DAY, state_j)
        rt, qt, state_t = st.step(rt, qt, s * DAY, (s + 1) * DAY, state_t)
        assert err(rj, rt) <= 1e-12 and err(qj, qt) <= 1e-12, (case, s)
        if cfg["experiment"] == 5:
            assert err(state_j[0], state_t[0]) <= 1e-12
            assert err(state_j[1], state_t[1]) <= 1e-12
            assert state_t[2] is False
        else:
            assert err(state_j, state_t) <= 1e-12
    assert qt.shape == (4, m.ncell, m.np2)


@pytest.mark.parametrize("exp", [5, 1])
def test_prefine_experiments(exp):
    # tests/test_transport_e2e.py::test_prefine_experiments on the port.
    out = driver_torch.run(ne=3, np_=6, nsteps=3, ics=("gaussianhills",),
                           filter_="caas", limiter="caas", prefine=exp,
                           verbose=False, device="cpu")
    assert out.cv_gll < 5e-14, (exp, out.cv_gll)
    assert out.max_step_bounds_err < 5e-13
    assert out.l2_err < 0.2
    assert out.max_step_mass_err < 1e-12


def test_prefine5_es_mass_checked_in_the_sphere_measure():
    # A prefine-5 dmc es run conserves PRefineTransport.F_v, the sphere
    # measure, on every step. compose_tpu's driver checks step 1 in that
    # measure and every later step in the GLL one, so its per-step mass
    # error reads the difference of the two measures; the port checks
    # every step in F_v.
    kw = dict(ne=3, np_=6, nsteps=3, ics=("gaussianhills",), filter_="caas",
              limiter="caas", prefine=5, dmc="es", verbose=False)
    out = driver_torch.run(device="cpu", **kw)
    assert out.max_step_mass_err < 1e-12
    assert out.cv < 4e-14 and out.max_step_bounds_err < 5e-13
    ref = driver_jax.run(**kw)
    assert ref.max_step_mass_err > 1e-6 and ref.cv < 4e-14
    assert abs(out.l2_err - ref.l2_err) <= 1e-12


PREF5_ROWS = [r for r in ROWS if r[0].startswith("pref5_")]


@pytest.mark.parametrize("row_id,kwargs,asserts",
                         [(r[0], r[2], r[3]) for r in PREF5_ROWS],
                         ids=[r[0] for r in PREF5_ROWS])
def test_pref5_battery_row(row_id, kwargs, asserts):
    # tests/test_regression_battery.py's ten prefine-5 rows (ne6, fine np8,
    # 13 steps) on the port, at the battery's bars.
    out = driver_torch.run(verbose=False, device="cpu", **kwargs)
    assert out.l2_err > 0 or asserts.get("l2", 1) >= 1e-6
    assert out.l2_err <= asserts["l2"], ("l2", out.l2_err)
    for k in ("cv", "cv_gll"):
        if k in asserts:
            assert getattr(out, k) <= asserts[k], (k, getattr(out, k))
    assert out.max_step_mass_err < 1e-12 or kwargs["filter_"] == "none"
