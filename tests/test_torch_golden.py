"""The reference's golden rows of the ISL options that the port now runs,
through the port's driver.run on the CPU, held to the bars that
tests/test_transport_e2e.py and tests/test_regression_battery.py hold the
JAX package to: pisl np6 (the Islet GllNodal np6 node subsets), pisl
qlt-pve ne10, the three pisl np12 runs (exact and interpolated
trajectories), and the four prefine-0 rows (ne6 np8, interpolated
trajectories, caas or caas-node, dmc es or eh). The port's step agrees with
the JAX step to 1e-12 per step (test_torch_options.py), so these bars hold
as they do there; the port's CPU runs take seconds.
"""

import pytest

from compose_tpu_torch import driver

ICS = ("slottedcylinders", "cosinebells", "gaussianhills")
GH = ("gaussianhills",)
STEP = dict(cv_gll=5e-14, min=0.1, max=1.0, step=True)
PREF = dict(ne=6, np_=8, nsteps=13, ics=GH, timeint="interp")

# id: (driver.run arguments, bars)
ROWS = {
    "pisl_qlt_np6": (dict(ne=6, np_=6, ics=ICS, filter_="qlt",
                          limiter="mn2"), dict(STEP, l2=3.34e-1)),
    "pisl_qlt_pve_ne10": (dict(ne=10, ics=ICS, filter_="qlt-pve",
                               limiter="mn2"),
                          dict(STEP, l2=3.36e-1, min=0.0, max=2.0)),
    "pisl_np12_exact": (dict(ne=3, np_=12, ics=GH, filter_="none",
                             limiter="none"), dict(l2=8.793e-3)),
    "pisl_np12_interp": (dict(ne=3, np_=12, ics=GH, filter_="none",
                              limiter="none", timeint="interp"),
                         dict(l2=9.939e-3)),
    "pisl_np12_interp_caas": (dict(ne=3, np_=12, ics=("slottedcylinders",),
                                   filter_="caas", limiter="mn2",
                                   timeint="interp"),
                              dict(l2=2.896e-1, cv_gll=5e-14, min=0.1,
                                   max=1.0)),
    "pref0_es_caas": (dict(PREF, filter_="caas", limiter="caas", dmc="es"),
                      dict(l2=5.968e-3, cv=2e-14)),
    "pref0_eh_caas": (dict(PREF, filter_="caas", limiter="caas", dmc="eh"),
                      dict(l2=5.968e-3, cv_gll=2e-14)),
    "pref0_es_caasnode": (dict(PREF, filter_="caas-node", limiter="caas",
                               dmc="es"), dict(l2=5.968e-3, cv=2e-14)),
    "pref0_eh_caasnode": (dict(PREF, filter_="caas-node", limiter="caas",
                               dmc="eh"), dict(l2=5.968e-3, cv_gll=2e-14)),
}


@pytest.mark.parametrize("row", list(ROWS))
def test_golden_row(row):
    kw, bars = ROWS[row]
    out = driver.run(verbose=False, device="cpu", **dict(dict(nsteps=12), **kw))
    assert 0 < out.l2_err <= bars["l2"], out.l2_err
    for k in ("cv", "cv_gll"):
        if k in bars:
            assert getattr(out, k) <= bars[k], (k, getattr(out, k))
    if "min" in bars:
        assert out.min_e >= bars["min"], out.min_e
    if "max" in bars:
        assert out.max_e <= bars["max"], out.max_e
    if bars.get("step"):
        assert out.max_step_mass_err < 1e-12
        assert out.max_step_bounds_err < 5e-13
