"""The program's spans and counters (compose_tpu_torch/trace.py) on the
CPU: nothing recorded and nothing allocated while off, bitwise equal steps
with tracing on and off, the span tree of a single-device and of a
two-shard LocalComm step, the Newton-iteration counter, the received
bytes against ShardedIsl.bytes_per_step, and the record_function ranges
under torch.profiler with the anchor that maps records onto them."""

import itertools
import tracemalloc

import pytest
import torch

from compose_tpu_torch import driver, trace
from compose_tpu_torch.mesh import cubed_sphere
from compose_tpu_torch.ops import local_qp
from compose_tpu_torch.parallel.sharded import ShardedIsl
from compose_tpu_torch.transport import gallery
from compose_tpu_torch.transport.isl import IslConfig, IslTransport

DT = 86400.0 * 12 / 120
ICS = ("gaussianhills", "slottedcylinders", "cosinebells")
STEP_SPANS = {"isl.step", "isl.departure", "isl.departure.trajectory",
              "isl.departure.locate", "isl.interp", "isl.rho_cdr",
              "isl.tracer_cdr", "isl.dss"}
PARENT = {"isl.departure": "isl.step", "isl.departure.trajectory":
          "isl.departure", "isl.departure.locate": "isl.departure",
          "isl.interp": "isl.step", "isl.rho_cdr": "isl.step",
          "isl.tracer_cdr": "isl.step", "isl.dss": "isl.step",
          "cdr.qlt": ("isl.rho_cdr", "isl.tracer_cdr"),
          "cdr.mn2": "isl.tracer_cdr"}


@pytest.fixture(autouse=True)
def tracer_off():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


def _model(ne, filt, lim):
    mesh = cubed_sphere.build(ne, 4, device="cpu")
    model = IslTransport(mesh, gallery.create_wind("divergent"),
                         IslConfig(ne=ne, nsub=2, filter=filt, limiter=lim))
    rho = torch.ones((mesh.ncell, 16), dtype=torch.float64)
    return model, rho, driver.init_tracers(mesh, ICS)


def test_off_records_nothing_allocates_nothing(monkeypatch):
    model, rho, q = _model(3, "caas", "caas")
    model.step(rho, q, 0.0, DT)
    assert trace.records() == []
    assert trace.summary() == {"spans": {}, "counters": {}}

    def no_torch(*a, **kw):
        raise AssertionError("a torch call while tracing is off")

    monkeypatch.setattr(torch.autograd, "_profiler_enabled", no_torch)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", no_torch)
    def peak(body):
        it = itertools.repeat(None, 5000)
        tracemalloc.start()
        try:
            base = tracemalloc.get_traced_memory()[0]
            tracemalloc.reset_peak()
            body(it)
            return tracemalloc.get_traced_memory()[1] - base
        finally:
            tracemalloc.stop()

    def bare(it):
        for _ in it:
            with trace.NOOP:
                pass

    def traced(it):
        for _ in it:
            with trace.span("comm.bfb") as sp:
                sp.add(8)
            trace.count("qp.newton_iters")

    # What a bare `with` costs the interpreter once, and nothing more.
    assert peak(traced) == peak(bare)
    assert trace.span("isl.step") is trace.NOOP


@pytest.mark.parametrize("filt,lim", [("caas", "caas"), ("qlt", "mn2")])
def test_on_and_off_bitwise_equal(filt, lim):
    model, rho, q = _model(4, filt, lim)
    off = model.step(*model.step(rho, q, 0.0, DT), DT, 2 * DT)
    trace.enable()
    on = model.step(*model.step(rho, q, 0.0, DT), DT, 2 * DT)
    trace.disable()
    assert torch.equal(off[0], on[0]) and torch.equal(off[1], on[1])
    names = {r["name"] for r in trace.records()}
    assert STEP_SPANS <= names
    if filt == "qlt":
        assert {"cdr.qlt", "cdr.mn2"} <= names
        assert trace.summary()["counters"]["qp.newton_iters"] > 0


def _check_tree(recs):
    """Every child inside its parent, with its parent's step; one step id
    per root; returns {step id: root record}."""
    roots = {}
    for r in recs:
        assert r["end_ns"] >= r["start_ns"]
        if r["parent"] < 0:
            assert r["name"] == "isl.step"
            assert r["step"] not in roots
            roots[r["step"]] = r
            continue
        p = recs[r["parent"]]
        assert p["step"] == r["step"]
        assert p["start_ns"] <= r["start_ns"] <= r["end_ns"] <= p["end_ns"]
    return roots


def test_span_tree_and_self_time():
    model, rho, q = _model(3, "qlt", "mn2")
    trace.enable()
    state = (rho, q)
    for k in range(3):
        state = model.step(*state, k * DT, (k + 1) * DT)
    trace.disable()
    recs = trace.records()
    roots = _check_tree(recs)
    assert len(roots) == 3
    for r in recs:
        want = PARENT.get(r["name"])
        if want is not None:
            got = recs[r["parent"]]["name"]
            assert got in (want if isinstance(want, tuple) else (want,))
    spans = trace.summary()["spans"]
    assert spans["isl.step"]["count"] == 3
    assert spans["cdr.qlt"]["count"] == 6
    for name, d in spans.items():
        assert d["self_s"] >= 0.0 and d["self_s"] <= d["s"], name
    step = spans["isl.step"]
    kids = sum(spans[n]["s"] for n in ("isl.departure", "isl.interp",
                                       "isl.rho_cdr", "isl.tracer_cdr",
                                       "isl.dss"))
    assert step["self_s"] == pytest.approx(step["s"] - kids, abs=1e-6)
    lines = trace.step_table()
    assert lines[-1].startswith("full step")
    assert any(s.startswith("qp.newton_iters") for s in lines)


def test_newton_iterations_counted():
    a = torch.ones(1, 4, dtype=torch.float64)
    lo, hi = torch.zeros_like(a), torch.full_like(a, 10.0)
    trace.enable()
    # Inside the bounds with the right sum: solved before the loop.
    y = torch.tensor([[1.0, 2.0, 3.0, 4.0]], dtype=torch.float64)
    x, info = local_qp.solve_1eq_bc_qp(a, a, y.sum(-1), lo, hi, y)
    assert int(info[0]) == 0
    assert trace.summary()["counters"] == {"qp.calls": 1}
    # Wide bounds, unit weights: the first body takes the Newton step
    # lambda = -r / n from lambda 0, the second finds it converged.
    trace.reset()
    x, info = local_qp.solve_1eq_bc_qp(a, a, y.sum(-1) + 2.0, lo, hi, y)
    assert int(info[0]) == 1
    torch.testing.assert_close(x, y + 0.5, rtol=0, atol=1e-14)
    assert trace.summary()["counters"] == {"qp.calls": 1,
                                           "qp.newton_iters": 2}
    trace.disable()
    local_qp.solve_1eq_bc_qp(a, a, y.sum(-1) + 2.0, lo, hi, y)
    assert trace.summary()["counters"]["qp.newton_iters"] == 2


def test_two_shards_parented_per_thread_and_bytes():
    model, rho, q = _model(4, "caas", "caas")
    sh = ShardedIsl(model, 2)
    ref = model.step(rho, q, 0.0, DT)
    # The first step checks the halo's coverage with a departure
    # computation of its own, outside any step.
    sh.step(rho, q, 0.0, DT)
    trace.enable()
    got = sh.step(rho, q, 0.0, DT)
    trace.disable()
    assert torch.equal(ref[0], got[0]) and torch.equal(ref[1], got[1])
    recs = trace.records()
    roots = _check_tree(recs)
    assert len(roots) == 2
    for sid in roots:
        mine = [r for r in recs if r["step"] == sid]
        names = [r["name"] for r in mine]
        assert names.count("comm.halo") == 1
        assert names.count("comm.dss_slots") == 2
        assert "comm.bfb" in names and STEP_SPANS <= set(names)
        p2p = sum(r["nbytes"] for r in mine
                  if r["name"] in ("comm.halo", "comm.dss_slots"))
        assert p2p == sh.bytes_per_step(q.shape[0])
        # The halo exchange sits in the interpolation, before departure.
        halo = mine[names.index("comm.halo")]
        assert recs[halo["parent"]]["name"] == "isl.interp"


def _profiled_misses(model, rho, q):
    """Two steps under a CPU torch.profiler with tracing on: the records
    that the anchor does not map onto a range of their name to within 1
    ms, at each end; and the profiler's event names."""
    from torch.profiler import ProfilerActivity, profile

    trace.reset()
    trace.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model.step(rho, q, 0.0, DT)
        model.step(rho, q, DT, 2 * DT)
    trace.disable()
    events = list(prof.events())
    off = trace.profiler_offset_us(events)
    assert off is not None
    misses = []
    for r in trace.records():
        s = r["start_ns"] / 1e3 + off
        e = r["end_ns"] / 1e3 + off
        near = [ev for ev in events if ev.name == r["name"]
                and abs(ev.time_range.start - s) < 1e3
                and abs(ev.time_range.end - e) < 1e3]
        if len(near) != 1:
            misses.append(r["name"])
    return misses, [ev.name for ev in events]


def test_profiler_ranges_and_anchor():
    model, rho, q = _model(3, "caas", "caas")
    # A host clock read can be preempted on a loaded machine (the mapping
    # is good to ~50 us here): one of three profiled runs must map all.
    for _ in range(3):
        misses, names = _profiled_misses(model, rho, q)
        for name in STEP_SPANS:
            assert names.count(name) == 2, name
        if not misses:
            break
    assert misses == []
