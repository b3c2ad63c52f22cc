"""The readers of the program's spans and counters, the reduction of a
profiler trace by program span, and benchmark.progtrace's run on the CPU:
the host-side metrics of a ne4 QLT run, and the comm.* spans' bytes
against the counting communicator on two gloo ranks."""

import time

import pytest

from benchmark import harness, progtrace, spec

EMPTY = dict(steps=0, span_s={}, syncs=None, chips=1, trace=None)


def _record():
    spans = {"isl.departure.trajectory": dict(count=4, s=0.2),
             "isl.departure.locate": dict(count=4, s=0.04),
             "cdr.qlt": dict(count=8, s=0.08),
             "cdr.mn2": dict(count=4, s=0.02)}
    reduced = {"spans": {"isl.departure.trajectory": dict(
        count=2, launches=1000, nccl_s=0.0),
        "comm.bfb": dict(count=6, launches=12, nccl_s=0.006),
        "comm.halo": dict(count=2, launches=4, nccl_s=0.001)},
        "idle": {}, "unlinked": 0, "ranges_on_device": 0}
    other = dict(reduced, spans=dict(reduced["spans"], **{
        "comm.bfb": dict(count=6, launches=12, nccl_s=0.002)}))
    return dict(EMPTY, steps=4, trace=dict(steps=2),
                program=dict(spans=spans,
                             counters={"qp.newton_iters": 120,
                                       "qp.calls": 4}),
                program_trace=[reduced, other])


@pytest.mark.parametrize("name,want", [
    ("trajectory_ms", 50.0), ("locate_ms", 10.0), ("qlt_ms", 20.0),
    ("mn2_ms", 5.0), ("qp_iters_per_step", 30.0),
    ("trajectory_launches_per_step", 500.0), ("bfb_ms", 2.0),
    ("halo_ms", 0.5), ("dss_exchange_ms", None)])
def test_readers(name, want):
    read = spec.metric_reader(name)
    got = read(_record())
    assert got == (pytest.approx(want) if want is not None else None)
    # Nothing to read: nothing returned, as the parent's runs have.
    assert read(EMPTY) is None
    assert read(dict(EMPTY, steps=4, trace=dict(steps=2), program=None,
                     program_trace=[None])) is None
    assert set(progtrace.READERS) >= {name}


def _ev(name, device, start, end, id=0, link=0, annotation=False):
    return dict(name=name, device=device, start=start, end=end, id=id,
                link=link, annotation=annotation)


def test_reduce_program():
    ev = [_ev("bench_window", "cpu", 0, 1000),
          _ev("isl.step", "cpu", 10, 700, id=1),
          _ev("isl.departure.trajectory", "cpu", 20, 200, id=2),
          _ev("comm.bfb", "cpu", 300, 400, id=3),
          # Two launches inside the trajectory, by the runtime call's
          # correlation id; one tied only through its CPU op.
          _ev("cudaLaunchKernel", "cpu", 30, 35, id=501, link=7),
          _ev("cudaLaunchKernel", "cpu", 40, 45, id=502, link=8),
          _ev("aten::add", "cpu", 150, 160, id=9),
          _ev("vectorized_elementwise_kernel", "cuda", 50, 60, id=501),
          _ev("vectorized_elementwise_kernel", "cuda", 70, 80, id=502),
          _ev("Memcpy DtoD", "cuda", 170, 175, id=777, link=9),
          # An NCCL kernel launched inside comm.bfb, running later.
          _ev("cudaLaunchKernelExC", "cpu", 310, 320, id=503),
          _ev("ncclDevKernel_AllGather_RING_LL", "cuda", 330, 480,
              id=503),
          # The program's ranges on the device's timeline: annotations.
          _ev("comm.bfb", "cuda", 330, 480, annotation=True),
          _ev("orphan_kernel", "cuda", 600, 610, id=999)]
    r = progtrace.reduce_program(ev)
    sp = r["spans"]
    assert sp["isl.departure.trajectory"] == dict(count=1, launches=3,
                                                  nccl_s=0.0)
    assert sp["comm.bfb"]["launches"] == 1
    assert sp["comm.bfb"]["nccl_s"] == pytest.approx(150e-6)
    assert sp["isl.step"]["launches"] == 4
    assert r["unlinked"] == 1 and r["ranges_on_device"] == 0
    # Idle gaps by the innermost program range: 0-50, 60-70 and 80-170
    # in the trajectory, 175-330 and 480-600 in the step, 610-1000 (its
    # midpoint past the step) outside.
    assert r["idle"]["isl.departure.trajectory"] == pytest.approx(150e-6)
    assert r["idle"]["isl.step"] == pytest.approx(275e-6)
    assert r["idle"]["no program span"] == pytest.approx(390e-6)
    assert progtrace.reduce_program(ev[1:]) is None


def _qlt_cell():
    cell = spec.Cell("isl_qlt.ne30.t40")
    over = {"config": {"ne": 4, "ntracer": 3},
            "traffic": {"sample_within": 3, "warmup_steps": 1}}
    return cell, over


def test_host_metrics_on_the_cpu():
    """A traced ne4 QLT run on the CPU with the program's tracer on fills
    the host-side metrics; the benchmark's own spans read as before."""
    cell, over = _qlt_cell()
    res, rec = progtrace.run(cell, 11, 0.2, time.time(), world=1,
                             backend="cpu", override=over)
    assert res["correct"]
    vals = {n: spec.metric_reader(n)(rec) for n in progtrace.READERS}
    for n in ("trajectory_ms", "locate_ms", "qlt_ms", "mn2_ms",
              "qp_iters_per_step"):
        assert vals[n] > 0, n
    # No profiler on the CPU: the device-side readers find nothing.
    for n in ("trajectory_launches_per_step", "bfb_ms", "halo_ms",
              "dss_exchange_ms"):
        assert vals[n] is None, n
    dep = spec.metric_reader("departure_ms")(rec)
    checks = progtrace.checks(rec, dict(vals, departure_ms=dep))
    assert 0.9 < checks["isl.departure_over_departure_ms"] <= 1.0
    assert 0.9 < checks["trajectory_plus_locate_over_departure_ms"] <= 1.0
    # The hooks are undone: a later run traces nothing of the program.
    from compose_tpu_torch import trace as ptrace
    assert not ptrace.active
    assert harness.hostdiag.summary.__module__ == "benchmark.hostdiag"


def test_comm_span_bytes_match_the_counting_communicator():
    """Two gloo ranks at ne4: the bytes of rank 0's comm.* spans over the
    window equal what CountingDistComm counted there."""
    cell = spec.Cell("isl_caas.ne30.t40.x4")
    over = {"config": {"ne": 4, "ntracer": 3},
            "traffic": {"sample_within": 3}}
    res, rec = progtrace.run(cell, 7, 0.3, time.time(), world=2,
                             backend="gloo", override=over)
    spans = rec["program"]["spans"]
    nbytes = sum(spans[n]["bytes"] for n in ("comm.halo", "comm.dss_slots",
                                             "comm.bfb"))
    r0 = res["per_rank"][0]
    assert nbytes == r0["comm_b"]
    assert spans["comm.halo"]["bytes"] + spans["comm.dss_slots"]["bytes"] \
        == r0["comm_p2p"]
    assert spans["isl.step"]["count"] == res["nsteps"]
    assert res["correct"]
