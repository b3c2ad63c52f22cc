"""The port's entry points outside the step, on the CPU at small sizes:
the bench (compose_tpu_torch.bench, bench.py's JSON line), the regression
battery (compose_tpu_torch.battery: the JAX battery's rows and check) and
its runner, the QLT perf test (sharded bitwise equal to single) and the
step profiler."""

import importlib.util
import json
import math
import pathlib
import types

from compose_tpu_torch import battery, bench
from compose_tpu_torch.tools import profile_step, qlt_perftest, run_battery

from test_regression_battery import ROWS as JAX_ROWS

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_bench_json_line():
    out = bench.run_bench(device="cpu", ne=3, nt=4, nsteps_timed=2)
    json.dumps(out)
    assert set(out) == {"metric", "value", "unit", "detail"}
    assert "vs_baseline" not in out and out["unit"] == "DOF/s"
    d = out["detail"]
    assert {"platform", "x64", "sec_per_step", "ncell", "np2",
            "ntracer"} <= set(d)
    assert (d["platform"], d["device"], d["x64"]) == ("cpu", "cpu", True)
    assert (d["ncell"], d["np2"], d["ntracer"]) == (54, 16, 4)
    assert len(d["step_ms"]) == 2 and d["step_ms_median"] > 0
    assert math.isclose(out["value"], 54 * 16 * 4 / d["sec_per_step"])
    assert d["finite"] and d["mass_rel_err"] < 1e-12
    assert d["bounds_violation"] < 5e-13
    assert bench.failures(out) == []


def test_bench_exits_nonzero_on_a_failed_invariant(monkeypatch, capsys):
    good = {"metric": "m", "value": 1.0, "unit": "DOF/s", "detail": {
        "finite": True, "mass_rel_err": 1e-16, "bounds_violation": 0.0}}
    monkeypatch.setattr(bench, "run_bench", lambda device: good)
    assert bench.main(["--device", "cpu"]) == 0
    for bad in ({"finite": False}, {"mass_rel_err": 2e-12},
                {"bounds_violation": 6e-13},
                {"mass_rel_err": float("nan")}):
        out = dict(good, detail=dict(good["detail"], **bad))
        monkeypatch.setattr(bench, "run_bench", lambda device, o=out: o)
        assert bench.main(["--device", "cpu"]) == 1
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 5 and all(json.loads(x) for x in lines)


def test_battery_rows_equal_the_jax_battery():
    assert len(battery.ROWS) == 53
    assert [r[0] for r in battery.ROWS] == [r[0] for r in JAX_ROWS]
    for mine, jax_row in zip(battery.ROWS, JAX_ROWS):
        assert mine == jax_row, mine[0]
    assert battery.BOUNDS_SLACK == 5e-13


def _jax_runner():
    spec = importlib.util.spec_from_file_location(
        "jax_run_battery", ROOT / "tools" / "run_battery.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_battery_check_agrees_with_the_jax_runner():
    jax_check = _jax_runner().check
    for _, _, _, asserts in battery.ROWS:
        for scale in (0.5, 1.0, 1.0 + 1e-9, 2.0):
            for slack in (0.0, 4e-13, 6e-13):
                out = types.SimpleNamespace(
                    l2_err=asserts.get("l2", 1.0) * scale,
                    cv=asserts.get("cv", 1.0) * scale,
                    cv_gll=asserts.get("cv_gll", 1.0) * scale,
                    min_e=asserts.get("min", 0.0) - slack * scale,
                    max_e=asserts.get("max", 1.0) + slack * scale)
                assert battery.check(out, asserts) == jax_check(out, asserts)


def test_battery_runner_resumes_and_fails(tmp_path, monkeypatch):
    out = tmp_path / "battery.json"
    argv = [str(out), "pref5_none", "--device", "cpu"]
    assert run_battery.main(argv) == 0
    doc = json.loads(out.read_text())
    assert (doc["n_rows"], doc["n_run"], doc["n_pass"]) == (53, 1, 1)
    rec = doc["rows"]["pref5_none"]
    assert rec["pass"] and rec["checks"]["l2"]["golden"] == 4.2e-3
    assert set(rec["measured"]) == {"l2", "cv", "cv_gll", "min", "max"}

    # Resumed: the done row is not run again.
    def no_run(row_id, device):
        raise AssertionError(f"{row_id} ran again")
    with monkeypatch.context() as m:
        m.setattr(battery, "run_row", no_run)
        assert run_battery.main(argv) == 0
    assert json.loads(out.read_text()) == doc

    # A row over its bar and a row that raises: both recorded, exit 1.
    _, ref, kwargs, _ = battery.row("pref5_none")
    rows = battery.ROWS + [("tight", ref, kwargs, dict(l2=1e-9)),
                           ("bogus", ref, dict(kwargs, method="bogus"), {})]
    monkeypatch.setattr(battery, "ROWS", rows)
    assert run_battery.main([str(out), "tight", "bogus", "--device",
                             "cpu"]) == 1
    doc = json.loads(out.read_text())
    assert doc["n_run"] == 3 and doc["n_pass"] == 1
    assert not doc["rows"]["tight"]["pass"]
    assert not doc["rows"]["tight"]["checks"]["l2"]["pass"]
    assert "error" in doc["rows"]["bogus"] and not doc["rows"]["bogus"][
        "pass"]
    # The whole manifest is judged when no row is named.
    assert run_battery.main([str(out), "pref5_none", "--device",
                             "cpu"]) == 0


def test_qlt_perftest_sharded_bitwise(capsys):
    assert qlt_perftest.main(["-nc", "96", "-nt", "4", "-nr", "2", "-ndev",
                              "4", "--device", "cpu"]) == 0
    res = qlt_perftest.run(96, 4, 2, 4, "cpu")
    assert res["bitwise"] and res["kernel_bitwise"] and res["frontier"] > 0
    for k in ("tree", "analyze", "qltrun", "qltrun_plain", "l2r",
              "sharded_analyze", "sharded_qltrun"):
        assert res[k] > 0, k
    out = capsys.readouterr().out
    assert "sharded == single: bitwise" in out
    assert "(the eager loop)" in out and "run == eager: bitwise" in out


def test_profile_step_table(capsys):
    res = profile_step.profile(ne=3, nt=4, device="cpu", fine=True)
    for k in ("trajectories (nsub=8)", "locate", "sphere_to_ref",
              "departure_data (all)", "interp 4 tracers",
              "jacobian_departure", "FULL STEP", "step w/o CDR",
              "step nt=1", "records", "limit_tracer (caas)", "dss_q",
              "span isl.step", "span isl.departure.trajectory"):
        assert res[k] > 0, k
    assert "FULL STEP" in capsys.readouterr().out
