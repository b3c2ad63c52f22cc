"""The harness on the CPU: every file found by name, BENCHMARK.json's
form, the metric arithmetic on synthetic records, the communicator's byte
count, the run failing without a card, and the import rules."""

import ast
import json
import math
import pathlib
import re
import shutil
import subprocess
import sys
import time

import pytest

from benchmark import harness, spec, trace

ROOT = spec.ROOT
BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(name):
    cell = spec.Cell(name)
    assert cell.config["name"] == cell.entry["config"]
    assert cell.traffic["name"] == cell.entry["traffic"]
    assert set(cell.limits) <= {"state_gap", "step_mass", "window_mass",
                                "bounds", "global_bounds", "nonfinite"}
    assert cell.limits
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    # The rate is reported in every cell: end to end, or per layer where
    # the host swings it beyond an end-to-end bound.
    layers = {m["name"] for m in cell.per_layer}
    assert "tracer_dof_per_s" in names or "step_dof_per_s" in layers
    # Every per-layer metric moves an end-to-end metric the cell reports.
    assert cell.per_layer
    assert all(m["moves"] in names for m in cell.per_layer)


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_reader_found_by_name(m):
    read = spec.metric_reader(m["name"])
    # A reader with nothing to read returns nothing.
    empty = dict(steps=0, span_s={}, syncs=None, chips=1, trace=None)
    assert read(empty) is None


def test_benchmark_json_form():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert [m["name"] for m in BENCH["end_to_end"]] == [
        "tracer_dof_per_s", "step_ms_p95", "peak_mem_gib", "setup_s"]
    for c in BENCH["configs"]:
        assert NAME.match(c["name"])
        f = ROOT / c["file"]
        assert f.is_file() and f.parts[len(ROOT.parts)] == "benchmark"
        assert json.loads(f.read_text())["name"] == c["name"]
    for group in ("workloads", "end_to_end", "per_layer"):
        for m in BENCH[group]:
            assert NAME.match(m["name"])
            if "unit" in m:
                assert UNIT.match(m["unit"])
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_union_counts_overlap_once():
    # Two streams overlapping for 2 us: 10 + 10 - 2 busy, not 20.
    assert trace.union_seconds([(0, 10), (8, 18), (30, 31)]) == 19
    assert trace.gaps([(0, 10), (8, 18), (30, 31)], 0, 40) == [(18, 30),
                                                               (31, 40)]


def test_reduce_events():
    ev = [dict(name="bench_window", device="cpu", start=100, end=200),
          dict(name="tracer_cdr", device="cpu", start=100, end=160),
          dict(name="void dss_q_kernel<double>(double const*)",
               device="cuda", start=110, end=130),
          dict(name="void dss_q_kernel<double>(double const*)",
               device="cuda", start=120, end=140),
          dict(name="Memcpy DtoH", device="cuda", start=170, end=180),
          dict(name="ncclDevKernel_SendRecv(ncclDevKernelArgsStorage)",
               device="cuda", start=182, end=186),
          dict(name="ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgs)",
               device="cuda", start=184, end=190),
          dict(name="outside", device="cuda", start=10, end=20)]
    r = trace.reduce_events(ev)
    assert r["window_s"] == pytest.approx(100e-6)
    assert r["busy_s"] == pytest.approx(48e-6)
    # The NCCL kernels' union: 182-190, overlap counted once.
    assert r["nccl_s"] == pytest.approx(8e-6)
    assert r["launches"] == 5
    assert r["breakdown"]["device_ops"][0] == ["dss_q_kernel<double>",
                                               pytest.approx(40e-6)]
    gaps = dict(r["breakdown"]["idle_gaps"])
    assert gaps["host in tracer_cdr"] == pytest.approx(40e-6)
    assert gaps["host in between layers"] == pytest.approx(12e-6)
    rec = dict(steps=2, trace=dict(r, steps=2,
                                   launch_args={"dss_q_f64": [(1, 2, 3, 4),
                                                              (1, 2, 3, 4)]}),
               busy_s=r["busy_s"], window_s=r["window_s"],
               nccl_s=r["nccl_s"])
    assert spec.metric_reader("idle_share")(rec) == pytest.approx(52.0)
    assert spec.metric_reader("launches_per_step")(rec) == 2.5
    assert spec.metric_reader("comm_ms")(rec) == pytest.approx(4e-3)
    assert spec.metric_reader("comm_ms")(dict(rec, nccl_s=0.0)) is None
    roof = spec.metric_reader("dss_q_roofline")(rec)
    nbytes = 2 * (8 * (2 * 3 + 2 * 3 + 2 * 4) + 16 * 4)
    assert roof == pytest.approx(100 * nbytes / 3.35e12 / 40e-6)


def test_p95_over_tiled_steps():
    # Events between consecutive steps tile the window: 100 steps of 1 ms
    # and 10 of 5 ms; the nearest-rank 95th percentile is 5 ms.
    marks = [0.0]
    for ms in [1.0] * 100 + [5.0] * 10:
        marks.append(marks[-1] + ms / 1e3)
    step_ms = [harness._elapsed_ms(a, b) for a, b in zip(marks[:-1],
                                                         marks[1:])]
    assert sum(step_ms) == pytest.approx(marks[-1] * 1e3)
    assert harness.p95(step_ms) == pytest.approx(5.0)
    assert harness.p95(list(range(1, 101))) == 95


def test_rate_counts_the_whole_globe():
    cell = spec.Cell("isl_caas.ne30.t40.x4")
    rank = dict(peak=2 ** 30, comm_b=10, comm_p2p=8, traced=None,
                span_s=None, syncs=None)
    res = dict(nsteps=100, window_s=10.0, step_ms=[100.0] * 100,
               setup_s=40.0, per_rank=[rank] * 4, correct=True, failed=0,
               table={}, dof=6 * 30 ** 2 * 16 * 40)
    import torch
    out = harness.result_line(cell, res, False, torch.device("cpu"), 4)
    # ne30 counted once, not once per rank: 3,456,000 DOF per step.
    assert out["metrics"]["tracer_dof_per_s"]["value"] == 3456000 * 10
    assert out["device"]["count"] == 4
    assert list(out)[-1] == "limits"


def _fake_run(tracing):
    """A result as harness.run_cell returns it, on the CPU."""
    import torch

    rank = dict(peak=2 ** 30, comm_b=None, comm_p2p=None, traced=None,
                span_s={"departure": 1.0}, syncs=9, setup_parts={},
                sync_sites=[])
    return dict(nsteps=10, window_s=1.0, step_ms=[100.0] * 10, setup_s=9.0,
                per_rank=[rank], nums={}, correct=True, failed=0, table={},
                check_s=0.1, samples=[0], device=torch.device("cpu"),
                dof=6 * 30 ** 2 * 16 * 40)


@pytest.mark.parametrize("plant", [False, True])
def test_jax_loaded_late_fails_the_run(monkeypatch, capsys, plant):
    """The look for JAX comes after everything the printing process runs:
    a module named jax that a per-layer reader loads fails the run, with no
    result line; without it the same run prints its line."""
    import types

    from benchmark import run

    monkeypatch.setattr(harness, "run_cell",
                        lambda cell, seed, s, tracing, *a, **kw:
                        _fake_run(tracing))
    reader = spec.metric_reader

    def planting(name):
        read = reader(name)

        def read_and_plant(rec):
            if plant:
                monkeypatch.setitem(sys.modules, "jax",
                                    types.ModuleType("jax"))
            return read(rec)

        return read_and_plant

    monkeypatch.setattr(spec, "metric_reader", planting)
    for var in ("TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR", "USE_FLAX"):
        monkeypatch.setenv(var, "")  # restored after the test
    rc = run.main(["--workload", "isl_caas.ne30.t40", "--seed",
                   str(2 ** 33 + 5), "--seconds", "1", "--trace", "1",
                   "--smi-dir", ""])
    out, err = capsys.readouterr()
    if plant:
        assert rc != 0 and out.strip() == ""
        assert "jax" in err
    else:
        assert rc == 0
        line = json.loads(out.strip().splitlines()[-1])
        assert line["metrics"]["departure_ms"]["value"] == 100.0
        # The CAAS cell's rate, read per layer: the whole globe's DOF
        # times 10 steps over the 1 s window.
        assert line["metrics"]["step_dof_per_s"]["value"] == \
            6 * 30 ** 2 * 16 * 40 * 10


def test_comm_bytes_match_the_model():
    """Two gloo ranks at ne4: the point-to-point bytes the counting
    communicator sees per step equal ShardedIsl.bytes_per_step."""
    import torch
    from compose_tpu_torch.parallel.sharded import ShardedIsl

    cell = spec.Cell("isl_caas.ne30.t40.x4")
    over = {"config": {"ne": 4, "ntracer": 3},
            "traffic": {"sample_within": 4}}
    args = dict(workload=cell.name, seed=7, seconds=0.5, trace=False,
                t_start=time.time(), variant="program", smi_dir=None,
                backend="gloo", override=over)
    res = harness.run_ranks(2, args)
    rec = harness.layer_record(res, 2)
    cell.config = dict(cell.config, ne=4, ntracer=3)
    model = harness.build_model(cell.config, torch.device("cpu"), True)
    sh = ShardedIsl(model, 2, depth=cell.traffic["halo_depth"])
    assert rec["comm_p2p_bytes"] == res["nsteps"] * sh.bytes_per_step(3)
    assert rec["comm_bytes"] > rec["comm_p2p_bytes"]
    assert spec.metric_reader("comm_bytes_per_step")(rec) == \
        rec["comm_bytes"] / res["nsteps"]
    assert res["correct"]


def test_run_fails_without_a_card(tmp_path):
    """No card: a non-zero exit and no result line. In a directory with
    only BENCHMARK.json and the benchmark's files, the same."""
    cmd = [sys.executable, "-m", "benchmark.run", "--workload",
           "isl_caas.ne30.t40", "--seed", str(2 ** 33 + 1), "--seconds", "1",
           "--trace", "0", "--smi-dir", str(tmp_path / "smi")]
    p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""
    alone = tmp_path / "alone"
    shutil.copytree(ROOT / "benchmark", alone / "benchmark")
    shutil.copy(ROOT / "BENCHMARK.json", alone)
    p = subprocess.run(cmd, cwd=alone, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


def _imports(path):
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_imports():
    """No file of the benchmark imports jax, jaxlib, flax or the JAX
    package (top-level names compared whole); the reference and the
    comparison import nothing of the port either."""
    files = sorted((ROOT / "benchmark").rglob("*.py"))
    assert files
    for f in files:
        assert not _imports(f) & {"jax", "jaxlib", "flax", "compose_tpu"}, f
    for name in ("reference.py", "check.py"):
        tops = _imports(ROOT / "benchmark" / name)
        assert "compose_tpu_torch" not in tops
    # What a run loads, the port included, holds none of them.
    code = ("import torch; from benchmark import run, harness, spec; "
            "c = spec.Cell('isl_qlt.ne30.t40'); "
            "harness.build_model(dict(c.config, ne=2), torch.device('cpu'), "
            "True); print(harness.forbidden_modules())")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"
