"""A cell's --trace 1 run with the program's own tracer on
(compose_tpu_torch/trace.py), and the per-layer metrics that read its
spans and counters.

    python3 -m benchmark.progtrace --workload <name> --seed <n> \
        --seconds <s> [--smi-dir DIR]

The run is `benchmark.run --trace 1`'s, through the same harness, with
three additions made in this process and in each rank's: the tracer is
turned on and reset where the harness wraps its spans just before the
window (Program.wrap); at the window's end (hostdiag.summary) its
summary is kept and it is reset again; the profiled steps after the
window then carry the program's record_function ranges, and their
events, with the profiler's correlation ids, are reduced by
`reduce_program` (in trace.profiler_events). `harness.py` calls none of
this yet: this module stands in for the lines it would need (PERF.md §7).

The last line of standard output is the harness's result line with the
per-layer metrics of `READERS` added to "metrics" (each read from
`harness.layer_record` plus "program", rank 0's window summary, and
"program_trace", every rank's reduction), and "program_checks": the
consistency of the program's spans with the benchmark's. Standard error
gets the idle time by the innermost program span, rank 0's summary per
step and the device operations named like a program span.
"""

import bisect
import json
import os
import pathlib
import re
import sys
import tempfile
import time

T_START = time.time()

import torch  # noqa: E402

from . import harness, hostdiag, spec, trace  # noqa: E402

PREFIXES = ("isl.", "cdr.", "comm.")
# The per-layer metrics that read the program's spans, with their units.
READERS = {"trajectory_ms": "ms", "locate_ms": "ms",
           "trajectory_launches_per_step": "1/step", "qlt_ms": "ms",
           "mn2_ms": "ms", "qp_iters_per_step": "1/step", "bfb_ms": "ms",
           "halo_ms": "ms", "dss_exchange_ms": "ms"}
# The CUDA runtime and driver calls that launch a device operation.
_RUNTIME = re.compile(r"^cu(da)?[A-Z]")
_DIR_VAR = "BENCH_PROGTRACE_DIR"


def is_program_span(name):
    return name.startswith(PREFIXES)


def program_events(prof):
    """The profiler's events as plain dicts (name, device, start, end in
    microseconds, the correlation id `id`, the linked id `link`, and
    whether a device event is a user annotation)."""
    out = []
    for e in prof.events():
        dev = "cuda" if e.device_type == torch.autograd.DeviceType.CUDA \
            else "cpu"
        out.append(dict(
            name=e.name, device=dev, start=e.time_range.start,
            end=e.time_range.end, id=e.id,
            link=getattr(e, "linked_correlation_id", 0) or 0,
            annotation=bool(getattr(e, "is_user_annotation", False))))
    return out


def reduce_program(events, window_label="bench_window"):
    """Per program span name, over the traced window: "count" (ranges),
    "launches" (device operations launched while the host was inside a
    range of that name, nested ranges included) and "nccl_s" (device
    seconds of the NCCL kernels among them). A device operation's launch
    is the CUDA runtime call with its correlation id, or else the CPU op
    it is linked to. Also "idle" (idle device seconds by the innermost
    program range holding the gap's midpoint), "unlinked" (device
    operations with no launch found) and "ranges_on_device" (device
    events named like a program span that are not annotations). None
    without the window."""
    win = [e for e in events if e["device"] == "cpu"
           and e["name"] == window_label]
    if not win:
        return None
    lo, hi = win[0]["start"], win[0]["end"]
    named = set(trace.SPANS) | {window_label}
    dev, on_dev = [], 0
    for e in events:
        if e["device"] != "cuda" or e["end"] <= lo or e["start"] >= hi:
            continue
        if e["annotation"] or e["name"] in named:
            continue
        if is_program_span(e["name"]) or e["name"] == "trace.anchor":
            on_dev += 1
            continue
        dev.append(e)
    runtime, ops = {}, {}
    for e in events:
        if e["device"] == "cpu":
            if _RUNTIME.match(e["name"]):
                runtime[e["id"]] = e["start"]
            else:
                ops.setdefault(e["id"], e["start"])
    launches, unlinked = [], 0
    for e in dev:
        t = runtime.get(e["id"])
        if t is None:
            t = ops.get(e["link"]) if e["link"] else None
        if t is None:
            unlinked += 1
            continue
        nccl = (e["end"] - e["start"]) * 1e-6 \
            if "nccl" in e["name"].lower() else 0.0
        launches.append((t, nccl))
    launches.sort()
    ranges = sorted((e["start"], e["end"], e["name"]) for e in events
                    if e["device"] == "cpu" and is_program_span(e["name"])
                    and e["end"] > lo and e["start"] < hi)
    times = [t for t, _ in launches]
    out = {}
    for s, e, name in ranges:
        d = out.setdefault(name, {"count": 0, "launches": 0, "nccl_s": 0.0})
        d["count"] += 1
        for t, nccl in launches[bisect.bisect_left(times, s):
                                bisect.bisect_right(times, e)]:
            d["launches"] += 1
            d["nccl_s"] += nccl
    ivals = [(e["start"], e["end"]) for e in dev if e["end"] > e["start"]]
    idle = {}
    for s, e in trace.gaps(ivals, lo, hi):
        mid = 0.5 * (s + e)
        inner = [r for r in ranges if r[0] <= mid <= r[1]]
        where = max(inner)[2] if inner else "no program span"
        idle[where] = idle.get(where, 0.0) + (e - s) * 1e-6
    return dict(spans=out, idle=idle, unlinked=unlinked,
                ranges_on_device=on_dev)


# ---------------------------------------------------------------------------
# The hooks, in the process of each rank

class _State:
    window = None       # the tracer's summary over the window
    reduced = None      # reduce_program over the profiled steps
    patched = []        # (module, name, original) of the hooks' patches


def _patch(mod, name, fn):
    _State.patched.append((mod, name, getattr(mod, name)))
    setattr(mod, name, fn)


def _unhook():
    """Undo the hooks' patches of the harness's modules, and turn the
    program's tracer off."""
    from compose_tpu_torch import trace as ptrace

    while _State.patched:
        mod, name, fn = _State.patched.pop()
        setattr(mod, name, fn)
    ptrace.disable()


def hook(prog):
    """harness.rank_run's `hooks`: turns the program's tracer on just
    before the window, keeps its summary at the window's end, and reduces
    the profiled steps' events."""
    from compose_tpu_torch import trace as ptrace

    wrap = prog.wrap

    def wrap_and_trace(spans):
        wrap(spans)
        ptrace.enable()
        ptrace.reset()

    prog.wrap = wrap_and_trace
    _State.window = _State.reduced = None
    summary = hostdiag.summary

    def window_end(*a, **kw):
        _State.window = ptrace.summary()
        ptrace.reset()
        _dump()
        return summary(*a, **kw)

    _patch(hostdiag, "summary", window_end)
    events = trace.profiler_events

    def traced(prof):
        _State.reduced = reduce_program(program_events(prof))
        ptrace.disable()
        _dump()
        return events(prof)

    _patch(trace, "profiler_events", traced)


def _dump():
    """Each rank's state to a file, where the tool that spawned it said."""
    where = os.environ.get(_DIR_VAR)
    if not where:
        return
    import torch.distributed as dist
    rank = dist.get_rank() if dist.is_initialized() else 0
    with open(os.path.join(where, f"rank{rank}.json"), "w") as f:
        json.dump(dict(window=_State.window, reduced=_State.reduced), f)


# ---------------------------------------------------------------------------
# The run

def run(cell, seed, seconds, t_start, smi_dir=None, world=None,
        backend="nccl", override=None):
    """One traced run with the program's tracer on; returns (res, rec):
    rank 0's result and its layer record with "program" and
    "program_trace". `world`, `backend` and `override` (the CPU tests):
    ranks on gloo, and the cell's fields replaced."""
    world = cell.chips if world is None else world
    if world == 1:
        if backend == "nccl":
            harness.require_cards(1)
            device = torch.device("cuda", 0)
            torch.cuda.set_device(device)
        else:
            device = torch.device("cpu")
        for k, v in (override or {}).items():
            setattr(cell, k, dict(getattr(cell, k), **v))
        smi = (os.path.join(smi_dir, f"smi-{cell.name}-{seed}-prog.csv")
               if smi_dir else None)
        try:
            res = harness.rank_run(
                cell, seed, seconds, True, device, t_start,
                smi_path=pathlib.Path(smi) if smi else None, hooks=hook)
        finally:
            _unhook()
        ranks = [dict(window=_State.window, reduced=_State.reduced)]
    else:
        with tempfile.TemporaryDirectory(prefix="bench-prog-") as d:
            os.environ[_DIR_VAR] = d
            try:
                args = dict(workload=cell.name, seed=seed, seconds=seconds,
                            trace=True, t_start=t_start, variant="program",
                            smi_dir=smi_dir, backend=backend,
                            hook="benchmark.progtrace:hook",
                            override=override or {})
                res = harness.run_ranks(world, args)
            finally:
                del os.environ[_DIR_VAR]
            ranks = []
            for r in range(world):
                with open(os.path.join(d, f"rank{r}.json")) as f:
                    ranks.append(json.load(f))
    rec = harness.layer_record(res, world)
    rec["program"] = ranks[0]["window"]
    rec["program_trace"] = [r["reduced"] for r in ranks]
    return res, rec


def checks(rec, metrics):
    """The program's spans beside the benchmark's: ratios that the two
    should bring near 1 (departure), sums against wholes."""
    out = {}
    steps = rec["steps"]
    spans = (rec.get("program") or {}).get("spans", {})

    def ms(name):
        d = spans.get(name)
        return 1e3 * d["s"] / steps if d and steps else None

    dep = metrics.get("departure_ms")
    if dep and ms("isl.departure"):
        out["isl.departure_over_departure_ms"] = ms("isl.departure") / dep
    if dep and "trajectory_ms" in metrics and "locate_ms" in metrics:
        out["trajectory_plus_locate_over_departure_ms"] = (
            metrics["trajectory_ms"] + metrics["locate_ms"]) / dep
    comm = metrics.get("comm_ms")
    parts = [metrics.get(k) for k in ("bfb_ms", "halo_ms",
                                      "dss_exchange_ms")]
    if comm and all(p is not None for p in parts):
        out["comm_parts_over_comm_ms"] = sum(parts) / comm
    cdr = [metrics.get(k) for k in ("rho_cdr_ms", "tracer_cdr_ms")]
    if all(c is not None for c in cdr) and "qlt_ms" in metrics:
        out["qlt_plus_mn2_over_cdr_ms"] = (
            metrics["qlt_ms"] + metrics.get("mn2_ms", 0.0)) / sum(cdr)
    ctr = (rec.get("program") or {}).get("counters", {})
    if steps and ctr:
        out["qp_calls_per_step"] = ctr.get("qp.calls", 0) / steps
    return out


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--smi-dir", default=str(spec.ROOT / "build" / "bench"))
    a = ap.parse_args(argv)
    os.environ["TRITON_CACHE_DIR"] = str(spec.ROOT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(spec.ROOT / "build"
                                             / "torch_extensions")
    cell = spec.Cell(a.workload)
    try:
        res, rec = run(cell, a.seed, a.seconds, T_START, a.smi_dir)
    except harness.NoDevice as e:
        sys.stderr.write(f"benchmark: {e}\n")
        return 2
    out = harness.result_line(cell, res, True, res["device"], cell.chips)
    vals = {k: v["value"] for k, v in out["metrics"].items()}
    for name, unit in READERS.items():
        v = spec.metric_reader(name)(rec)
        if v is not None:
            out["metrics"][name] = {"value": v, "unit": unit}
            vals[name] = v
    out["program_checks"] = checks(rec, vals)
    pr = res["per_rank"][0]
    ms = sorted(res["step_ms"])
    sys.stderr.write(
        f"benchmark: step ms median {ms[len(ms) // 2]:.3f} p95 "
        f"{harness.p95(ms):.3f}; "
        f"{res['dof'] * res['nsteps'] / res['window_s']:.6e} DOF/s\n")
    sys.stderr.write(
        f"benchmark: {cell.name} seed {a.seed}: {res['nsteps']} steps, "
        f"card {harness.power_limit(0)}; host syncs by site (rank 0): "
        f"{pr['sync_sites']}\n")
    for r, red in enumerate(rec["program_trace"]):
        if red:
            idle = sorted(red["idle"].items(), key=lambda kv: -kv[1])
            sys.stderr.write(
                f"benchmark: rank {r} idle s by innermost program span: "
                f"{[[k, round(v, 6)] for k, v in idle]}; unlinked device "
                f"ops {red['unlinked']}, program ranges counted on the "
                f"device {red['ranges_on_device']}\n")
    if rec.get("program"):
        from compose_tpu_torch import trace as ptrace
        for line in ptrace.step_table(rec["program"]):
            sys.stderr.write(f"benchmark: rank 0 {line}\n")
    bad = sorted(set(res.get("forbidden", []))
                 | set(harness.forbidden_modules()))
    if bad:
        sys.stderr.write(f"benchmark: modules of JAX are loaded: {bad}\n")
        return 3
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
