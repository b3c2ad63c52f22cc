"""One run of one cell: set-up, the measured window, the traced window,
and the comparison that decides `correct`.

A cell on one chip steps `IslTransport.step`. A cell on four chips runs
one process per card (spawned by `run_cell`), each stepping its own block
through `ShardedIsl.step_blocks` over a DistComm on NCCL; rank 0 reports.
The program (compose_tpu_torch) is imported only inside the functions
that build and step it.
"""

import gc
import math
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

from . import check, hostdiag, reference, spec, trace

FORBIDDEN = ("jax", "jaxlib", "flax", "compose_tpu")


class NoDevice(RuntimeError):
    """The cards the cell asks for are not there."""


def forbidden_modules():
    """Loaded modules whose top-level name is jax, jaxlib, flax or the JAX
    package, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def require_cards(n):
    if not torch.cuda.is_available():
        raise NoDevice("no CUDA device: the benchmark runs only on the card")
    if torch.cuda.device_count() < n:
        raise NoDevice(f"the cell needs {n} CUDA devices, "
                       f"{torch.cuda.device_count()} found")


def p95(values):
    """Nearest-rank 95th percentile."""
    v = sorted(values)
    return v[max(0, math.ceil(0.95 * len(v)) - 1)]


def step_times(k, cfg):
    """The window's step k: (ts, tf) in seconds, k taken modulo the wind's
    period so that every window repeats the same step times."""
    dt = cfg["dt_s"]
    ts = (k % cfg["period_steps"]) * dt
    return ts, ts + dt


def sample_indices(seed, traffic):
    """The window steps whose input and output the reference checks."""
    rng = np.random.default_rng([seed, 1])
    return sorted(int(i) for i in rng.choice(
        traffic["sample_within"], traffic["sample_steps"], replace=False))


# ---------------------------------------------------------------------------
# The program's side

def build_model(config, device, x64):
    """The port's IslTransport for a configuration file, on `device`, in
    f64 (x64) or on the single-precision route."""
    from compose_tpu_torch.mesh import cubed_sphere
    from compose_tpu_torch.transport import gallery
    from compose_tpu_torch.transport.isl import IslConfig, IslTransport

    isl = config["isl"]
    mesh = cubed_sphere.build(config["ne"], config["np"], isl["basis"],
                              device=device,
                              dtype=torch.float64 if x64 else torch.float32)
    icfg = IslConfig(ne=config["ne"], np_=config["np"], basis=isl["basis"],
                     filter=isl["filter"], limiter=isl["limiter"],
                     rho_isl=isl["rho_isl"], nsub=isl["nsub"], dmc=isl["dmc"],
                     timeint=isl["timeint"], geom_dtype=isl["geom_dtype"],
                     interp_dtype=isl["interp_dtype"])
    return IslTransport(mesh, gallery.create_wind(config["wind"]), icfg)


class Program:
    """The system under test for one rank: the single-device step, or this
    rank's block of the sharded step."""

    def __init__(self, cell, device, variant, comm=None):
        cfg = cell.config
        # The control runs in the precision the configuration's file gives it.
        self.x64 = (cfg["control"] if variant == "control" else cfg)["x64"]
        self.model = build_model(cfg, device, self.x64)
        self.dtype = self.model.real
        self.comm = comm
        self.sh = None
        if comm is not None:
            from compose_tpu_torch.parallel.sharded import ShardedIsl
            ncell = self.model.mesh.ncell
            if ncell % comm.size:
                raise ValueError(f"{ncell} cells do not split evenly over "
                                 f"{comm.size} ranks")
            self.sh = ShardedIsl(self.model, comm.size,
                                 depth=cell.traffic["halo_depth"], comm=comm)
            # The contiguous layout the benchmark assembles blocks in.
            B = ncell // comm.size
            cells = self.sh.shards[comm.rank].cells.cpu()
            if not torch.equal(cells, torch.arange(comm.rank * B,
                                                   (comm.rank + 1) * B)):
                raise ValueError("the sharded layout is not contiguous")

    def local(self, x):
        """This rank's part of a global (..., ncell, np2) input."""
        x = x.to(self.dtype)
        if self.sh is None:
            return x.contiguous()
        return self.sh.to_block(x, self.comm.rank).contiguous()

    def step(self, rho, q, ts, tf):
        if self.sh is None:
            return self.model.step(rho, q, ts, tf)
        return self.sh.step_blocks(rho, q, ts, tf)

    def coverage_ok(self, cfg, rank, world):
        """The halo covers every step of the wind's period (this rank's
        share of the step times)."""
        return all(self.sh.coverage_ok(*step_times(k, cfg))
                   for k in range(rank, cfg["period_steps"], world))

    def wrap(self, spans):
        m = self.model
        spans.wrap(m, "_departure_data", "departure")
        if self.sh is None:
            spans.wrap(m, "_interp_phase", "interp")
            spans.wrap(m, "_rho_cdr", "rho_cdr")
            spans.wrap(m, "_tracer_cdr", "tracer_cdr")
            spans.wrap(m, "_dss_q", "dss")
        else:
            spans.wrap(self.sh, "_interp", "interp")
            spans.wrap(self.sh, "_rho_cdr", "rho_cdr")
            spans.wrap(self.sh, "_tracer_cdr", "tracer_cdr")


# ---------------------------------------------------------------------------
# One rank's run

class Dist:
    """The ranks' control channel (gloo, on the host), or nothing on one
    rank."""

    def __init__(self, group=None, rank=0, world=1):
        self.group, self.rank, self.world = group, rank, world
        if group is not None:
            import torch.distributed as dist
            self.dist = dist

    def bcast_flag(self, flag):
        if self.group is None:
            return flag
        t = torch.tensor([int(flag)])
        self.dist.broadcast(t, 0, group=self.group)
        return bool(t.item())

    def all_true(self, flag):
        if self.group is None:
            return flag
        t = torch.tensor([int(not flag)])
        self.dist.all_reduce(t, group=self.group)
        return t.item() == 0

    def gather_objects(self, obj):
        if self.group is None:
            return [obj]
        out = [None] * self.world if self.rank == 0 else None
        self.dist.gather_object(obj, out, dst=0, group=self.group)
        return out

    def gather_cells(self, x):
        """Rank 0: the global tensor from every rank's block (..., B, np2)
        in the contiguous layout; the others: None."""
        if self.group is None:
            return x
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.world)] \
            if self.rank == 0 else None
        self.dist.gather(x, parts, dst=0, group=self.group)
        return torch.cat(parts, dim=-2) if self.rank == 0 else None

    def barrier(self):
        if self.group is not None:
            self.dist.barrier(group=self.group)


SMI_QUERY = ("timestamp,index,name,clocks.sm,clocks.mem,power.draw,"
             "power.limit,temperature.gpu")


def smi_snapshot(path, index, when):
    """One line of nvidia-smi's clocks, power and temperature of the card,
    tagged `when` ("before" or "after" the window), appended to a CSV file;
    read just outside the window, so that no sampler runs inside it.
    Nothing if there is no nvidia-smi."""
    exe = shutil.which("nvidia-smi")
    if exe is None or path is None:
        return
    out = subprocess.run([exe, f"--query-gpu={SMI_QUERY}",
                          "--format=csv,noheader", "-i", str(index)],
                         capture_output=True, text=True, timeout=30)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "a") as f:
        f.write(f"{when},{out.stdout.strip()}\n")


def power_limit(index):
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return None
    out = subprocess.run([exe, "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", str(index)],
                         capture_output=True, text=True, timeout=30)
    return out.stdout.strip() or None


def rank_run(cell, seed, seconds, tracing, device, t_start, variant="program",
             comm=None, dist=None, smi_path=None, hooks=None):
    """One rank's run; rank 0 returns the result dict (the others None).
    `hooks` (tests only) may replace the step to plant a fault."""
    dist = dist or Dist()
    rank = dist.rank
    cfg, tr = cell.config, cell.traffic
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    parts = {}
    mark = [time.perf_counter()]

    def part(name):
        sync()
        t = time.perf_counter()
        parts[name] = t - mark[0]
        mark[0] = t

    # Inputs, made by the benchmark from the seed.
    ref_mesh = reference.build_mesh(cfg["ne"], cfg["np"], device=device)
    plan = reference.tracer_plan(seed, tr["families"], cfg["ntracer"])
    rho0, q0 = reference.initial_state(ref_mesh, plan, torch.float64)
    part("inputs")
    prog = Program(cell, device, variant, comm)
    if hooks:
        hooks(prog)
    rho_l, q_l = prog.local(rho0), prog.local(q0)
    # The window's start state stays on the host for the check; the card
    # holds only the program's state.
    start = (rho0.cpu(), q0.cpu())
    del rho0, q0, ref_mesh
    part("program")
    if prog.sh is not None and not dist.all_true(
            prog.coverage_ok(cfg, rank, dist.world)):
        raise RuntimeError("the halo does not cover every step's departure "
                           "footprint")
    part("coverage")
    state = (rho_l, q_l)
    for k in range(tr["warmup_steps"]):
        state = prog.step(*state, *step_times(k, cfg))
    part("warmup")
    del state
    samples = set(sample_indices(seed, tr))
    pin = cuda
    bufs = {k: [torch.empty(x.shape, dtype=x.dtype, pin_memory=pin)
                for x in (rho_l, q_l, rho_l, q_l)] for k in samples}

    spans = trace.Spans()
    launch_rec = syncs = None
    if tracing:
        from compose_tpu_torch import _native
        prog.wrap(spans)
        launch_rec = trace.LaunchRecorder(_native)
        syncs = trace.SyncCounter(cuda)
    if cuda:
        smi_snapshot(smi_path, device.index or 0, "before")
    gc.collect()
    gc.freeze()
    if comm is not None:
        comm.reset()
        comm.on = True

    # The measured window.
    dist.barrier()
    sync()
    host0 = hostdiag.snapshot()
    t0 = time.perf_counter()
    setup_s = time.time() - t_start
    marks = [_mark(cuda)]
    if tracing:
        spans.on = True
        syncs.__enter__()
    state = (rho_l, q_l)
    del rho_l, q_l
    k = 0
    while True:
        ts, tf = step_times(k, cfg)
        if k in samples:
            bufs[k][0].copy_(state[0], non_blocking=pin)
            bufs[k][1].copy_(state[1], non_blocking=pin)
        state = prog.step(*state, ts, tf)
        if k in samples:
            bufs[k][2].copy_(state[0], non_blocking=pin)
            bufs[k][3].copy_(state[1], non_blocking=pin)
        marks.append(_mark(cuda))
        k += 1
        done = rank == 0 and time.perf_counter() - t0 >= seconds \
            and k >= tr["sample_within"]
        if dist.bcast_flag(done):
            break
    sync()
    window_s = time.perf_counter() - t0
    host = hostdiag.summary(host0, hostdiag.snapshot(), window_s)
    if tracing:
        syncs.__exit__(None, None, None)
        span_s = dict(spans.seconds)
    nsteps = k
    step_ms = [_elapsed_ms(a, b) for a, b in zip(marks[:-1], marks[1:])]
    if cuda:
        smi_snapshot(smi_path, device.index or 0, "after")
    comm_b = comm_p2p = None
    if comm is not None:
        comm.on = False
        comm_b, comm_p2p = comm.bytes, comm.p2p_bytes

    traced = None
    if tracing and cuda:
        traced = _traced_window(prog, state, k, cfg, tr, launch_rec, sync)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    end = state
    del state

    # The program's part is over: free it, then gather for the check.
    gc.unfreeze()
    del prog
    if cuda:
        torch.cuda.empty_cache()
    end_g = [dist.gather_cells(x.to(torch.float64).cpu()) for x in end]
    del end
    samp_g = {}
    for i in sorted(samples):
        samp_g[i] = [dist.gather_cells(b) for b in bufs[i]]
    mine = dict(peak=peak, setup_parts=parts, host=host,
                comm_b=comm_b, comm_p2p=comm_p2p,
                traced=traced, span_s=span_s if tracing else None,
                syncs=syncs.count if tracing else None,
                sync_sites=(syncs.sites.most_common(8) if tracing
                            else None))
    per_rank = dist.gather_objects(mine)
    if rank != 0:
        return None

    t_check = time.perf_counter()
    ref = check.reference_for(cfg, device)
    smp = [(*step_times(i, cfg), *samp_g[i]) for i in sorted(samp_g)]
    nums = check.compare(ref, smp, start, end_g)
    check_s = time.perf_counter() - t_check
    correct, failed, table = check.judge(nums, cell.limits)
    return dict(nsteps=nsteps, window_s=window_s, step_ms=step_ms,
                setup_s=setup_s, per_rank=per_rank, nums=nums,
                correct=correct, failed=failed, table=table, check_s=check_s,
                samples=sorted(samples), device=device,
                dof=cfg["ne"] ** 2 * 6 * cfg["np"] ** 2 * cfg["ntracer"])


def _traced_window(prog, state, k0, cfg, tr, launch_rec, sync):
    """The profiled steps after the window: torch.profiler over
    `trace_steps` steps, reduced to busy time, launches, kernel times and
    the breakdown, with the recorded kernel launch shapes."""
    from torch.profiler import ProfilerActivity, profile

    n = tr["trace_steps"]
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        launch_rec.on = True
        with torch.profiler.record_function("bench_window"):
            for k in range(k0, k0 + n):
                state = prog.step(*state, *step_times(k, cfg))
            sync()
        launch_rec.on = False
    red = trace.reduce_events(trace.profiler_events(prof))
    if red is None:
        return None
    red["steps"] = n
    red["launch_args"] = {name: list(a) for name, a in
                          launch_rec.args.items()}
    return red


def _mark(cuda):
    if not cuda:
        return time.perf_counter()
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _elapsed_ms(a, b):
    if isinstance(a, float):
        return (b - a) * 1e3
    return a.elapsed_time(b)


# ---------------------------------------------------------------------------
# The result line

def result_line(cell, res, tracing, device, chips):
    """The JSON object of the run's last line."""
    pr = res["per_rank"]
    peak = max(r["peak"] for r in pr)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": chips, "memory_peak_bytes": peak}
    out = {"correct": bool(res["correct"]), "attempted": res["nsteps"],
           "failed": res["failed"]}
    if not tracing:
        vals = {"tracer_dof_per_s": res["dof"] * res["nsteps"]
                / res["window_s"],
                "step_ms_p95": p95(res["step_ms"]),
                "peak_mem_gib": peak / 2 ** 30,
                "setup_s": res["setup_s"]}
        metrics = {m["name"]: {"value": vals[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] in vals}
    else:
        rec = layer_record(res, chips)
        metrics = {}
        for m in cell.per_layer:
            v = spec.metric_reader(m["name"])(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        tr = [r["traced"] for r in pr if r["traced"]]
        if tr:
            dev["busy_s"] = sum(t["busy_s"] for t in tr) / len(tr)
            dev["window_s"] = sum(t["window_s"] for t in tr) / len(tr)
            out["breakdown"] = tr[0]["breakdown"]
    out["metrics"] = metrics
    out["device"] = dev
    out["limits"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in res["table"].items()}
    return out


def layer_record(res, chips):
    """What the per-layer readers read: rank 0's spans, trace and launch
    shapes; the communicator's largest per-rank numbers; the device busy
    time averaged over the ranks."""
    pr = res["per_rank"]
    r0 = pr[0]
    rec = dict(steps=res["nsteps"], span_s=r0["span_s"] or {},
               dof_per_s=res["dof"] * res["nsteps"] / res["window_s"],
               syncs=r0["syncs"], chips=chips, trace=r0["traced"])
    if r0["comm_b"] is not None:
        rec["comm_bytes"] = max(r["comm_b"] for r in pr)
        rec["comm_p2p_bytes"] = max(r["comm_p2p"] for r in pr)
    tr = [r["traced"] for r in pr if r["traced"]]
    if tr:
        rec["busy_s"] = sum(t["busy_s"] for t in tr) / len(tr)
        rec["window_s"] = sum(t["window_s"] for t in tr) / len(tr)
        rec["nccl_s"] = sum(t["nccl_s"] for t in tr) / len(tr)
    return rec


def limit_lines(res):
    """The compared numbers beside their limits, one per line."""
    lines = []
    for name, (v, lim) in res["table"].items():
        ok = v is not None and not math.isnan(v) and v <= lim
        lines.append(f"{name} {v!r} limit {lim!r} {'ok' if ok else 'FAIL'}")
    return lines


# ---------------------------------------------------------------------------
# Several ranks

def _rank_entry(rank, world, args, queue):
    """One spawned rank: NCCL for the step's collectives, gloo for the
    harness's own control messages."""
    import datetime
    import torch.distributed as dist

    from .comm import CountingDistComm

    try:
        timeout = datetime.timedelta(seconds=300)
        if args.get("backend", "nccl") == "nccl":
            torch.set_num_threads(int(os.environ["OMP_NUM_THREADS"]))
            torch.cuda.set_device(rank)
            device = torch.device("cuda", rank)
            dist.init_process_group("nccl", init_method=args["init"],
                                    rank=rank, world_size=world,
                                    device_id=device, timeout=timeout)
        else:
            # The CPU rehearsal and the tests: gloo ranks on the host.
            torch.set_num_threads(1)
            device = torch.device("cpu")
            dist.init_process_group("gloo", init_method=args["init"],
                                    rank=rank, world_size=world,
                                    timeout=timeout)
        gloo = dist.new_group(backend="gloo")
        comm = CountingDistComm(device)
        cell = spec.Cell(args["workload"])
        for k, v in args.get("override", {}).items():
            setattr(cell, k, dict(getattr(cell, k), **v))
        hooks = None
        if args.get("hook"):
            import importlib
            mod, fn = args["hook"].split(":")
            hooks = getattr(importlib.import_module(mod), fn)
        smi = (pathlib.Path(args["smi_dir"]) /
               f"smi-{args['workload']}-{args['seed']}-{args['trace']}"
               f"-rank{rank}.csv") if args["smi_dir"] else None
        jobs = args.get("jobs") or [(args["seed"], args["variant"])]
        ctl = Dist(gloo, rank, world)
        out = [rank_run(cell, seed, args["seconds"], args["trace"], device,
                        args["t_start"], variant, comm, ctl, smi, hooks)
               for seed, variant in jobs]
        # Every rank's modules once its part is over (rank 0's after the
        # check): the process that prints looks again at its own.
        bad = ctl.gather_objects(forbidden_modules())
        if rank == 0:
            for res in out:
                res["forbidden"] = sorted({m for b in bad for m in b})
            queue.put(("ok", out if args.get("jobs") else out[0]))
        dist.barrier(group=gloo)
        dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 - reported to the parent
        queue.put(("error", f"rank {rank}: {traceback.format_exc()}"))
        raise


def run_cell(cell, seed, seconds, tracing, t_start, variant="program",
             smi_dir=None):
    """Run a cell on its cards; returns rank 0's result dict."""
    require_cards(cell.chips)
    args = dict(workload=cell.name, seed=seed, seconds=seconds,
                trace=tracing, t_start=t_start, variant=variant,
                smi_dir=str(smi_dir) if smi_dir else None)
    if cell.chips == 1:
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        smi = (pathlib.Path(smi_dir) /
               f"smi-{cell.name}-{seed}-{tracing}.csv") if smi_dir else None
        return rank_run(cell, seed, seconds, tracing, device, t_start,
                        variant, smi_path=smi)
    return run_ranks(cell.chips, args)


def run_ranks(world, args, timeout=340):
    """Spawn `world` ranks, wait for every one, return rank 0's result
    (a list of them for the (seed, variant) pairs of args["jobs"])."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    # One process per card shares the host's cores: each rank's thread
    # pools (torch's, and OpenMP's under NumPy) take an equal part, so
    # that set-up's host work does not oversubscribe them.
    threads = str(max(1, (os.cpu_count() or world) // world))
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                "OPENBLAS_NUM_THREADS"):
        os.environ[var] = threads
    rdzv = tempfile.mkdtemp(prefix="bench-rdzv-")
    args = dict(args, init="file://" + os.path.join(rdzv, "init"))
    queue = ctx.Queue()
    procs = [ctx.Process(target=_rank_entry, args=(r, world, args, queue))
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        status, payload = queue.get(timeout=timeout)
    finally:
        deadline = time.time() + 60
        for p in procs:
            p.join(max(1.0, deadline - time.time()))
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(10)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(rdzv, ignore_errors=True)
    if status != "ok":
        raise RuntimeError(payload)
    if any(p.exitcode != 0 for p in procs):
        raise RuntimeError("a rank exited with code "
                           f"{[p.exitcode for p in procs]}")
    return payload
