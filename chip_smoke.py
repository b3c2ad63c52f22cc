"""GPU smoke run of the PyTorch + CUDA port (compose_tpu_torch) on one card.

    python3 chip_smoke.py            # every phase
    python3 chip_smoke.py --kernels  # phases 0-2 only (no result lines)

Phases (any failure raises, so the exit code is nonzero):
  0. device: CUDA is required; print the card's name and power limit;
  1. build the CUDA kernels (nvcc, sm_90a, one process per source) from
     compose_tpu_torch/csrc;
  2. each kernel, f64 (K1-K3) and f32 (K4 and K1/K2 at f32), against its
     plain PyTorch version on the card, at each shape the ne30 step
     launches it at, with seeded inputs that include infeasible cells and
     zero-density nodes: bitwise equality, exact bounds; per shape the
     device time (a CUDA graph of 50 launches), the call time (wrapper and
     kernel, CUDA events around one call), the plain version's call time
     and the bound. Then the shapes of the other ISL options: K1 at 54,
     216 and 1350 cells, K2 at np2 4, 9, 36, 64 (timed at ne15 np8's
     (40, 1350, 64)), 144 and 256, K3/K4 at np 6, 8 and 12 with the sphere
     measure, bitwise;
  3. small references (ne4 np4, 4 tracers, 3 steps: caas/caas and qlt/mn2
     in f64, qlt/mn2 in f32; ne3 np6 qlt/mn2 and ne3 np8 caas-node/caas
     dmc es in f64), the card against the CPU; then the paths with 40
     tracers, each driven through IslTransport.step with the launch counts
     set to 0 just before it and read just after, the Observer invariants
     asserted in the measure the path conserves:
       - the flagship step (ne30 np4, pisl CAAS/CAAS, f32 geometry and
         interpolation, f64 CDR) for one 12-day period of 120 steps: K1,
         K2, K3;
       - the single-precision route of the default CDR (pisl QLT/mn2,
         x64 off) for 120 steps: K4;
       - CAAS/CAAS with x64 off for 12 steps: K1, K2 and K4 in f32;
       - QLT/mn2 in f64 for 12 steps: K3;
       - caas-node/caas dmc es in f64 (sphere measure) for 12 steps: K2
         (the prefilter), K3;
       - ne15 np8 caas/caas with interpolated trajectories, dmc eh, in f64
         for 12 steps: K1, K2 at np2 64, K3;
  4. golden battery rows through driver.run, each with its own bars:
     isl_caas_flagship_f32, pisl qlt/mn2 and caas/mn2 ne10, pisl qlt np6,
     pisl qlt-pve ne10, the three pisl np12 runs (exact, interp, interp
     caas) and the four prefine-0 rows (ne6 np8, caas or caas-node, dmc es
     or eh).
The last two lines are the kernels' JSON summary and the device JSON.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

F64, F32 = torch.float64, torch.float32
K1_SRC = "compose_tpu_torch/csrc/glbl_caas.cu"
K2_SRC = "compose_tpu_torch/csrc/limit_caas.cu"
K34_SRC = "compose_tpu_torch/csrc/dss_q.cu"
# C entry -> (source, the TPU kernel it replaces).
KERNELS = {
    "glbl_caas_f64": (K1_SRC, "compose_tpu/transport/cdr_fused.py:57"),
    "limit_caas_f64": (K2_SRC, "compose_tpu/transport/cdr_fused.py:258"),
    "dss_q_f64": (K34_SRC, "compose_tpu/transport/dss_face.py:115"),
    "dss_q_f32": (K34_SRC, "compose_tpu/transport/dss_face.py:73"),
    "glbl_caas_f32": (K1_SRC, "compose_tpu/transport/cdr_fused.py:57"),
    "limit_caas_f32": (K2_SRC, "compose_tpu/transport/cdr_fused.py:258"),
}
# The H100 SXM's published peaks (NVIDIA data sheet): HBM3 3.35 TB/s;
# 67 TFLOP/s f32 and 34 TFLOP/s f64 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {F64: 34e12, F32: 67e12}
ICS4 = ["gaussianhills", "slottedcylinders", "cosinebells", "xyztrig"]


def log(*a):
    print(*a, flush=True)


def _events_ms(fn):
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e)


def cuda_ms(fn, reps=25):
    """Median time of one fn() call in ms over `reps` calls, from CUDA
    events around the call: the host work of a Python wrapper, during which
    the device idles, is inside it."""
    fn()
    torch.cuda.synchronize()
    return statistics.median(_events_ms(fn) for _ in range(reps))


def device_ms(fn, n=50, reps=5):
    """Device time of one fn() in ms: CUDA events around the replay of a
    CUDA graph that captured `n` calls, divided by `n`, median of `reps`
    replays. The replay launches the captured kernels back to back without
    the wrappers' host work; inputs stay warm in L2."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    ms = statistics.median(_events_ms(graph.replay) / n for _ in range(reps))
    del graph
    torch.cuda.empty_cache()
    return ms


def same(a, b, what):
    if not torch.equal(a, b):
        err = float((a - b).abs().max())
        raise AssertionError(f"{what}: kernel != plain (max |diff| {err})")


def bound(tensors, out, flops, dtype):
    """The least time (ms) the card could take: each input read once and
    the output written once at the HBM rate, or `flops` at the peak rate
    of `dtype`, whichever is larger."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors) \
        + out.numel() * out.element_size()
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes)


def phase_kernels(dev, stats, dtype, ne=30):
    """K1, K2 and the DSS merge (K3 in f64, K4 in f32) of `dtype` against
    their plain versions at each shape the ne30 step launches them at:
    bitwise equality and bounds, then per shape the device time (CUDA
    graph), the call time (wrapper + kernel), the plain version's call time
    and the bound."""
    from compose_tpu_torch.mesh import cubed_sphere
    from compose_tpu_torch.transport import cdr_fused, dss

    sfx = {F64: "f64", F32: "f32"}[dtype]
    rng = np.random.default_rng(20261016)
    kw = dict(dtype=dtype, device=dev)
    mesh = cubed_sphere.build(ne, 4, device=dev, dtype=dtype)
    ncell, np2, nt = mesh.ncell, mesh.np2, 40
    eps = torch.finfo(dtype).eps

    def record(name, err, fn, plain, args, out, flops, shape, summary=True):
        """Time one (C entry, shape); the entry's summary numbers are
        those of its flagship 40-row shape (summary=True)."""
        row = dict(shape=list(shape), ms=device_ms(fn), call_ms=cuda_ms(fn),
                   plain_ms=cuda_ms(plain), **bound(args, out, flops, dtype))
        st = stats.setdefault(name, dict(shapes=[], library_ms=None,
                                         max_abs_err=0.0))
        st["shapes"].append(row)
        st["max_abs_err"] = max(st["max_abs_err"], err)
        if summary:
            st.update({k: row[k] for k in ("ms", "call_ms", "plain_ms",
                                           "bound_ms", "bound_by")})
        log(f"{name} {tuple(shape)}: bitwise == plain, bounds held; device "
            f"{row['ms']:.5f} ms, call {row['call_ms']:.4f} ms, plain "
            f"{row['plain_ms']:.4f} ms; bound {row['bound_ms']:.5f} ms "
            f"({row['bytes'] / 1e6:.2f} MB, {row['bound_ms'] / row['ms']:.1%}"
            f" of it)")

    # K1: per-cell records; infeasible cells (mass outside [min, max]).
    def k1_inputs(rows):
        mn = rng.uniform(0.0, 1.0, (rows, ncell))
        mx = mn + rng.uniform(0.0, 1.0, (rows, ncell))
        ms = rng.uniform(-0.5, 2.5, (rows, ncell))   # ~1/3 out of bounds
        # Feasible targets: the total lands between sum(min) and sum(max).
        tgt = mn.sum(1) + rng.uniform(0.2, 0.8, rows) * (mx - mn).sum(1)
        return [torch.tensor(x, **kw) for x in (mn, ms, mx, tgt - ms.sum(1))]

    err = 0.0
    for rows in (1, nt):
        a1 = k1_inputs(rows)
        out = cdr_fused.glbl_caas(*a1)
        ref = cdr_fused.glbl_caas_plain(*a1)
        torch.cuda.synchronize()
        same(out, ref, f"glbl_caas_{sfx} ({rows}, {ncell})")
        # (m / sum v) * v rounds, so the feasible bounds hold to roundoff
        # (an ulp or two), not exactly: held to 1e2 eps of the bound. A
        # clipped cell's mass + (bound - mass) also rounds at the scale of
        # the mass, which f32 resolves above 1e2 eps of a small bound: the
        # f32 bar scales with the larger of the two.
        mn, ms, mx = a1[0], a1[1], a1[2]
        scale_lo, scale_hi = mn.abs(), mx.abs()
        if dtype == F32:
            scale_lo = torch.maximum(scale_lo, ms.abs())
            scale_hi = torch.maximum(scale_hi, ms.abs())
        if not (bool((out >= mn - 1e2 * eps * scale_lo).all())
                and bool((out <= mx + 1e2 * eps * scale_hi).all())):
            raise AssertionError("K1: feasible problem left its bounds")
        err = max(err, float((out - ref).abs().max()))
        # The rho call passes 1-D records and a 0-d extra mass.
        if rows == 1:
            a1 = [x[0] for x in a1]
        record(f"glbl_caas_{sfx}", err,
               lambda a=a1: cdr_fused.glbl_caas(*a),
               lambda a=a1: cdr_fused.glbl_caas_plain(*a), a1, out,
               12 * rows * ncell, (rows, ncell))
    # The cell counts of the np6, np8 and np12 meshes (ne3, ne6, ne15).
    for nc in (54, 216, 1350):
        for rows in (1, nt):
            mn = rng.uniform(0.0, 1.0, (rows, nc))
            mx = mn + rng.uniform(0.0, 1.0, (rows, nc))
            ms = rng.uniform(-0.5, 2.5, (rows, nc))
            tgt = mn.sum(1) + rng.uniform(0.2, 0.8, rows) * (mx - mn).sum(1)
            a = [torch.tensor(x, **kw) for x in (mn, ms, mx, tgt - ms.sum(1))]
            same(cdr_fused.glbl_caas(*a), cdr_fused.glbl_caas_plain(*a),
                 f"glbl_caas_{sfx} ({rows}, {nc})")
        log(f"glbl_caas_{sfx} (1|{nt}, {nc}): bitwise == plain")

    # K2: zero-density nodes and infeasible cells (targets outside the
    # cell's [sum a qmin, sum a qmax]) included; every np2 the ISL options
    # launch it at. ncell: the ne30 np4 mesh at np2 16, ne15 (the same
    # 86,400 slots) at np2 64, else about 86,400 slots' worth.
    def k2_inputs(nc, p2, F):
        rho = rng.uniform(0.5, 1.5, (nc, p2))
        rho[rng.random((nc, p2)) < 0.02] = 0.0
        qmin = rng.uniform(0.0, 0.5, (nt, nc, p2))
        qmax = qmin + rng.uniform(0.0, 0.5, (nt, nc, p2))
        Q = rng.uniform(-0.2, 1.2, (nt, nc, p2)) * rho
        rhom = F * rho
        b = (rhom * rng.uniform(-0.1, 1.1, (nt, nc, p2))).sum(-1)
        return [torch.tensor(x, **kw) for x in (rhom, rho, Q, qmin, qmax, b)]

    mesh15 = cubed_sphere.build(15, 8, device=dev, dtype=dtype)
    for p2 in (16, 4, 9, 36, 64, 144, 256):
        if p2 == 16:
            F = mesh.dgbfi_gll.to(F64).cpu().numpy()
        elif p2 == 64:
            F = mesh15.dgbfi_gll.to(F64).cpu().numpy()
        else:
            F = rng.uniform(0.5, 1.5, (86400 // p2, p2)) * 1e-4
        nc = F.shape[0]
        a2 = k2_inputs(nc, p2, F)
        out = cdr_fused.limit_caas(*a2)
        ref = cdr_fused.limit_caas_plain(*a2)
        torch.cuda.synchronize()
        same(out, ref, f"limit_caas_{sfx} ({nt}, {nc}x{p2})")
        if not (bool((out >= a2[3]).all()) and bool((out <= a2[4]).all())):
            raise AssertionError("K2: output outside [qmin, qmax]")
        if p2 in (16, 64):
            record(f"limit_caas_{sfx}", float((out - ref).abs().max()),
                   lambda a=a2: cdr_fused.limit_caas(*a),
                   lambda a=a2: cdr_fused.limit_caas_plain(*a), a2, out,
                   30 * nt * nc * p2, (nt, nc, p2), summary=p2 == 16)
        else:
            log(f"limit_caas_{sfx} ({nt}, {nc}, {p2}): bitwise == plain, "
                f"bounds held")

    # K3 / K4: zero-density nodes exercise the F-weighted fallback.
    ndgll = ncell * np2
    Ff = mesh.dgbfi_gll.reshape(-1).contiguous()
    rho_n = torch.tensor(rng.uniform(0.5, 1.5, ndgll), **kw)
    rho_n[torch.tensor(rng.random(ndgll) < 0.05, device=dev)] = 0.0
    w = Ff * rho_n
    d2c = mesh.dgll2cgll.reshape(-1)
    # Built once per mesh, as IslTransport does. The bound counts the
    # public (cnn, 4) int32 index and mask instead, as it did before the
    # kernel had a private table, so bounds compare the same work.
    slots = dss.slot_table(mesh.c2d_idx, mesh.c2d_mask, d2c)
    idx32 = mesh.c2d_idx.to(torch.int32)
    err = 0.0
    for rows in (1, nt):
        q = torch.tensor(rng.uniform(0.0, 1.0, (rows, ndgll)), **kw)
        kargs = (w, Ff, q, mesh.c2d_idx, mesh.c2d_mask, d2c)
        out = dss.dss_q(*kargs, slots=slots)
        ref = dss.dss_q_plain(*kargs)
        torch.cuda.synchronize()
        same(out, ref, f"dss_q_{sfx} ({rows}, {ndgll})")
        vals = q[:, mesh.c2d_idx]
        inf = torch.tensor(float("inf"), **kw)
        lo = torch.where(mesh.c2d_mask, vals, inf).amin(-1)[:, d2c]
        hi = torch.where(mesh.c2d_mask, vals, -inf).amax(-1)[:, d2c]
        if not (bool((out >= lo).all()) and bool((out <= hi).all())):
            raise AssertionError("DSS merge: output outside the slot range")
        err = max(err, float((out - ref).abs().max()))
        record(f"dss_q_{sfx}", err,
               lambda a=kargs: dss.dss_q(*a, slots=slots),
               lambda a=kargs: dss.dss_q_plain(*a),
               (w, Ff, q, idx32, mesh.c2d_mask), out, 17 * rows * mesh.cnn,
               (rows, ndgll))
    # np 6, 8 and 12 with the sphere measure (dmc es), at the meshes of the
    # new paths and golden rows.
    for ne_n, n in ((6, 6), (15, 8), (6, 8), (3, 12)):
        m = mesh15 if (ne_n, n) == (15, 8) else cubed_sphere.build(
            ne_n, n, device=dev, dtype=dtype)
        nd = m.ncell * m.np2
        Fs = m.dgbfi_sphere.reshape(-1).contiguous()
        r = torch.tensor(rng.uniform(0.5, 1.5, nd), **kw)
        r[torch.tensor(rng.random(nd) < 0.05, device=dev)] = 0.0
        d2c_n = m.dgll2cgll.reshape(-1)
        for rows in (1, nt):
            a = (Fs * r, Fs, torch.tensor(rng.uniform(0.0, 1.0, (rows, nd)),
                                          **kw), m.c2d_idx, m.c2d_mask, d2c_n)
            same(dss.dss_q(*a), dss.dss_q_plain(*a),
                 f"dss_q_{sfx} ({rows}, {nd}) np{n}")
        log(f"dss_q_{sfx} (1|{nt}, {nd}) ne{ne_n} np{n}, sphere measure: "
            f"bitwise == plain")


def _model(dev, ne, nt, dtype, np_=4, basis="GllNodal", **cfg):
    from compose_tpu_torch import driver
    from compose_tpu_torch.mesh import cubed_sphere
    from compose_tpu_torch.transport import gallery
    from compose_tpu_torch.transport.isl import IslConfig, IslTransport

    mesh = cubed_sphere.build(ne, np_, basis, device=dev, dtype=dtype)
    model = IslTransport(mesh, gallery.create_wind("divergent"),
                         IslConfig(ne=ne, np_=np_, basis=basis, **cfg))
    rho = torch.ones((mesh.ncell, mesh.np2), dtype=dtype, device=dev)
    q1 = driver.init_tracers(mesh, ICS4)
    q = q1.repeat(-(-nt // q1.shape[0]), 1, 1)[:nt].contiguous()
    return mesh, model, rho, q


def phase_small_reference(dev):
    """ne4 (np4) and ne3 (np6, np8), 4 tracers, 3 steps: the card
    (kernels) against the CPU (plain versions), in f64 (tolerance 1e-12)
    and on the single-precision route (1e-4: torch's CUDA and CPU ops round
    f32 differently)."""
    for ne, n, cfg, dtype, tol in (
            (4, 4, dict(filter="caas", limiter="caas"), F64, 1e-12),
            (4, 4, dict(filter="qlt", limiter="mn2"), F64, 1e-12),
            (4, 4, dict(filter="qlt", limiter="mn2"), F32, 1e-4),
            (3, 6, dict(filter="qlt", limiter="mn2"), F64, 1e-12),
            (3, 8, dict(filter="caas-node", limiter="caas", dmc="es"), F64,
             1e-12)):
        res = {}
        for d in ("cpu", dev):
            _, model, rho, q = _model(d, ne, 4, dtype, np_=n, nsub=2, **cfg)
            dt = 86400.0 * 12 / 3
            for s in range(3):
                rho, q = model.step(rho, q, s * dt, (s + 1) * dt)
            res[str(d)] = (rho.cpu(), q.cpu())
        (rc, qc), (rg, qg) = res["cpu"], res[str(dev)]
        err = max(float((rc - rg).abs().max()), float((qc - qg).abs().max()))
        opts = " ".join(f"{k} {v}" for k, v in cfg.items())
        log(f"small reference (ne{ne} np{n}, 4 tracers, 3 steps, {opts}, "
            f"{str(dtype)[6:]}): max |card - cpu| = {err:.3e} "
            f"(tolerance {tol:g})")
        if not err <= tol:
            raise AssertionError(f"card run disagrees with the CPU run: {err}")


def run_path(dev, name, dtype, nsteps, want, mass_tol=1e-12,
             bounds_tol=5e-13, ne=30, nt=40, np_=4, measure="gll", **cfg):
    """Drive one path (ne30 np4 unless told otherwise) with 40 tracers for
    `nsteps` steps of a 12-day period through IslTransport.step, with every
    launch count set to 0 just before and read just after. `want`:
    launches per step of each kernel (every other kernel must not launch).
    The Observer checks mass in `measure` (gll, or sphere for dmc es).
    Returns the launch counts and the model with its final state."""
    from compose_tpu_torch import _native, driver
    from compose_tpu_torch.diagnostics import Observer

    mesh, model, rho, q = _model(dev, ne, nt, dtype, np_=np_, **cfg)
    q0, rho0 = q, rho
    obs = Observer(mesh.dgbfi_gll, mesh.dgbfi_sphere,
                   ["rho"] + [f"q{i}" for i in range(nt)])
    obs.add_obs(0.0, rho, list(q))
    T = 86400.0 * 12
    dt = T / nsteps

    for k in _native.KERNELS.values():
        k.launches = 0
    step_s = []
    for s in range(nsteps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rho, q = model.step(rho, q, s * dt, T if s == nsteps - 1
                            else (s + 1) * dt)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        obs.add_obs((s + 1) * dt, rho, list(q))
    launches = {n: k.launches for n, k in _native.KERNELS.items()}

    expect = {n: want.get(n, 0) * nsteps for n in _native.KERNELS}
    if launches != expect:
        raise AssertionError(f"{name}: launch counts {launches} != {expect}")
    if not (bool(torch.isfinite(q).all()) and bool(torch.isfinite(rho).all())
            and q.shape == q0.shape and rho.shape == rho0.shape
            and q.dtype == rho.dtype == dtype):
        raise AssertionError(f"{name}: non-finite or misshapen state")
    ok, mass_err, bounds_err = obs.check(mass_tol, bounds_tol, measure)
    if not ok:
        raise AssertionError(f"{name}: Observer check failed: mass "
                             f"{mass_err:.3e}, bounds {bounds_err:.3e}")
    out = driver.summarize(mesh, q0[0], rho0, q[0], rho)
    sec = statistics.median(step_s[1:])
    per_step = " ".join(f"{n} {launches[n] // nsteps}" for n in want)
    log(f"{name}: ne{ne} np{np_} {nt} tracers, {nsteps} steps: step "
        f"{sec * 1e3:.3f} ms (median of steps 2..{nsteps}; first "
        f"{step_s[0] * 1e3:.1f} ms), {mesh.ncell * mesh.np2 * nt / sec:.4e} "
        f"tracer-DOF/s; l2 {out.l2_err:.4e} cv_gll {out.cv_gll:.3e} cv "
        f"{out.cv:.3e}; Observer mass ({measure}) {mass_err:.3e} bounds "
        f"{bounds_err:.3e} (bars "
        f"{mass_tol:g}, {bounds_tol:g}); launches/step {per_step}")
    return launches, model, rho, q


def phase_paths(dev):
    """The four ne30 paths; returns each kernel's launch count from the
    path that carries it."""
    from compose_tpu_torch.ops import local_qp

    counts = {}
    launches, *_ = run_path(
        dev, "flagship pisl caas/caas (f32 geometry+interp, f64 CDR)", F64,
        120, {"glbl_caas_f64": 2, "limit_caas_f64": 1, "dss_q_f64": 2},
        filter="caas", limiter="caas", nsub=8, geom_dtype="f32",
        interp_dtype="f32")
    counts.update({n: launches[n] for n in ("glbl_caas_f64",
                                            "limit_caas_f64", "dss_q_f64")})
    launches, model, rho, q = run_path(
        dev, "single-precision pisl qlt/mn2 (x64 off)", F32, 120,
        {"dss_q_f32": 2}, mass_tol=1e-5, filter="qlt", limiter="mn2",
        nsub=8)
    counts["dss_q_f32"] = launches["dss_q_f32"]
    # Where the f32 step's time goes, and the mn2 limiter's Newton cost:
    # its QP at the step's shapes, timed at 25 and at 50 iterations (the
    # f64-eps residual tolerance is out of f32's reach, so both run to
    # max_its, and the difference is 25 iterations' cost).
    _log_phases("single-precision qlt/mn2", model, rho, q)
    a = torch.clamp_min(model.F * rho, 1e-300)
    b = torch.sum(a[None] * q, dim=-1) * 1.001
    qp = (a, a, b, q * 0.9, q * 1.1, q)
    t25, t50 = (cuda_ms(lambda: local_qp.solve_1eq_bc_qp(*qp, max_its=k),
                        reps=5) for k in (25, 50))
    log(f"mn2 limiter QP (40 x 5400 cells of 16 nodes, f32): {t50:.3f} ms "
        f"at 50 iterations, {t25:.3f} ms at 25: "
        f"{(t50 - t25) / 25:.4f} ms per Newton iteration")
    launches, *_ = run_path(
        dev, "single-precision pisl caas/caas (x64 off)", F32, 12,
        {"glbl_caas_f32": 2, "limit_caas_f32": 1, "dss_q_f32": 2},
        mass_tol=1e-5, filter="caas", limiter="caas", nsub=8)
    counts.update({n: launches[n] for n in ("glbl_caas_f32",
                                            "limit_caas_f32")})
    run_path(dev, "pisl qlt/mn2 f64", F64, 12, {"dss_q_f64": 2},
             filter="qlt", limiter="mn2", nsub=8)
    # The global-only nodal filter with its relaxed-bounds prefilter (K2),
    # conserving the sphere measure; and the high-order Islet
    # configuration of the battery's prefine-0 rows (np8, interpolated
    # trajectories) at the flagship's 86,400 DGLL slots (ne15), with K2 at
    # np2 64.
    _, model, rho, q = run_path(
        dev, "pisl caas-node/caas dmc es (f64)", F64, 12,
        {"limit_caas_f64": 1, "dss_q_f64": 2}, measure="sphere",
        filter="caas-node", limiter="caas", dmc="es", nsub=8)
    _log_phases("caas-node/caas dmc es", model, rho, q)
    _, model, rho, q = run_path(
        dev, "pisl caas/caas np8 interp dmc eh (f64)", F64, 12,
        {"glbl_caas_f64": 2, "limit_caas_f64": 1, "dss_q_f64": 2},
        ne=15, np_=8, filter="caas", limiter="caas", dmc="eh",
        timeint="interp", nsub=8)
    _log_phases("np8 interp caas/caas", model, rho, q)
    return counts


def _log_phases(label, model, rho, q):
    """Where one step's time goes: IslTransport.phase_times, each phase
    run alone 5 times (so the phases need not add up to the step)."""
    pt = model.phase_times(rho, q, 0.0, 8640.0, iters=5)
    log(f"{label} phases (ms): " + ", ".join(
        f"{k} {v * 1e3:.3f}" for k, v in pt.items()))


def _row_ok(out, bars):
    """A golden row's asserts: l2 in (0, bar]; cv / cv_gll (conservation in
    the sphere / GLL measure), min and max where the row bounds them; with
    "step", the per-step invariants (mass < 1e-12, bounds < 5e-13)."""
    ok = 0 < out.l2_err <= bars["l2"]
    for k in ("cv", "cv_gll"):
        if k in bars:
            ok = ok and getattr(out, k) <= bars[k]
    if "min" in bars:
        ok = ok and out.min_e >= bars["min"]
    if "max" in bars:
        ok = ok and out.max_e <= bars["max"]
    if bars.get("step"):
        ok = (ok and out.max_step_mass_err < 1e-12
              and out.max_step_bounds_err < 5e-13)
    return ok


def phase_golden(dev):
    """Golden battery rows through driver.run, each with its own bars, as
    tests/test_transport_e2e.py and tests/test_regression_battery.py hold
    the JAX package."""
    from compose_tpu_torch import driver
    ics = ("slottedcylinders", "cosinebells", "gaussianhills")
    gh = ("gaussianhills",)
    std = dict(cv_gll=5e-14, min=0.1, max=1.0, step=True)
    pref = dict(ne=6, np_=8, nsteps=13, ics=gh, timeint="interp")
    rows = (
        ("isl_caas_flagship_f32", dict(std, l2=3.47e-1),
         dict(ne=10, ics=ics, filter_="caas", limiter="caas",
              geom_dtype="f32", interp_dtype="f32")),
        ("pisl_qlt_ne10", dict(std, l2=3.34e-1),
         dict(ne=10, ics=ics, filter_="qlt", limiter="mn2")),
        ("pisl_caas_ne10", dict(std, l2=3.47e-1),
         dict(ne=10, ics=ics, filter_="caas", limiter="mn2")),
        ("pisl_qlt_np6", dict(std, l2=3.34e-1),
         dict(ne=6, np_=6, ics=ics, filter_="qlt", limiter="mn2")),
        ("pisl_qlt_pve_ne10", dict(std, l2=3.36e-1, min=0.0, max=2.0),
         dict(ne=10, ics=ics, filter_="qlt-pve", limiter="mn2")),
        ("pisl_np12_exact", dict(l2=8.793e-3),
         dict(ne=3, np_=12, ics=gh, filter_="none", limiter="none")),
        ("pisl_np12_interp", dict(l2=9.939e-3),
         dict(ne=3, np_=12, ics=gh, filter_="none", limiter="none",
              timeint="interp")),
        ("pisl_np12_interp_caas",
         dict(l2=2.896e-1, cv_gll=5e-14, min=0.1, max=1.0),
         dict(ne=3, np_=12, ics=("slottedcylinders",), filter_="caas",
              limiter="mn2", timeint="interp")),
        ("pref0_es_caas", dict(l2=5.968e-3, cv=2e-14),
         dict(pref, filter_="caas", limiter="caas", dmc="es")),
        ("pref0_eh_caas", dict(l2=5.968e-3, cv_gll=2e-14),
         dict(pref, filter_="caas", limiter="caas", dmc="eh")),
        ("pref0_es_caasnode", dict(l2=5.968e-3, cv=2e-14),
         dict(pref, filter_="caas-node", limiter="caas", dmc="es")),
        ("pref0_eh_caasnode", dict(l2=5.968e-3, cv_gll=2e-14),
         dict(pref, filter_="caas-node", limiter="caas", dmc="eh")),
    )
    for name, bars, kw in rows:
        kw = dict(dict(np_=4, nsteps=12), **kw)
        out = driver.run(verbose=False, device=dev, **kw)
        shown = ", ".join(f"{k} {bars[k]:g}" for k in ("l2", "cv", "cv_gll",
                                                        "min", "max")
                          if k in bars)
        log(f"golden {name} (ne{kw['ne']} np{kw['np_']}, {kw['nsteps']} "
            f"steps): l2 {out.l2_err:.4e} cv_gll {out.cv_gll:.3e} cv "
            f"{out.cv:.3e} min {out.min_e:.4f} max {out.max_e:.4f} "
            f"step-mass {out.max_step_mass_err:.3e} step-bounds "
            f"{out.max_step_bounds_err:.3e} (bars: {shown})")
        if not _row_ok(out, bars):
            raise AssertionError(f"golden row {name} failed")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    from compose_tpu_torch import _native

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    log(smi.stdout.strip().splitlines()[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    _native.lib()
    log(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s "
        f"({_native.library_path().name})")

    # The floor under any device time below: one one-element torch kernel
    # per graph node.
    one = torch.zeros(1, dtype=F32, device=dev)
    log(f"graph launch floor: {device_ms(lambda: one.add_(1.0)):.5f} ms "
        f"per launch (one-element add_)")
    stats = {}
    phase_kernels(dev, stats, F64)
    phase_kernels(dev, stats, F32)
    if "--kernels" in sys.argv[1:]:
        return
    phase_small_reference(dev)
    launches = phase_paths(dev)
    phase_golden(dev)

    keys = ("max_abs_err", "ms", "call_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "shapes")
    print(json.dumps({"kernels": [
        dict(name=n, route="cuda", source=src, replaces=rep,
             launches=launches[n], **{k: stats[n][k] for k in keys})
        for n, (src, rep) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
