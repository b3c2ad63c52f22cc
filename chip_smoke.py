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
     216 and 1350 cells (timed at 1350, the np8 interp path's), K2 at np2
     4, 9, 36, 64 (timed at ne15 np8's (40, 1350, 64) and, f64, at the
     prefine-5 path's ne30 np8 (40, 5400, 64)), 144 and 256, K3/K4 at np
     6, 8 and 12 with the sphere measure, bitwise;
  3. small references (ne4 np4, 4 tracers, 3 steps: caas/caas and qlt/mn2
     in f64, qlt/mn2 in f32; ne3 np6 qlt/mn2 and ne3 np8 caas-node/caas
     dmc es in f64; the cell-integrated paths' configs at ne3 and a ne2
     gllsubcell CDG dmc ef run, 2 steps), the card against the CPU; then
     the paths with 40
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
     and the cell-integrated paths (ne30 np4, f64, 12 steps of 2.4 h),
     each through its step with the Observer in the measure it conserves
     (IrTransport.F_mass), its peak device memory, and torch.profiler's
     busy share and launches over 3 more steps:
       - A: ir, dmc f, caas/caas, d2c: K1, K2, K3 twice; run twice, and
         the two runs must be bitwise equal;
       - B: cdg, dmc es, qlt/mn2, d2c: K3 twice;
       - C: the mixed isl method (IrTransport.remap_rho with dmc eh, then
         the ISL step with qlt/mn2 and that target density): K3 twice;
     and the p-refinement and physics-grid paths (ne30, 40 tracers, f64,
     12 steps of 2.4 h, each profiled over 3 more), with the small
     references of their configs (prefine 5 and 1 at ne3 np6, the pg2 toy
     chemistry at ne4, a moving-vortices step at ne4) before them:
       - P5: prefine 5, the fine np8 grid under the np4 v grid, caas/caas,
         dmc eh (v-grid GLL mass): K1 twice, K2 twice (the fine limiter
         at np2 64, the t -> v transfer at np2 16; the first step a third,
         v -> t), K3 once per step, each step's counts printed;
       - PG: ne30pg2, the toy chemistry on the physics grid before each
         pisl caas/caas step: K1, K2, K3 as the flagship; tracers 0-1 in
         [0, 4e-6], the others held to mass and bounds;
  4. golden battery rows through driver.run, each with its own bars:
     isl_caas_flagship_f32, pisl qlt/mn2 and caas/mn2 ne10, pisl qlt np6,
     pisl qlt-pve ne10, the three pisl np12 runs (exact, interp, interp
     caas) and the four prefine-0 rows (ne6 np8, caas or caas-node, dmc es
     or eh); then the 42 rows of IR_GOLDEN (ir, cdg, subcell meshes,
     perturbed density, the mixed isl method); the battery's ten
     prefine-5 rows, test_prefine_experiments' two runs,
     test_physgrid_coupled_toychem and test_moving_vortices_analytic.
Phase 2 also times K2 f32 at (40, 5400, 64), and phase 3 adds the small
references of the new routes (the x64-off route of
A-C's configs, prefine 5 and pg2; the two mixed geometry/interpolation
precisions; card against CPU, 1e-5) and, at ne30 with 40 tracers, 12
steps each, the x64-off paths A' (ir dmc f caas/caas d2c: K1, K2 f32, K4
twice; run twice, bitwise), B' (cdg dmc es qlt/mn2: K4 twice), C' (the
mixed isl method: K4 twice), P5' (prefine 5: K1 f32 twice, K2 f32 at np2
64 and 16, K4) and PG' (pg2 toy chemistry: K1, K2, K4 in f32), and the
flagship with f64 geometry and f32 interpolation and the reverse (K1-K3);
then the command line through a subprocess on the card (-rit, the
Lauritzen, midpoint, footprint and timer lines, NetCDF and raster output
read back) and a checkpoint resume, bitwise. The kernels' JSON adds
`launches_precision`, each kernel's launches on those paths.
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

    def k1_bounds(out, mn, ms, mx):
        # (m / sum v) * v rounds, so the feasible bounds hold to roundoff
        # (an ulp or two), not exactly: held to 1e2 eps of the bound. A
        # clipped cell's mass + (bound - mass) also rounds at the scale of
        # the mass, which f32 resolves above 1e2 eps of a small bound: the
        # f32 bar scales with the larger of the two.
        scale_lo, scale_hi = mn.abs(), mx.abs()
        if dtype == F32:
            scale_lo = torch.maximum(scale_lo, ms.abs())
            scale_hi = torch.maximum(scale_hi, ms.abs())
        if not (bool((out >= mn - 1e2 * eps * scale_lo).all())
                and bool((out <= mx + 1e2 * eps * scale_hi).all())):
            raise AssertionError("K1: feasible problem left its bounds")

    err = 0.0
    for rows in (1, nt):
        a1 = k1_inputs(rows)
        out = cdr_fused.glbl_caas(*a1)
        ref = cdr_fused.glbl_caas_plain(*a1)
        torch.cuda.synchronize()
        same(out, ref, f"glbl_caas_{sfx} ({rows}, {ncell})")
        k1_bounds(out, *a1[:3])
        err = max(err, float((out - ref).abs().max()))
        # The rho call passes 1-D records and a 0-d extra mass.
        if rows == 1:
            a1 = [x[0] for x in a1]
        record(f"glbl_caas_{sfx}", err,
               lambda a=a1: cdr_fused.glbl_caas(*a),
               lambda a=a1: cdr_fused.glbl_caas_plain(*a), a1, out,
               12 * rows * ncell, (rows, ncell))
    # The cell counts of the np6, np8 and np12 meshes (ne3, ne6, ne15);
    # timed at 1350 cells, the np8 interp path's.
    for nc in (54, 216, 1350):
        for rows in (1, nt):
            mn = rng.uniform(0.0, 1.0, (rows, nc))
            mx = mn + rng.uniform(0.0, 1.0, (rows, nc))
            ms = rng.uniform(-0.5, 2.5, (rows, nc))
            tgt = mn.sum(1) + rng.uniform(0.2, 0.8, rows) * (mx - mn).sum(1)
            a = [torch.tensor(x, **kw) for x in (mn, ms, mx, tgt - ms.sum(1))]
            out = cdr_fused.glbl_caas(*a)
            same(out, cdr_fused.glbl_caas_plain(*a),
                 f"glbl_caas_{sfx} ({rows}, {nc})")
            if nc == 1350:
                k1_bounds(out, *a[:3])
                if rows == 1:
                    a = [x[0] for x in a]
                record(f"glbl_caas_{sfx}", 0.0,
                       lambda a=a: cdr_fused.glbl_caas(*a),
                       lambda a=a: cdr_fused.glbl_caas_plain(*a), a, out,
                       12 * rows * nc, (rows, nc), summary=False)
        if nc != 1350:
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
    # The prefine-5 paths' fine-grid limiter: ne30 np8, (40, 5400, 64), in
    # f64 (P5) and f32 (P5', the single-precision route).
    F = cubed_sphere.build(ne, 8, device=dev).dgbfi_gll.cpu().numpy()
    a2 = k2_inputs(F.shape[0], 64, F)
    out = cdr_fused.limit_caas(*a2)
    ref = cdr_fused.limit_caas_plain(*a2)
    torch.cuda.synchronize()
    same(out, ref, f"limit_caas_{sfx} ({nt}, {F.shape[0]}x64)")
    if not (bool((out >= a2[3]).all()) and bool((out <= a2[4]).all())):
        raise AssertionError("K2: output outside [qmin, qmax]")
    record(f"limit_caas_{sfx}", float((out - ref).abs().max()),
           lambda a=a2: cdr_fused.limit_caas(*a),
           lambda a=a2: cdr_fused.limit_caas_plain(*a), a2, out,
           30 * nt * F.shape[0] * 64, (nt, F.shape[0], 64), summary=False)

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
    from compose_tpu_torch.mesh import cubed_sphere
    from compose_tpu_torch.transport import gallery
    from compose_tpu_torch.transport.isl import IslConfig, IslTransport

    mesh = cubed_sphere.build(ne, np_, basis, device=dev, dtype=dtype)
    model = IslTransport(mesh, gallery.create_wind("divergent"),
                         IslConfig(ne=ne, np_=np_, basis=basis, **cfg))
    return (mesh, model) + _state(mesh, nt)


def _state(mesh, nt):
    """Density 1 and `nt` tracers: the four bench ICs tiled."""
    from compose_tpu_torch import driver

    rho = torch.ones((mesh.ncell, mesh.np2), dtype=mesh.dtype,
                     device=mesh.device)
    q1 = driver.init_tracers(mesh, ICS4)
    return rho, q1.repeat(-(-nt // q1.shape[0]), 1, 1)[:nt].contiguous()


def _ir_model(dev, ne, nt, np_=4, mesh_type="geometric", mixed=False,
              dtype=F64, **cfg):
    """(mesh, step, rho, q, measure) of a cell-integrated path: an
    IrTransport of `cfg`, or with `mixed` the mixed isl method (the density
    by IrTransport.remap_rho with `cfg`, the tracers by the ISL step with
    qlt/mn2 and that target density, as driver.run does). `measure`: the
    one the path conserves (IrTransport.F_mass; GLL for the mixed
    method's dmc f)."""
    from compose_tpu_torch.mesh import cubed_sphere
    from compose_tpu_torch.transport import gallery
    from compose_tpu_torch.transport.ir import IrConfig, IrTransport
    from compose_tpu_torch.transport.isl import IslConfig, IslTransport

    mesh = cubed_sphere.build(ne, np_, device=dev, mesh_type=mesh_type,
                              dtype=dtype)
    wind = gallery.create_wind("divergent")
    ir = IrTransport(mesh, wind, IrConfig(ne=mesh.ne, np_=mesh.np_, **cfg))
    if mixed:
        isl = IslTransport(mesh, wind, IslConfig(
            ne=mesh.ne, np_=mesh.np_, filter="qlt", limiter="mn2",
            rho_isl=False, nsub=cfg["nsub"], dmc="f"))

        def step(rho, q, ts, tf):
            return isl.step(rho, q, ts, tf,
                            rho_tgt=ir.remap_rho(rho, ts, tf))
        measure = "gll"
    else:
        step = ir.step
        measure = "gll" if ir.F_mass is mesh.dgbfi_gll else "sphere"
    return (mesh, step) + _state(mesh, nt) + (measure,)


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
    # The cell-integrated paths' configs (A: ir dmc f caas/caas, B: cdg dmc
    # es qlt/mn2, C: the mixed isl method) and a gllsubcell CDG dmc ef run
    # at ne3 (ne2 refined to ne6 np2), 4 tracers, 2 steps of one day, f64.
    for label, kw in IR_SMALL.items():
        res = {}
        for d in ("cpu", dev):
            _, step, rho, q, _ = _ir_model(d, nt=4, nsub=2, **kw)
            for s in range(2):
                rho, q = step(rho, q, s * 86400.0, (s + 1) * 86400.0)
            res[str(d)] = (rho.cpu(), q.cpu())
        (rc, qc), (rg, qg) = res["cpu"], res[str(dev)]
        err = max(float((rc - rg).abs().max()), float((qc - qg).abs().max()))
        log(f"small reference ({label}, 4 tracers, 2 steps, f64): max |card "
            f"- cpu| = {err:.3e} (tolerance 1e-12)")
        if not err <= 1e-12:
            raise AssertionError(f"card run disagrees with the CPU run: {err}")
    # Prefine 5 and 1 at ne3 with a fine np6 grid, the pg2 toy chemistry at
    # ne4 and a moving-vortices step at ne4; 4 tracers, steps of one day.
    for label, make, nsteps in (
            ("prefine 5 ne3 np6 caas/caas dmc eh",
             lambda d: _prefine_setup(d, 3, 6, 4, experiment=5, dmc="eh",
                                      nsub=2)[0], 2),
            ("prefine 1 ne3 np6 caas/caas dmc f",
             lambda d: _prefine_setup(d, 3, 6, 4, experiment=1, dmc="f",
                                      nsub=2)[0], 2),
            ("pg2 toy chemistry ne4 pisl caas/caas",
             lambda d: _pg_setup(d, 4, 4, nsub=2)[0], 2),
            ("moving vortices ne4 pisl none/none",
             lambda d: _vortex_setup(d, 4), 1)):
        res = {}
        for d in ("cpu", dev):
            _, step, rho, q, _ = make(d)
            for s in range(nsteps):
                rho, q = step(rho, q, s * 86400.0, (s + 1) * 86400.0)
            res[str(d)] = (rho.cpu(), q.cpu())
        (rc, qc), (rg, qg) = res["cpu"], res[str(dev)]
        err = max(float((rc - rg).abs().max()), float((qc - qg).abs().max()))
        log(f"small reference ({label}, {nsteps} steps, f64): max |card - "
            f"cpu| = {err:.3e} (tolerance 1e-12)")
        if not err <= 1e-12:
            raise AssertionError(f"card run disagrees with the CPU run: {err}")


def phase_small_reference_precision(dev):
    """The single- and mixed-precision routes, the card against the CPU:
    the single-precision route (x64 off) of paths A-C's configs at ne3, of
    prefine 5 at ne3 np6 and of the pg2 toy chemistry at ne4; and the two
    mixed geometry/interpolation precisions of the flagship at ne4, f64.
    4 tracers, 2 steps of one day. Every route with f32 arithmetic in it is
    held to 1e-5: torch's CUDA and CPU ops round f32 differently (the
    f32 interpolation sums 16 products in another order), and one f32 ulp
    of a weight is ~6e-8 of the result."""
    routes = [(f"{k.split()[0]}' {k[2:]}, f32", lambda d, kw=kw: _ir_model(
        d, nt=4, nsub=2, dtype=F32, **kw)) for k, kw in IR_SMALL.items()
        if not k.startswith("ne2")]
    routes += [
        ("prefine 5 ne3 np6 caas/caas dmc eh, f32",
         lambda d: _prefine_setup(d, 3, 6, 4, dtype=F32, experiment=5,
                                  dmc="eh", nsub=2)[0]),
        ("pg2 toy chemistry ne4 pisl caas/caas, f32",
         lambda d: _pg_setup(d, 4, 4, dtype=F32, nsub=2)[0])]
    for geom, interp in MIXED:
        routes.append((f"ne4 pisl caas/caas geom {geom} interp {interp}, f64",
                       lambda d, g=geom, i=interp: _model(
                           d, 4, 4, F64, filter="caas", limiter="caas",
                           nsub=2, geom_dtype=g, interp_dtype=i)
                       + ("gll",)))
    for label, make in routes:
        res = {}
        for d in ("cpu", dev):
            mesh, step, rho, q, _ = make(d)
            step = getattr(step, "step", step)
            for s in range(2):
                rho, q = step(rho, q, s * 86400.0, (s + 1) * 86400.0)
            res[str(d)] = (rho.cpu(), q.cpu())
        (rc, qc), (rg, qg) = res["cpu"], res[str(dev)]
        err = max(float((rc - rg).abs().max()), float((qc - qg).abs().max()))
        log(f"small reference ({label}, 4 tracers, 2 steps): max |card - "
            f"cpu| = {err:.3e} (tolerance 1e-5)")
        if not (err <= 1e-5 and bool(torch.isfinite(qg).all())):
            raise AssertionError(f"card run disagrees with the CPU run: {err}")


def _prefine_setup(dev, ne, np_, nt, dtype=F64, **cfg):
    """((mesh, step, rho, q, measure), model) of a p-refinement run with
    caas/caas: the fine grid at np_, the np4 v grid; the primary mesh is
    the v grid for experiment 5, the fine grid for 1. `step` carries the
    experiment's state."""
    from compose_tpu_torch.mesh import cubed_sphere
    from compose_tpu_torch.transport import gallery
    from compose_tpu_torch.transport.prefine import (PRefineConfig,
                                                     PRefineTransport)

    mesh_f = cubed_sphere.build(ne, np_, device=dev, dtype=dtype)
    model = PRefineTransport(mesh_f, gallery.create_wind("divergent"),
                             PRefineConfig(ne=ne, np_=np_, filter="caas",
                                           limiter="caas", **cfg))
    mesh = model.mesh_v if cfg["experiment"] == 5 else mesh_f
    state = [None]

    def step(rho, q, ts, tf):
        rho, q, state[0] = model.step(rho, q, ts, tf, state[0])
        return rho, q
    measure = "sphere" if cfg.get("dmc") == "es" else "gll"
    return (mesh, step) + _state(mesh, nt) + (measure,), model


def _pg_setup(dev, ne, nt, dtype=F64, **cfg):
    """((mesh, step, rho, q, "gll"), (pg ops, centers)) of the toy
    chemistry on the pg2 physics grid before each pisl caas/caas step, as
    driver.run(pg=2) couples them: tracers 0 and 1 are toychem1 and
    toychem2, the others the bench ICs tiled."""
    from compose_tpu_torch import driver
    from compose_tpu_torch.transport.physgrid import PhysgridOps

    mesh, model, rho, q = _model(dev, ne, nt - 2, dtype, filter="caas",
                                 limiter="caas", **cfg)
    q = torch.cat([driver.init_tracers(mesh, ["toychem1", "toychem2"]), q])
    pg_ops = PhysgridOps(mesh, 2, "elrecon")
    lat, lon = driver._pg_centers(mesh, 2)

    def step(rho, q, ts, tf):
        q = driver._toychem_on_pg(pg_ops, lat, lon, rho, q, (0, 1), tf - ts)
        return model.step(rho, q, ts, tf)
    return (mesh, step, rho, q, "gll"), (pg_ops, lat, lon)


def _vortex_setup(dev, ne):
    """(mesh, step, rho, q, "gll") of the moving vortices with the vortex
    tracer, pisl with filter and limiter none (test_moving_vortices.py's
    configuration)."""
    from compose_tpu_torch import driver
    from compose_tpu_torch.mesh import cubed_sphere
    from compose_tpu_torch.transport import gallery
    from compose_tpu_torch.transport.isl import IslConfig, IslTransport

    mesh = cubed_sphere.build(ne, 4, device=dev)
    model = IslTransport(mesh, gallery.create_wind("movingvortices"),
                         IslConfig(ne=ne, filter="none", limiter="none",
                                   nsub=8))
    rho = torch.ones((mesh.ncell, mesh.np2), dtype=F64, device=dev)
    return mesh, model.step, rho, driver.init_tracers(
        mesh, ["vortextracer"]), "gll"


# The cell-integrated paths (ne30 np4) and their small references (ne3).
IR_A = dict(method="ir", dmc="f", filter="caas", limiter="caas")
IR_B = dict(method="cdg", dmc="es", filter="qlt", limiter="mn2")
IR_C = dict(method="ir", dmc="eh", filter="none", limiter="none",
            mixed=True)
IR_SMALL = {
    "A ne3 ir dmc f caas/caas d2c": dict(IR_A, ne=3),
    "B ne3 cdg dmc es qlt/mn2 d2c": dict(IR_B, ne=3),
    "C ne3 mixed isl, remap_rho dmc eh, qlt/mn2": dict(IR_C, ne=3),
    "ne2 gllsubcell cdg dmc ef qlt/mn2 tq 4": dict(
        ne=2, mesh_type="gllsubcell", method="cdg", dmc="ef", filter="qlt",
        limiter="mn2", tq=4, d2c=False),
}


def run_path(dev, name, dtype, nsteps, want, mass_tol=1e-12,
             bounds_tol=5e-13, ne=30, nt=40, np_=4, measure="gll",
             setup=None, period=None, first_extra=None, dofs=None,
             observed=None, step_check=None, **cfg):
    """Drive one path (ne30 np4 unless told otherwise) with 40 tracers for
    `nsteps` steps of 1/`period` (default 1/nsteps) of a 12-day period
    through IslTransport.step, or through the step of `setup` (mesh, step,
    rho, q, measure; see _ir_model), with every launch count set to 0 just
    before and read just after. `want`: launches per step of each kernel
    (every other kernel must not launch), plus `first_extra` in the first
    step. The Observer checks mass in `measure` (gll, or sphere for dmc
    es) for rho and the tracers `observed` (default all), and
    `step_check(rho, q)` runs after every step. `dofs`: (tracer DOFs per
    step, what they count), by default the mesh's slots times the
    tracers. Returns the launch counts, the model (or step), the final
    state and the step length."""
    from compose_tpu_torch import _native, driver
    from compose_tpu_torch.diagnostics import Observer

    if setup is None:
        mesh, model, rho, q = _model(dev, ne, nt, dtype, np_=np_, **cfg)
        step = model.step
    else:
        mesh, step, rho, q, measure = setup
        model = step
    observed = observed or slice(None)
    q0, rho0 = q, rho
    obs = Observer(mesh.dgbfi_gll, mesh.dgbfi_sphere,
                   ["rho"] + [f"q{i}" for i in range(nt)][observed])
    obs.add_obs(0.0, rho, list(q[observed]))
    T = 86400.0 * 12
    period = period or nsteps
    dt = T / period

    for k in _native.KERNELS.values():
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    step_s, per_step = [], []
    for s in range(nsteps):
        before = {n: k.launches for n, k in _native.KERNELS.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rho, q = step(rho, q, s * dt, T if s + 1 == period else (s + 1) * dt)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        per_step.append({n: k.launches - before[n]
                         for n, k in _native.KERNELS.items()})
        obs.add_obs((s + 1) * dt, rho, list(q[observed]))
        if step_check is not None:
            step_check(rho, q)
    launches = {n: k.launches for n, k in _native.KERNELS.items()}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    first_extra = first_extra or {}
    expect = {n: want.get(n, 0) * nsteps + first_extra.get(n, 0)
              for n in _native.KERNELS}
    if launches != expect:
        raise AssertionError(f"{name}: launch counts {launches} != {expect}")
    if first_extra:
        log(f"{name}: launches in each step: " + "; ".join(
            " ".join(f"{n} {c[n]}" for n in want) for c in per_step))
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
    per_step = " ".join(f"{n} {per_step[-1][n]}" for n in want)
    ndof, what = dofs or (mesh.ncell * mesh.np2 * nt, "")
    log(f"{name}: ne{ne} np{np_} {nt} tracers, {nsteps} steps of {dt:g} s: "
        f"step {sec * 1e3:.3f} ms (median of steps 2..{nsteps}; first "
        f"{step_s[0] * 1e3:.1f} ms), {ndof / sec:.4e} tracer-DOF/s{what}; "
        f"l2 {out.l2_err:.4e} cv_gll {out.cv_gll:.3e} cv "
        f"{out.cv:.3e}; Observer mass ({measure}) {mass_err:.3e} bounds "
        f"{bounds_err:.3e} (bars "
        f"{mass_tol:g}, {bounds_tol:g}); launches/step {per_step}; peak "
        f"device memory {peak_gib:.3f} GiB")
    return launches, model, rho, q, dt


def _profile(label, step, rho, q, t0, dt, nsteps=3):
    """Device busy share and device launches per step over `nsteps` steps
    from t0, from torch.profiler: the summed time of the device's kernels
    and copies over the profiled wall time (the profiler's own host cost
    inside it)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        w0 = time.perf_counter()
        for s in range(nsteps):
            rho, q = step(rho, q, t0 + s * dt, t0 + (s + 1) * dt)
        torch.cuda.synchronize()
        wall = time.perf_counter() - w0
    dev_events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in dev_events)
    if not busy_us:
        log(f"{label} profile: the profiler saw no device time; busy share "
            f"not measured")
        return
    kernels = sum(e.count for e in dev_events
                  if not e.key.startswith(("Memcpy", "Memset")))
    log(f"{label} profile ({nsteps} steps): device busy {busy_us / 1e3:.3f} "
        f"ms of {wall * 1e3:.3f} ms wall, busy share "
        f"{busy_us / 1e6 / wall:.4f}; {kernels / nsteps:.1f} kernel "
        f"launches and {sum(e.count for e in dev_events) / nsteps:.1f} "
        f"device ops per step")


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
    launches, model, rho, q, _ = run_path(
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
    _, model, rho, q, _ = run_path(
        dev, "pisl caas-node/caas dmc es (f64)", F64, 12,
        {"limit_caas_f64": 1, "dss_q_f64": 2}, measure="sphere",
        filter="caas-node", limiter="caas", dmc="es", nsub=8)
    _log_phases("caas-node/caas dmc es", model, rho, q)
    _, model, rho, q, _ = run_path(
        dev, "pisl caas/caas np8 interp dmc eh (f64)", F64, 12,
        {"glbl_caas_f64": 2, "limit_caas_f64": 1, "dss_q_f64": 2},
        ne=15, np_=8, filter="caas", limiter="caas", dmc="eh",
        timeint="interp", nsub=8)
    _log_phases("np8 interp caas/caas", model, rho, q)
    return counts


def phase_ir_paths(dev):
    """The cell-integrated paths at ne30 np4, 40 tracers, nsub 8, f64, 12
    steps of 1/120 of the period; each then profiled over 3 more steps.
    Path A runs twice, and its two runs must be bitwise equal. Returns each
    kernel's launch count from path A's first run."""
    def run(label, cfg, want):
        return run_path(dev, f"path {label}", F64, 12, want, period=120,
                        setup=_ir_model(dev, 30, 40, nsub=8, **cfg))

    label = "A: ir dmc f caas/caas d2c"
    want = {"glbl_caas_f64": 1, "limit_caas_f64": 1, "dss_q_f64": 2}
    counts, _, rho1, q1, _ = run(label, IR_A, want)
    _, step, rho, q, dt = run(label, IR_A, want)
    if not (torch.equal(rho1, rho) and torch.equal(q1, q)):
        raise AssertionError("path A: two runs differ")
    log("path A: two runs bitwise equal")
    _profile(f"path {label}", step, rho, q, 12 * dt, dt)
    for label, cfg in (("B: cdg dmc es qlt/mn2 d2c", IR_B),
                       ("C: mixed isl (remap_rho dmc eh, ISL qlt/mn2)",
                        IR_C)):
        _, step, rho, q, dt = run(label, cfg, {"dss_q_f64": 2})
        _profile(f"path {label}", step, rho, q, 12 * dt, dt)
    return counts


def phase_prefine_pg(dev):
    """The p-refinement and physics-grid paths at ne30, 40 tracers, nsub
    8, f64, 12 steps of 1/120 of the period, each then profiled over 3
    more steps. Returns each kernel's launch count from P5 and from PG."""
    # P5: prefine 5, fine np8 GllNodal under the np4 v grid, caas/caas,
    # dmc eh: the v-grid GLL mass is conserved. K1 on the v-grid rho
    # (1, 5400) and the fine tracers (40, 5400), K3 on the v-grid rho DSS
    # (1, 86400), K2 in the fine limiter (40, 5400 x 64) and the t -> v
    # transfer (40, 5400 x 16); the first step's v -> t transfer is one
    # more K2 launch at np2 64.
    setup, model = _prefine_setup(dev, 30, 8, 40, experiment=5, dmc="eh",
                                  nsub=8)
    mf = model.mesh_f
    label = "P5: prefine 5 ne30 np8/np4 caas/caas dmc eh"
    p5, step, rho, q, dt = run_path(
        dev, f"path {label}", F64, 12,
        {"glbl_caas_f64": 2, "limit_caas_f64": 2, "dss_q_f64": 1},
        period=120, setup=setup, first_extra={"limit_caas_f64": 1},
        dofs=(mf.ncell * mf.np2 * 40, " (the fine np8 grid's DOFs)"))
    _profile(f"path {label}", step, rho, q, 12 * dt, dt)

    # PG: ne30pg2, the toy chemistry on the physics grid before each pisl
    # caas/caas step (K1, K2, K3 as the flagship); tracers 0-1 held to the
    # toy chemistry's range, the 38 others to mass and bounds.
    setup, (pg_ops, lat, lon) = _pg_setup(dev, 30, 40, nsub=8)

    def toychem_range(rho, q):
        lo, hi = float(q[:2].amin()), float(q[:2].amax())
        if not (lo >= 0.0 and hi <= 4.0000001e-6):
            raise AssertionError(f"PG: toy chemistry left [0, 4e-6]: "
                                 f"[{lo}, {hi}]")

    label = "PG: ne30pg2 toy chemistry, pisl caas/caas"
    pg, step, rho, q, dt = run_path(
        dev, f"path {label}", F64, 12,
        {"glbl_caas_f64": 2, "limit_caas_f64": 1, "dss_q_f64": 2},
        period=120, setup=setup, observed=slice(2, None),
        step_check=toychem_range)
    from compose_tpu_torch import driver

    def coupling():
        return driver._toychem_on_pg(pg_ops, lat, lon, rho, q, (0, 1), dt)
    rho_p, q_p = pg_ops.gll2fv(rho, q)
    log(f"path PG physics grid (ms, CUDA events, median of 25): gll2fv "
        f"{cuda_ms(lambda: pg_ops.gll2fv(rho, q)):.3f}, fv2gll "
        f"{cuda_ms(lambda: pg_ops.fv2gll(rho_p, q_p)):.3f}; the toy "
        f"chemistry's coupling per step (gll2fv, tendency, fv2gll's "
        f"operator, clip) {cuda_ms(coupling):.3f}")
    _profile(f"path {label}", step, rho, q, 12 * dt, dt)
    return p5, pg


# The two mixed geometry/interpolation precisions at x64 on.
MIXED = (("f64", "f32"), ("f32", "f64"))


def phase_precision_paths(dev):
    """The single-precision route (x64 off) of paths A-C, P5 and PG at
    ne30, 40 tracers, nsub 8, 12 steps of 1/120 of the period (A' run
    twice, bitwise), and the flagship's two mixed-precision variants at x64
    on for 12 steps; each profiled over 3 more steps. f32 paths: mass held
    to 1e-5 and bounds to 1e-6 (in f64, Observer). Returns {path: launch
    counts}."""
    out = {}
    f32 = dict(mass_tol=1e-5, bounds_tol=1e-6)

    def ir(label, cfg, want, runs=1):
        res = [run_path(dev, f"path {label}", F32, 12, want, period=120,
                        setup=_ir_model(dev, 30, 40, nsub=8, dtype=F32,
                                        **cfg), **f32) for _ in range(runs)]
        counts, step, rho, q, dt = res[-1]
        if runs == 2:
            if not (torch.equal(res[0][2], rho) and torch.equal(res[0][3], q)):
                raise AssertionError(f"path {label}: two runs differ")
            log(f"path {label}: two runs bitwise equal")
        _profile(f"path {label}", step, rho, q, 12 * dt, dt)
        out[label.split(":")[0]] = res[0][0]

    ir("A': ir dmc f caas/caas d2c, f32", IR_A,
       {"glbl_caas_f32": 1, "limit_caas_f32": 1, "dss_q_f32": 2}, runs=2)
    ir("B': cdg dmc es qlt/mn2 d2c, f32", IR_B, {"dss_q_f32": 2})
    ir("C': mixed isl (remap_rho dmc eh, ISL qlt/mn2), f32", IR_C,
       {"dss_q_f32": 2})

    setup, model = _prefine_setup(dev, 30, 8, 40, dtype=F32, experiment=5,
                                  dmc="eh", nsub=8)
    mf = model.mesh_f
    label = "P5': prefine 5 ne30 np8/np4 caas/caas dmc eh, f32"
    out["P5'"], step, rho, q, dt = run_path(
        dev, f"path {label}", F32, 12,
        {"glbl_caas_f32": 2, "limit_caas_f32": 2, "dss_q_f32": 1},
        period=120, setup=setup, first_extra={"limit_caas_f32": 1},
        dofs=(mf.ncell * mf.np2 * 40, " (the fine np8 grid's DOFs)"), **f32)
    _profile(f"path {label}", step, rho, q, 12 * dt, dt)

    setup, _ = _pg_setup(dev, 30, 40, dtype=F32, nsub=8)

    def toychem_range(rho, q):
        # f32 rounds the toy chemistry's cancellations (det - r, 4e-6 -
        # toychem1) at one ulp of r = k1/4 <= 0.25: 2.98e-8.
        lo, hi = float(q[:2].amin()), float(q[:2].amax())
        if not (lo >= -2.98e-8 and hi <= 4e-6 + 2.98e-8):
            raise AssertionError(f"PG': toy chemistry left [0, 4e-6]: "
                                 f"[{lo}, {hi}]")

    label = "PG': ne30pg2 toy chemistry, pisl caas/caas, f32"
    out["PG'"], step, rho, q, dt = run_path(
        dev, f"path {label}", F32, 12,
        {"glbl_caas_f32": 2, "limit_caas_f32": 1, "dss_q_f32": 2},
        period=120, setup=setup, observed=slice(2, None),
        step_check=toychem_range, **f32)
    _profile(f"path {label}", step, rho, q, 12 * dt, dt)

    for geom, interp in MIXED:
        label = f"flagship pisl caas/caas geom {geom} interp {interp}"
        counts, model, rho, q, dt = run_path(
            dev, label, F64, 12,
            {"glbl_caas_f64": 2, "limit_caas_f64": 1, "dss_q_f64": 2},
            period=120, filter="caas", limiter="caas", nsub=8,
            geom_dtype=geom, interp_dtype=interp)
        _profile(label, model.step, rho, q, 12 * dt, dt)
        out[f"geom{geom}-interp{interp}"] = counts
    return out


def phase_cli(dev):
    """The command line through a subprocess on the card, its outputs read
    back (the -rit series, the NetCDF fields, the raster), and a
    checkpoint resume that continues bitwise like an uninterrupted run."""
    import os
    from scipy.io import netcdf_file

    from compose_tpu_torch import checkpoint

    root = os.path.dirname(os.path.abspath(__file__))
    out_dir = os.path.join(root, "build", "cli")
    os.makedirs(out_dir, exist_ok=True)

    def cli(args, env=None):
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "compose_tpu_torch.driver"] + args,
            cwd=root, capture_output=True, text=True, timeout=600,
            env=dict(os.environ, **(env or {})))
        if res.returncode != 0:
            raise AssertionError(f"CLI {' '.join(args)} failed:\n"
                                 f"{res.stderr[-3000:]}")
        lines = res.stdout.splitlines()
        if not lines or not lines[-1].startswith("<OL>"):
            raise AssertionError(f"CLI printed no <OL> line: {lines[-3:]}")
        log(f"CLI ({time.perf_counter() - t0:.1f} s): {lines[-1]}")
        return lines

    prefix, rit = os.path.join(out_dir, "run"), os.path.join(out_dir,
                                                             "rit.json")
    lines = cli(["-ne", "4", "-nsteps", "2", "-nsub", "2", "-mono", "caas",
                 "-lim", "caas", "-ic", "gaussianhills", "-ic",
                 "cosinebells", "-ic", "correlatedcosinebells", "-rit", rit,
                 "-lauritzen", "-midpoint-check", "-footprint", "-timers",
                 "-io-type", "netcdf", "-o", prefix])
    for tag, n in (("footprint> ", 2), ("> mp tracer ", 3),
                   ("T full step", 1), ("L    l_r ", 1), ("L    fil ", 1)):
        if len([x for x in lines if x.startswith(tag)]) != n:
            raise AssertionError(f"CLI: expected {n} '{tag}' lines")
    with open(rit) as f:
        series = json.load(f)
    masses = np.asarray([fs["mass_gll"] for fs in series["fields"].values()])
    if not (len(series["times"]) == 3 and np.all(np.isfinite(masses))
            and np.all(np.abs(np.diff(masses[1:], axis=1))
                       <= 1e-12 * np.abs(masses[1:, 1:]))):
        raise AssertionError("CLI: the -rit series")
    r = netcdf_file(prefix + ".nc", "r", mmap=False)
    nc = {k: np.array(v[:]) for k, v in r.variables.items()}
    r.close()
    cnn = 6 * 16 * 9 + 2
    if not (nc["time"].tolist() == [0.0, 6 * 86400.0, 12 * 86400.0]
            and nc["density"].shape == (3, cnn)
            and all(np.all(np.isfinite(nc[k])) for k in nc)
            and np.all(nc["tracer_cosinebells1"] >= 0.1 - 1e-12)):
        raise AssertionError("CLI: the NetCDF file")
    log(f"CLI NetCDF read back: variables {sorted(nc)}, (time, node) = "
        f"{nc['density'].shape}; -rit: {len(series['fields'])} fields, "
        f"tracer masses constant to 1e-12")
    ras = os.path.join(out_dir, "ras")
    cli(["-ne", "4", "-nsteps", "2", "-nsub", "2", "-method", "ir", "-dmc",
         "f", "-mono", "caas", "-lim", "caas", "-io-type", "internal",
         "-res", "16", "-o", ras], env={"COMPOSE_TPU_X64": "0"})
    with open(ras + ".bin", "rb") as f:
        hdr = np.fromfile(f, np.int32, 3)
        frames = np.fromfile(f, np.float32)
    if not (hdr.tolist() == [6, 16, 32] and frames.size == 6 * 16 * 32
            and np.all(np.isfinite(frames))):
        raise AssertionError("CLI: the raster file")
    log(f"CLI raster read back (x64 off, ir): header {hdr.tolist()}, "
        f"density in [{frames[:512].min():.4f}, {frames[:512].max():.4f}]")

    # Checkpoint resume on the card: 2 steps straight, against 1 step,
    # save, restore onto the card, 1 step.
    _, model, rho, q = _model(dev, 30, 40, F64, filter="caas",
                              limiter="caas", nsub=8)
    dt = 86400.0 * 12 / 120
    r1, q1 = model.step(rho, q, 0.0, dt)
    r2, q2 = model.step(r1, q1, dt, 2 * dt)
    path = os.path.join(out_dir, "ckpt")
    checkpoint.save(path, 1, dt, r1, q1, meta={"ne": 30})
    step, t, rr, qq, meta = checkpoint.restore(path)
    if not (rr.is_cuda and step == 1 and meta["ne"] == 30):
        raise AssertionError("checkpoint: restored state")
    r2b, q2b = model.step(rr, qq, t, 2 * dt)
    if not (torch.equal(r2, r2b) and torch.equal(q2, q2b)):
        raise AssertionError("checkpoint: the resumed run differs")
    log("checkpoint resume (ne30, 40 tracers, caas/caas f64, on the card): "
        "bitwise equal to the uninterrupted run")


def _log_phases(label, model, rho, q):
    """Where one step's time goes: IslTransport.phase_times, each phase
    run alone 5 times (so the phases need not add up to the step)."""
    pt = model.phase_times(rho, q, 0.0, 8640.0, iters=5)
    log(f"{label} phases (ms): " + ", ".join(
        f"{k} {v * 1e3:.3f}" for k, v in pt.items()))


def row_ok(out, bars):
    """A golden row's asserts: l2 <= bar, and > 0 unless "pos" is False;
    cv / cv_gll (conservation in the sphere / GLL measure), min and max
    (each within "slack") where the row bounds them; with "step", the
    per-step invariants (mass < 1e-12, bounds < 5e-13)."""
    ok = out.l2_err <= bars["l2"] and (out.l2_err > 0
                                       or not bars.get("pos", True))
    for k in ("cv", "cv_gll"):
        if k in bars:
            ok = ok and getattr(out, k) <= bars[k]
    slack = bars.get("slack", 0.0)
    if "min" in bars:
        ok = ok and out.min_e >= bars["min"] - slack
    if "max" in bars:
        ok = ok and out.max_e <= bars["max"] + slack
    if bars.get("step"):
        ok = (ok and out.max_step_mass_err < 1e-12
              and out.max_step_bounds_err < 5e-13)
    return ok


SC, GH = ("slottedcylinders",), ("gaussianhills",)
ICS3 = ("slottedcylinders", "cosinebells", "gaussianhills")
ICS5 = ("gaussianhills", "slottedcylinders", "cosinebells",
        "correlatedcosinebells", "xyztrig")


def _bat(l2, **bars):
    # tests/test_regression_battery.py:_run_row: l2 may be 0 (its bars are
    # all >= 1e-6), min and max within 5e-13.
    return dict(bars, l2=l2, pos=False, slack=5e-13)


_IR = dict(method="ir", filter_="none", limiter="none", d2c=False)
_QLT = dict(filter_="qlt", limiter="mn2", d2c=False)
_SUB = dict(ne=5, tq=4, method="cdg", dmc="ef", **_QLT)
_B01 = dict(min=0.1, max=1.0)
_BGH = dict(min=1.495e-8, max=0.956)
# The golden rows of the cell-integrated methods, the subcell meshes and
# the mixed isl method: name -> (driver.run arguments over np 4 and 12
# steps, bars), each as tests/test_regression_battery.py (rows ir_np3
# through perturb_div, and isl_caas, isl_mn2, isl_np3_qlt) or
# tests/test_transport_e2e.py (test_golden_*) holds the JAX package. The
# battery's -rit rows (cdg96_qlt_ef, ir96_qlt_ef, ir96_np2_ne15) run
# without the observer output, which only exercises the writer.
IR_GOLDEN = {
    "isl_caas": (dict(ne=10, ics=ICS3, method="isl", filter_="caas",
                      limiter="mn2"), _bat(3.47e-1, cv_gll=5e-14, **_B01)),
    "isl_mn2": (dict(ne=10, ics=ICS3, method="isl", filter_="mn2",
                     limiter="mn2"), _bat(3.47e-1, cv_gll=5e-14, **_B01)),
    "isl_np3_qlt": (dict(ne=10, np_=3, ics=GH, method="isl", filter_="qlt",
                         limiter="mn2"), _bat(9.05e-2, cv_gll=2e-14)),
    "ir_np3": (dict(_IR, ne=10, np_=3, ics=GH), _bat(2.43e-2, cv=1e-14)),
    "ir_np3_qlt": (dict(_QLT, ne=10, np_=3, ics=GH, method="ir"),
                   _bat(3.18e-2, cv=4e-15, min=1.495e-08, max=9.518e-01)),
    "ir_np3_caas": (dict(_QLT, ne=10, np_=3, ics=GH, method="ir",
                         filter_="caas"),
                    _bat(3.18e-2, cv=4e-15, min=1.495e-08, max=9.518e-01)),
    "ir_np3_mn2": (dict(_QLT, ne=10, np_=3, ics=GH, method="ir",
                        filter_="mn2"),
                   _bat(3.18e-2, cv=4e-15, min=1.495e-08, max=9.518e-01)),
    "ir_np3_d2c": (dict(_IR, ne=10, np_=3, ics=GH, d2c=True),
                   _bat(3.64e-2, cv=3e-15)),
    "cdg_np4_d2c": (dict(_IR, ne=10, ics=GH, method="cdg", d2c=True),
                    _bat(1.02e-2, cv=3.5e-15)),
    "ir_qlt_limcaas": (dict(_QLT, ne=10, ics=SC, method="ir",
                            limiter="caas"),
                       _bat(3.0e-1, cv=3e-14, **_B01)),
    "cdg_qlt": (dict(_QLT, ne=10, ics=SC, method="cdg"),
                _bat(3.03e-1, cv=3e-14, **_B01)),
    "ir_ccb2": (dict(_IR, ne=10, ics=("gaussianhills",
                                      "correlatedcosinebells")),
                _bat(1.02e-2, cv=2e-7)),
    "ir_dmc_es": (dict(_IR, ne=10, ics=GH, dmc="es"), _bat(9.1e-3, cv=2e-13)),
    "cdg_dmc_es": (dict(_IR, ne=10, ics=GH, method="cdg", dmc="es"),
                   _bat(9.1e-3, cv=2e-13)),
    "ir_dmc_eh": (dict(_IR, ne=10, ics=GH, dmc="eh"),
                  _bat(9.1e-3, cv_gll=5e-15)),
    "ir_dmc_geh": (dict(_IR, ne=10, ics=GH, dmc="geh"),
                   _bat(9.1e-3, cv_gll=2e-14)),
    "ir_qlt_dmc_es": (dict(_QLT, ne=10, ics=SC, method="ir", dmc="es"),
                      _bat(3.1e-1, cv=2.3e-13, **_B01)),
    "ir_qlt_dmc_eh": (dict(_QLT, ne=10, ics=SC, method="ir", dmc="eh"),
                      _bat(3.0e-1, cv_gll=5e-14, **_B01)),
    "ir_dmc_f": (dict(_IR, ne=10, ics=GH, method="cdg", dmc="f"),
                 _bat(1.42e-2, cv_gll=6e-14)),
    "ir_dmc_f_np2_ne30": (dict(_IR, ne=30, np_=2, ics=GH, method="cdg",
                               dmc="f"), _bat(6.49e-2, cv_gll=1.4e-13)),
    "cdg96_qlt_f": (dict(_QLT, ne=5, nsteps=96, ics=SC, method="cdg",
                         dmc="f"), _bat(4.6e-1, cv_gll=4e-14, **_B01)),
    "cdg96_qlt_f_caas": (dict(_QLT, ne=5, nsteps=96, ics=SC, method="cdg",
                              dmc="f", limiter="caas"),
                         _bat(4.6e-1, cv_gll=4e-14, **_B01)),
    "cdg96_qlt_f_caags": (dict(_QLT, ne=5, nsteps=96, ics=SC, method="cdg",
                               dmc="f", limiter="caags"),
                          _bat(4.6e-1, cv_gll=4e-14, **_B01)),
    "ir96_qlt_f": (dict(_QLT, ne=5, nsteps=96, ics=SC, method="ir",
                        dmc="f"), _bat(4.6e-1, cv_gll=4e-14, **_B01)),
    "cdg96_qlt_ef": (dict(_QLT, ne=5, nsteps=96, ics=SC, method="cdg",
                          dmc="ef"), _bat(4.6e-1, cv_gll=2e-14, **_B01)),
    "ir96_qlt_ef": (dict(_QLT, ne=5, nsteps=96, ics=SC, method="ir",
                         dmc="ef"), _bat(4.6e-1, cv_gll=2e-14, **_B01)),
    "ir96_np2_ne15": (dict(_QLT, ne=15, np_=2, nsteps=96, ics=SC,
                           method="cdg", dmc="ef"),
                      _bat(4.5e-1, cv_gll=2.2e-14, **_B01)),
    "ir_qlt_2ics": (dict(_QLT, ne=10, ics=("gaussianhills",
                                           "slottedcylinders"),
                         method="ir", dmc="f"),
                    _bat(1.5e-2, cv_gll=8e-14, min=0.0, max=0.957)),
    "sub96_gll": (dict(_SUB, nsteps=96, ics=SC, mesh_type="gllsubcell"),
                  _bat(4.6e-1, cv_gll=2e-14, **_B01)),
    "sub96_runi": (dict(_SUB, nsteps=96, ics=SC, mesh_type="runisubcell"),
                   _bat(4.5e-1, cv_gll=2e-14, **_B01)),
    "sub12_gll": (dict(_SUB, ics=GH, mesh_type="gllsubcell"),
                  _bat(7.40e-2, cv_gll=9e-15, min=0.0, max=0.96)),
    "sub12_runi": (dict(_SUB, ics=GH, mesh_type="runisubcell"),
                   _bat(5.41e-2, cv_gll=5e-15, min=0.0, max=0.96)),
    "sub_np10_ne2": (dict(_SUB, ne=2, np_=10, ics=GH,
                          mesh_type="runisubcell"),
                     _bat(3.5e-2, cv_gll=3e-15, min=0.0, max=0.96)),
    "cmbc_f": (dict(_QLT, ne=10, ics=ICS5, method="cdg", dmc="f"),
               _bat(1.45e-2, cv_gll=6e-14, **_BGH)),
    "cmbc_es": (dict(_QLT, ne=10, ics=ICS5, method="ir", dmc="es"),
                _bat(9.18e-3, cv=2e-13, **_BGH)),
    "cmbc_eh": (dict(_QLT, ne=10, ics=ICS5, method="ir", dmc="eh"),
                _bat(9.18e-3, cv_gll=1e-14, **_BGH)),
    "perturb_nondiv": (dict(_QLT, ne=10, ics=("constant",),
                            ode="nondivergent", method="cdg", dmc="ef",
                            perturb_rho=0.05),
                       _bat(1e-6, cv_gll=5e-14, min=0.42 - 1e-6,
                            max=0.42 + 1e-6)),
    "perturb_div": (dict(_QLT, ne=10, ics=("constant",), method="cdg",
                         dmc="ef", perturb_rho=0.05),
                    _bat(1e-6, cv_gll=5e-14, min=0.42 - 1e-6,
                         max=0.42 + 1e-6)),
    "test_golden_ir_ne10": (dict(ne=10, ics=GH, method="ir", filter_="none",
                                 limiter="none"), dict(l2=1.02e-2, cv=8e-15)),
    "test_golden_ir_qlt_slotted": (
        dict(ne=10, ics=SC, method="ir", filter_="qlt", limiter="mn2"),
        dict(l2=3.0e-1, cv=3e-14, slack=5e-13, **_B01)),
    "test_golden_isl_qlt_ne10": (
        dict(ne=10, ics=ICS3, method="isl", filter_="qlt", limiter="mn2"),
        dict(l2=3.47e-1, cv_gll=5e-14, step=True, **_B01)),
    "test_golden_tracer_consistency": (
        dict(ne=10, ics=("constant",), method="isl", filter_="qlt",
             limiter="mn2"),
        dict(l2=3e-15, pos=False, cv_gll=1e-13, min=0.42, max=0.42)),
}


_P5 = dict(ne=6, np_=8, nsteps=13, ics=GH, timeint="interp", prefine=5)
_CN = dict(filter_="caas-node", limiter="caas")
_CC = dict(filter_="caas", limiter="caas")
_OFF = dict(basis="GllOffsetNodal")
# The regression battery's ten prefine-5 rows (ne6, fine np8, 13 steps)
# and the other golden runs of this slice: name -> (driver.run arguments,
# bars), as tests/test_regression_battery.py and tests/test_transport_e2e.py
# hold the JAX package.
PREF_GOLDEN = {
    "pref5_es_caas": (dict(_P5, dmc="es", **_CC), _bat(5.885e-3, cv=4e-14)),
    "pref5_eh_caas": (dict(_P5, dmc="eh", **_CC),
                      _bat(5.886e-3, cv_gll=2e-14)),
    "pref5_es_caasnode": (dict(_P5, dmc="es", **_CN),
                          _bat(5.885e-3, cv=4e-14)),
    "pref5_eh_caasnode": (dict(_P5, dmc="eh", **_CN),
                          _bat(5.886e-3, cv_gll=2e-14)),
    "pref5_none": (dict(_P5, dmc="es", filter_="none", limiter="none"),
                   _bat(4.2e-3)),
    "pref5_rotated": (dict(_P5, dmc="eh", rotate_grid=True, **_CN),
                      _bat(5.886e-3, cv_gll=2e-14)),
    "pref5_es_offset": (dict(_P5, dmc="es", **_CC, **_OFF),
                        _bat(5.885e-3, cv=4e-14)),
    "pref5_eh_offset": (dict(_P5, dmc="eh", **_CC, **_OFF),
                        _bat(5.886e-3, cv_gll=2e-14)),
    "pref5_es_cn_offset": (dict(_P5, dmc="es", **_CN, **_OFF),
                           _bat(5.885e-3, cv=4e-14)),
    "pref5_eh_cn_offset": (dict(_P5, dmc="eh", **_CN, **_OFF),
                           _bat(5.886e-3, cv_gll=2e-14)),
    "test_prefine_experiments[5]": (
        dict(ne=3, np_=6, nsteps=3, ics=GH, prefine=5, **_CC),
        dict(l2=0.2, cv_gll=5e-14, step=True)),
    "test_prefine_experiments[1]": (
        dict(ne=3, np_=6, nsteps=3, ics=GH, prefine=1, **_CC),
        dict(l2=0.2, cv_gll=5e-14, step=True)),
    "test_physgrid_coupled_toychem": (
        dict(ne=4, nsteps=3, ics=("toychem1", "toychem2"), nsub=2, pg=2,
             **_CC),
        dict(l2=float("inf"), pos=False, min=0.0, max=4.0000001e-6)),
}


def golden_moving_vortices(dev):
    """tests/test_moving_vortices.py: ne10 np4, 12 steps, the vortex
    tracer against its analytic field at the end, l2 < 5e-2."""
    from compose_tpu_torch.ops import sphere
    from compose_tpu_torch.transport import gallery

    t0 = time.perf_counter()
    mesh, step, rho, q, _ = _vortex_setup(dev, 10)
    T = 86400.0 * 12
    for s in range(12):
        rho, q = step(rho, q, s * T / 12, (s + 1) * T / 12)
    lat, lon = sphere.xyz2ll(mesh.cell_nodes_xyz.reshape(-1, 3))
    exact = gallery.MovingVortices.calc_tracer(T, lat, lon)
    w = mesh.dgbfi_sphere.reshape(-1)
    e = q[0].reshape(-1) - exact
    l2 = float(torch.sqrt(torch.sum(w * e * e) / torch.sum(w * exact ** 2)))
    log(f"golden test_moving_vortices_analytic (ne10 np4, 12 steps, "
        f"{time.perf_counter() - t0:.1f} s): l2 against the analytic field "
        f"{l2:.4e} (bar 5e-2)")
    if not l2 < 5e-2:
        raise AssertionError("golden row test_moving_vortices_analytic failed")


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
    rows += tuple((name, bars, kw) for name, (kw, bars) in
                  list(IR_GOLDEN.items()) + list(PREF_GOLDEN.items()))
    for name, bars, kw in rows:
        kw = dict(dict(np_=4, nsteps=12), **kw)
        t0 = time.perf_counter()
        out = driver.run(verbose=False, device=dev, **kw)
        sec = time.perf_counter() - t0
        shown = ", ".join(f"{k} {bars[k]:g}" for k in ("l2", "cv", "cv_gll",
                                                        "min", "max")
                          if k in bars)
        log(f"golden {name} (ne{kw['ne']} np{kw['np_']}, {kw['nsteps']} "
            f"steps, {sec:.1f} s): l2 {out.l2_err:.4e} cv_gll {out.cv_gll:.3e} cv "
            f"{out.cv:.3e} min {out.min_e:.5g} max {out.max_e:.5g} "
            f"step-mass {out.max_step_mass_err:.3e} step-bounds "
            f"{out.max_step_bounds_err:.3e} (bars: {shown})")
        if not row_ok(out, bars):
            raise AssertionError(f"golden row {name} failed")
    golden_moving_vortices(dev)


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
    phase_small_reference_precision(dev)
    launches = phase_paths(dev)
    ir_launches = phase_ir_paths(dev)
    p5_launches, pg_launches = phase_prefine_pg(dev)
    prec_launches = phase_precision_paths(dev)
    phase_cli(dev)
    phase_golden(dev)

    keys = ("max_abs_err", "ms", "call_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "shapes")
    print(json.dumps({"kernels": [
        dict(name=n, route="cuda", source=src, replaces=rep,
             launches=launches[n], launches_ir_a=ir_launches[n],
             launches_p5=p5_launches[n], launches_pg=pg_launches[n],
             launches_precision={p: c[n] for p, c in prec_launches.items()},
             **{k: stats[n][k] for k in keys})
        for n, (src, rep) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
