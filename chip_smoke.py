"""GPU smoke run of the PyTorch + CUDA port (compose_tpu_torch) on one card.

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is nonzero):
  0. device: CUDA is required; print the card's name and power limit;
  1. build the CUDA kernels (nvcc, sm_90a) from compose_tpu_torch/csrc;
  2. each kernel against its plain PyTorch version on the card, at the
     flagship shapes, with seeded inputs that include infeasible cells and
     zero-density nodes: bitwise equality, exact bounds, median times;
  3. the flagship ISL step (ne30, np4, 40 tracers, pisl CAAS/CAAS, f32
     geometry and interpolation, nsub=8, divergent wind) for one 12-day
     period of 120 steps through IslTransport.step, with the Observer
     invariants and the per-step launch counts asserted; plus a small f64
     run on the card held against the same run on the CPU;
  4. the golden battery row isl_caas_flagship_f32 through driver.run.
The last two lines are the kernels' JSON summary and the device JSON.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

K1_SRC = "compose_tpu_torch/csrc/glbl_caas.cu"
K2_SRC = "compose_tpu_torch/csrc/limit_caas.cu"
K3_SRC = "compose_tpu_torch/csrc/dss_q.cu"


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps=25):
    """Median time of fn() in ms over `reps` runs, from CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def same(a, b, what):
    if not torch.equal(a, b):
        err = float((a - b).abs().max())
        raise AssertionError(f"{what}: kernel != plain (max |diff| {err})")


def phase_kernels(dev, stats, ne=30):
    from compose_tpu_torch.mesh import cubed_sphere
    from compose_tpu_torch.transport import cdr_fused, dss

    rng = np.random.default_rng(20261016)
    f64 = dict(dtype=torch.float64, device=dev)
    mesh = cubed_sphere.build(ne, 4, device=dev)
    ncell, np2, nt = mesh.ncell, mesh.np2, 40

    # K1: per-cell records; infeasible cells (mass outside [min, max]).
    def k1_inputs(rows):
        mn = rng.uniform(0.0, 1.0, (rows, ncell))
        mx = mn + rng.uniform(0.0, 1.0, (rows, ncell))
        ms = rng.uniform(-0.5, 2.5, (rows, ncell))   # ~1/3 out of bounds
        # Feasible targets: the total lands between sum(min) and sum(max).
        tgt = mn.sum(1) + rng.uniform(0.2, 0.8, rows) * (mx - mn).sum(1)
        return [torch.tensor(x, **f64) for x in (mn, ms, mx, tgt - ms.sum(1))]

    k1_err = 0.0
    for rows in (1, nt):
        mn, ms, mx, ex = k1_inputs(rows)
        out = cdr_fused.glbl_caas(mn, ms, mx, ex)
        ref = cdr_fused.glbl_caas_plain(mn, ms, mx, ex)
        torch.cuda.synchronize()
        same(out, ref, f"K1 glbl_caas ({rows}, {ncell})")
        # (m / sum v) * v rounds, so the feasible bounds hold to roundoff
        # (an ulp or two), not exactly: held to 1e2 eps of the bound.
        tol = 1e2 * torch.finfo(torch.float64).eps
        if not (bool((out >= mn - tol * mn.abs()).all())
                and bool((out <= mx + tol * mx.abs()).all())):
            raise AssertionError("K1: feasible problem left its bounds")
        k1_err = max(k1_err, float((out - ref).abs().max()))
    stats["glbl_caas"] = dict(
        max_abs_err=k1_err,
        ms=cuda_ms(lambda: cdr_fused.glbl_caas(mn, ms, mx, ex)),
        plain_ms=cuda_ms(lambda: cdr_fused.glbl_caas_plain(mn, ms, mx, ex)))
    log(f"K1 glbl_caas (1|{nt}, {ncell}): bitwise == plain, bounds held "
        f"to 1e2 eps; "
        f"{stats['glbl_caas']['ms']:.4f} ms vs plain "
        f"{stats['glbl_caas']['plain_ms']:.4f} ms")

    # K2: zero-density nodes and infeasible cells (targets outside the
    # cell's [sum a qmin, sum a qmax]) included.
    rho = rng.uniform(0.5, 1.5, (ncell, np2))
    rho[rng.random((ncell, np2)) < 0.02] = 0.0
    F = mesh.dgbfi_gll.cpu().numpy()
    qmin = rng.uniform(0.0, 0.5, (nt, ncell, np2))
    qmax = qmin + rng.uniform(0.0, 0.5, (nt, ncell, np2))
    Q = rng.uniform(-0.2, 1.2, (nt, ncell, np2)) * rho
    rhom = F * rho
    b = (rhom * rng.uniform(-0.1, 1.1, (nt, ncell, np2))).sum(-1)
    args = [torch.tensor(x, **f64) for x in (rhom, rho, Q, qmin, qmax, b)]
    out = cdr_fused.limit_caas(*args)
    ref = cdr_fused.limit_caas_plain(*args)
    torch.cuda.synchronize()
    same(out, ref, f"K2 limit_caas ({nt}, {ncell}x{np2})")
    if not (bool((out >= args[3]).all()) and bool((out <= args[4]).all())):
        raise AssertionError("K2: output outside [qmin, qmax]")
    stats["limit_caas"] = dict(
        max_abs_err=float((out - ref).abs().max()),
        ms=cuda_ms(lambda: cdr_fused.limit_caas(*args)),
        plain_ms=cuda_ms(lambda: cdr_fused.limit_caas_plain(*args)))
    log(f"K2 limit_caas ({nt}, {ncell}x{np2}): bitwise == plain, bounds "
        f"held; {stats['limit_caas']['ms']:.4f} ms vs plain "
        f"{stats['limit_caas']['plain_ms']:.4f} ms")

    # K3: zero-density nodes exercise the F-weighted fallback.
    ndgll = ncell * np2
    Ff = mesh.dgbfi_gll.reshape(-1).contiguous()
    rho_n = torch.tensor(rng.uniform(0.5, 1.5, ndgll), **f64)
    rho_n[torch.tensor(rng.random(ndgll) < 0.05, device=dev)] = 0.0
    w = Ff * rho_n
    idx32 = mesh.c2d_idx.to(torch.int32).contiguous()
    d2c = mesh.dgll2cgll.reshape(-1)
    k3_err = 0.0
    for rows in (1, nt):
        q = torch.tensor(rng.uniform(0.0, 1.0, (rows, ndgll)), **f64)
        kargs = (w, Ff, q, mesh.c2d_idx, mesh.c2d_mask, d2c)
        out = dss.dss_q(*kargs, c2d_idx32=idx32)
        ref = dss.dss_q_plain(*kargs)
        torch.cuda.synchronize()
        same(out, ref, f"K3 dss_q ({rows}, {ndgll})")
        vals = q[:, mesh.c2d_idx]
        inf = torch.tensor(float("inf"), **f64)
        lo = torch.where(mesh.c2d_mask, vals, inf).amin(-1)[:, d2c]
        hi = torch.where(mesh.c2d_mask, vals, -inf).amax(-1)[:, d2c]
        if not (bool((out >= lo).all()) and bool((out <= hi).all())):
            raise AssertionError("K3: output outside the slot range")
        k3_err = max(k3_err, float((out - ref).abs().max()))
    stats["dss_q"] = dict(
        max_abs_err=k3_err,
        ms=cuda_ms(lambda: dss.dss_q(*kargs, c2d_idx32=idx32)),
        plain_ms=cuda_ms(lambda: dss.dss_q_plain(*kargs)))
    log(f"K3 dss_q (1|{nt}, {ndgll}): bitwise == plain, bounds held; "
        f"{stats['dss_q']['ms']:.4f} ms vs plain "
        f"{stats['dss_q']['plain_ms']:.4f} ms")


def phase_small_reference(dev):
    """ne4, 4 tracers, 3 f64 steps: the card (kernels) against the CPU
    (plain versions)."""
    from compose_tpu_torch import driver
    from compose_tpu_torch.mesh import cubed_sphere
    from compose_tpu_torch.transport import gallery
    from compose_tpu_torch.transport.isl import IslConfig, IslTransport

    ics = ["gaussianhills", "slottedcylinders", "cosinebells", "xyztrig"]
    res = {}
    for d in ("cpu", dev):
        mesh = cubed_sphere.build(4, 4, device=d)
        model = IslTransport(mesh, gallery.create_wind("divergent"),
                             IslConfig(ne=4, nsub=2))
        rho = torch.ones((mesh.ncell, mesh.np2), dtype=torch.float64,
                         device=d)
        q = driver.init_tracers(mesh, ics)
        dt = 86400.0 * 12 / 3
        for s in range(3):
            rho, q = model.step(rho, q, s * dt, (s + 1) * dt)
        res[str(d)] = (rho.cpu(), q.cpu())
    (rc, qc), (rg, qg) = res["cpu"], res[str(dev)]
    err = max(float((rc - rg).abs().max()), float((qc - qg).abs().max()))
    log(f"small reference (ne4, 4 tracers, 3 f64 steps): max |card - cpu| "
        f"= {err:.3e} (tolerance 1e-12)")
    if not err <= 1e-12:
        raise AssertionError(f"card run disagrees with the CPU run: {err}")


def phase_main_path(dev, ne=30, nsteps=120):
    from compose_tpu_torch import driver
    from compose_tpu_torch.diagnostics import Observer
    from compose_tpu_torch.mesh import cubed_sphere
    from compose_tpu_torch.transport import cdr_fused, dss, gallery
    from compose_tpu_torch.transport.isl import IslConfig, IslTransport

    np_, nt = 4, 40
    mesh = cubed_sphere.build(ne, np_, device=dev)
    cfg = IslConfig(ne=ne, np_=np_, filter="caas", limiter="caas",
                    rho_isl=True, nsub=8, geom_dtype="f32",
                    interp_dtype="f32")
    model = IslTransport(mesh, gallery.create_wind("divergent"), cfg)
    rho = torch.ones((mesh.ncell, mesh.np2), dtype=torch.float64, device=dev)
    q1 = driver.init_tracers(mesh, ["gaussianhills", "slottedcylinders",
                                    "cosinebells", "xyztrig"])
    q = q1.repeat(-(-nt // q1.shape[0]), 1, 1)[:nt].contiguous()
    q0, rho0 = q, rho
    obs = Observer(mesh.dgbfi_gll, mesh.dgbfi_sphere,
                   ["rho"] + [f"q{i}" for i in range(nt)])
    obs.add_obs(0.0, rho, list(q))
    T = 86400.0 * 12
    dt = T / nsteps

    kernels = (cdr_fused.glbl_caas, cdr_fused.limit_caas, dss.dss_q)
    for k in kernels:
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
    launches = {k.__name__: k.launches for k in kernels}

    want = {"glbl_caas": 2 * nsteps, "limit_caas": nsteps,
            "dss_q": 2 * nsteps}
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    if not (bool(torch.isfinite(q).all()) and bool(torch.isfinite(rho).all())
            and q.shape == q0.shape and rho.shape == rho0.shape):
        raise AssertionError("non-finite or misshapen state")
    ok, mass_err, bounds_err = obs.check()
    if not ok:
        raise AssertionError(f"Observer check failed: mass {mass_err:.3e}, "
                             f"bounds {bounds_err:.3e}")
    out = driver.summarize(mesh, q0[0], rho0, q[0], rho)
    sec = statistics.median(step_s[1:])
    dof_s = mesh.ncell * mesh.np2 * nt / sec
    log(f"main path ne{ne} np{np_} {nt} tracers, {nsteps} steps: "
        f"step {sec * 1e3:.3f} ms (median of steps 2..{nsteps}; first "
        f"{step_s[0] * 1e3:.1f} ms), {dof_s:.4e} tracer-DOF/s; "
        f"l2 {out.l2_err:.4e} cv_gll {out.cv_gll:.3e}; Observer mass "
        f"{mass_err:.3e} bounds {bounds_err:.3e}; launches/step "
        f"K1 {launches['glbl_caas'] // nsteps} K2 "
        f"{launches['limit_caas'] // nsteps} K3 {launches['dss_q'] // nsteps}")
    return launches


def phase_golden(dev):
    from compose_tpu_torch import driver
    out = driver.run(ne=10, np_=4, nsteps=12,
                     ics=("slottedcylinders", "cosinebells", "gaussianhills"),
                     filter_="caas", limiter="caas", geom_dtype="f32",
                     interp_dtype="f32", verbose=False, device=dev)
    log(f"golden isl_caas_flagship_f32 (ne10, 12 steps): l2 "
        f"{out.l2_err:.4e} cv_gll {out.cv_gll:.3e} min {out.min_e:.4f} max "
        f"{out.max_e:.4f} step-mass {out.max_step_mass_err:.3e} "
        f"step-bounds {out.max_step_bounds_err:.3e}")
    if not (0 < out.l2_err <= 3.47e-1 and out.cv_gll <= 5e-14
            and out.min_e >= 0.1 and out.max_e <= 1.0
            and out.max_step_mass_err < 1e-12
            and out.max_step_bounds_err < 5e-13):
        raise AssertionError("golden row isl_caas_flagship_f32 failed")


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

    stats = {}
    phase_kernels(dev, stats)
    phase_small_reference(dev)
    launches = phase_main_path(dev)
    phase_golden(dev)

    rows = [("glbl_caas", K1_SRC, "compose_tpu/transport/cdr_fused.py:57"),
            ("limit_caas", K2_SRC, "compose_tpu/transport/cdr_fused.py:258"),
            ("dss_q", K3_SRC, "compose_tpu/transport/dss_face.py:115")]
    print(json.dumps({"kernels": [
        dict(name=n, route="cuda", source=src, replaces=rep,
             launches=launches[n], **stats[n]) for n, src, rep in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
