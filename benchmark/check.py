"""The comparison that decides `correct`.

The program's timed path hands over, for a few steps of the window drawn
from the seed, the state before and after the step, and the state at the
start and at the end of the window. The plain reference (reference.py)
recomputes each sampled step from its input state and the step's times.
The numbers:

  state_gap     largest |program - reference| over rho and every tracer
                after a sampled step, relative to the field's largest |value|
  step_mass     largest relative change of a field's mass (sum F rho q,
                F the reference's GLL weights) over a sampled step
  bounds        largest excess of a tracer after a sampled step over the
                bounds its departure cells allow (the reference's: the
                range of each slot's departure cell, widened over the
                node's coincident slots by the DSS), relative to the
                tracer's range
  window_mass   largest relative change of a field's mass over the window
  global_bounds largest excess of a tracer at the window's end over its
                range at the window's start, relative to that range
  nonfinite     NaNs and infinities in the states handed over

Each number is compared with its limit from limits/<workload>.json.
"""

import math

import torch

from . import reference as ref_mod


def masses(F, rho, q):
    """(1 + nt,) masses of rho and of each tracer, in f64."""
    F, rho, q = (x.to(torch.float64) for x in (F, rho, q))
    rm = F * rho
    return torch.cat([rm.sum().reshape(1), (q * rm[None]).sum((1, 2))])


def _worst(prev, x):
    """The larger of two readings, where a NaN is the worst of all (Python's
    max(0.0, nan) would return 0.0)."""
    return x if math.isnan(x) or x > prev else prev


def _rel_change(a, b):
    return float(torch.max(torch.abs(b - a) / torch.abs(a)))


def _range(q):
    lo = torch.amin(q, dim=(1, 2))
    hi = torch.amax(q, dim=(1, 2))
    return lo, hi, torch.clamp_min(hi - lo, 1e-300)


def node_bound_excess(mesh, q_min_node, q_max_node, q_out, scale):
    """Excess of q_out over the slot bounds united over each continuous
    node's coincident slots, relative to `scale` (nt,)."""
    nt = q_out.shape[0]
    lo = q_min_node.reshape(nt, -1)
    hi = q_max_node.reshape(nt, -1)
    idx, mask = mesh.c2d_idx, mesh.c2d_mask
    inf = float("inf")
    lo_c = torch.amin(torch.where(mask, lo[:, idx], inf), dim=-1)
    hi_c = torch.amax(torch.where(mask, hi[:, idx], -inf), dim=-1)
    d2c = mesh.dgll2cgll.reshape(-1)
    qo = q_out.reshape(nt, -1)
    ex = torch.clamp_min(torch.maximum(lo_c[:, d2c] - qo, qo - hi_c[:, d2c]),
                         0.0)
    return float(torch.max(torch.amax(ex, dim=-1) / scale))


def compare(reference, samples, start, end):
    """The numbers of the module docstring. `reference`: a
    reference.Reference in the configuration's precision; `samples`: (ts,
    tf, rho_in, q_in, rho_out, q_out) of the sampled steps; `start`, `end`:
    (rho, q) of the window. Tensors anywhere; computed on the reference's
    device."""
    mesh = reference.mesh
    dev, dt = mesh.F.device, reference.opt.dtype
    F = mesh.F
    nums = dict(state_gap=0.0, step_mass=0.0, bounds=0.0)
    nonfinite = 0
    for ts, tf, rho_in, q_in, rho_out, q_out in samples:
        rho_in, q_in, rho_out, q_out = (x.to(device=dev, dtype=dt)
                                        for x in (rho_in, q_in, rho_out,
                                                  q_out))
        nonfinite += int((~torch.isfinite(rho_out)).sum()) \
            + int((~torch.isfinite(q_out)).sum())
        r_rho, r_q, nsc = reference.step(rho_in, q_in, ts, tf)
        for p, r in [(rho_out, r_rho)] + list(zip(q_out, r_q)):
            gap = float(torch.max(torch.abs(p - r))
                        / torch.clamp_min(torch.max(torch.abs(r)), 1e-300))
            nums["state_gap"] = _worst(nums["state_gap"], gap)
        nums["step_mass"] = _worst(nums["step_mass"], _rel_change(
            masses(F, rho_in, q_in), masses(F, rho_out, q_out)))
        qmin, qmax = reference.node_bounds(q_in, nsc)
        nums["bounds"] = _worst(nums["bounds"], node_bound_excess(
            mesh, qmin, qmax, q_out, _range(q_in)[2]))
        del r_rho, r_q, nsc, qmin, qmax
    rho0, q0 = (x.to(device=dev, dtype=torch.float64) for x in start)
    rho1, q1 = (x.to(device=dev, dtype=torch.float64) for x in end)
    nonfinite += int((~torch.isfinite(rho1)).sum()) \
        + int((~torch.isfinite(q1)).sum())
    nums["window_mass"] = _rel_change(masses(F, rho0, q0),
                                      masses(F, rho1, q1))
    lo, hi, scale = _range(q0)
    ex = torch.clamp_min(torch.maximum(lo - torch.amin(q1, dim=(1, 2)),
                                       torch.amax(q1, dim=(1, 2)) - hi), 0.0)
    nums["global_bounds"] = float(torch.max(ex / scale))
    nums["nonfinite"] = nonfinite
    return nums


def judge(nums, limits):
    """(correct, failed, {name: [number, limit]}) over the numbers that
    have a limit; a NaN fails."""
    table, failed = {}, 0
    for name, limit in limits.items():
        v = nums.get(name)
        ok = v is not None and not math.isnan(v) and v <= limit
        failed += not ok
        table[name] = [v, limit]
    return failed == 0, failed, table


def reference_for(config, device):
    """The reference step of a configuration's file, on `device`."""
    isl = config["isl"]
    dt = {"f64": torch.float64, "f32": torch.float32}
    real = torch.float64 if config["x64"] else torch.float32
    mesh = ref_mod.build_mesh(config["ne"], config["np"], device=device,
                              dtype=real)
    opt = ref_mod.Options(filter=isl["filter"], limiter=isl["limiter"],
                          nsub=isl["nsub"], geom_dtype=dt[isl["geom_dtype"]],
                          interp_dtype=dt[isl["interp_dtype"]], dtype=real)
    return ref_mod.Reference(mesh, opt)
