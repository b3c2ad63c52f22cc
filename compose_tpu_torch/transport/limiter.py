"""Cell-local limiters (compose_tpu.transport.limiter): the density
positivity limiter, and the tracer limiters caas (kernel K2) and mn2 (the
bound-constrained QP of ops/local_qp).
"""

import torch

from ..ops import local_qp
from .cdr_fused import limit_caas


def limit_density(F, rho, extra_mass):
    """Positivity limiter for density. F, rho: (ncell, np2); extra_mass:
    (ncell,). Returns rho' >= 0 with sum(F rho') = sum(F rho) + extra_mass
    per cell. A uniform shift is the QP optimum unless it drives a node
    negative; only then (rare) the mn2 QP runs. Deciding that is one host
    sync per call."""
    mass_tgt = torch.sum(rho * F, dim=-1) + extra_mass
    any_below = torch.any(rho < 0, dim=-1)
    need = any_below | (extra_mass != 0)
    rho_clip = torch.clamp_min(rho, 0.0)
    mass = torch.sum(rho_clip * F, dim=-1)
    delta = mass_tgt - mass
    fac = delta / torch.sum(F, dim=-1)
    rho_add = rho_clip + fac[..., None]
    if bool(torch.any(rho_add < 0.0)):
        big = rho_clip + torch.abs(mass_tgt)[..., None] + 1.0
        x_qp, _ = local_qp.solve_1eq_bc_qp(F, F, mass_tgt,
                                           torch.zeros_like(rho), big,
                                           rho_clip)
    else:
        x_qp = rho_add
    sel = (delta >= 0) | torch.all(rho_add >= 0.0, dim=-1)
    out = torch.where(sel[..., None], rho_add, x_qp)
    return torch.where(need[..., None], out, rho)


def limit_tracer(F, rho, Q, q_min, q_max, Qm_extra, limiter: str = "caas",
                 precomp=None, return_q: bool = False):
    """Bounds-preserving tracer limiter, batched over tracers: per cell

        min sum_i w_i (q_i - y_i)^2  s.t.  sum_i F_i rho_i q_i = Qm_tot,
                                           q_min_i <= q_i <= q_max_i

    with w = a = F rho, y = Q / rho, Qm_tot = sum(F Q) + Qm_extra; 'caas'
    solves it by clip-and-assured-sum (K2), 'mn2' by the Newton QP.

    F, rho: (ncell, np2); Q, q_min, q_max: (nt, ncell, np2); Qm_extra:
    (nt, ncell). `precomp` = (rhom, Qm_tot, Qm_min, Qm_max) as the ISL CDR
    already has them. Returns the mixing ratios if `return_q`, else Q; nodes
    with rho == 0 take q_min (the ISL CDR's zero-density rule)."""
    if limiter not in ("caas", "mn2"):
        raise NotImplementedError(f"limiter '{limiter}' is not ported")
    if precomp is not None:
        rhom, Qm_tot = precomp[0], precomp[1]
    else:
        rhom = rho * F
        Qm_tot = torch.sum(Q * F, dim=-1) + Qm_extra
    if limiter == "caas":
        x = limit_caas(rhom, rho, Q, q_min, q_max, Qm_tot)
    else:
        # Zero-density nodes get a vanishing but nonzero QP weight so that
        # w/a and a/w stay finite. As in the JAX package, 1e-300 rounds to
        # 0 in f32, where a zero-density node then makes its cell NaN.
        a = torch.clamp_min(rhom, 1e-300)
        y = Q * (1.0 / torch.where(rho == 0, 1.0, rho))
        x, _ = local_qp.solve_1eq_bc_qp(a, a, Qm_tot, q_min, q_max, y)
        x = torch.where(rho == 0, q_min, x)
    return x if return_q else x * rho
