"""Batched local QP / filter solvers (compose_tpu.ops.local_qp), over the
last axis, broadcast over leading batch axes:

    min_x sum_i w_i (x_i - y_i)^2  s.t.  a'x = b,  xlo <= x <= xhi

caas (clip and assured sum, its sums bfb_sum's tree), caas_gsum (the same
with a caller's global sum), clip_and_weighted_sum (CAAGS),
solve_1eq_bc_qp (Newton on the multiplier) and solve_1eq_nonneg.
"""

import torch

from .. import trace
from .reduce import bfb_sum

_EPS = 2.220446049250313e-16


def _clip(x, lo, hi):
    """jnp.clip order: max with the lower bound, then min with the upper."""
    return torch.minimum(torch.maximum(x, lo), hi)


def calc_r_tol(b, a, y):
    """Residual tolerance 10 eps max(|b|, max |a y|), eps the f64 one."""
    ab = torch.maximum(torch.abs(b), torch.amax(torch.abs(a * y), dim=-1))
    return 1e1 * _EPS * ab


def caas(a, b, xlo, xhi, y, clip: bool = True):
    """ClipAndAssuredSum: clip y into [xlo, xhi], spread dm = b - a'x in
    proportion to the headroom toward the needed bound, re-clip. The sums
    over the last axis are bfb_sum's adjacent-pair tree (the order of the
    K2 kernel's cell sums)."""
    x = _clip(y, xlo, xhi)
    dhi = xhi - x
    dlo = x - xlo
    dm = b - bfb_sum(a * x)
    up = dm > 0
    fac = torch.where(up, bfb_sum(a * dhi), bfb_sum(a * dlo))
    pos = fac > 0
    scale = torch.where(pos, dm / torch.where(pos, fac, 1.0), 0.0)
    x = x + scale[..., None] * torch.where(up[..., None], dhi, dlo)
    if clip:
        x = _clip(x, xlo, xhi)
    return x


def caas_gsum(a, b, xlo, xhi, y, gsum, clip: bool = True):
    """`caas` with a caller-supplied sum over the last axis (the ISL
    caas-node filter passes bfb_sum over all DGLL nodes). Its sums follow
    the JAX package's expressions: the headroom is xhi - x or x - xlo."""
    x = _clip(y, xlo, xhi)
    dm = b - gsum(a * x)
    fac_hi = gsum(a * (xhi - x))
    fac_lo = gsum(a * (x - xlo))
    up = dm > 0
    fac = torch.where(up, fac_hi, fac_lo)
    pos = fac > 0
    scale = torch.where(pos, dm / torch.where(pos, fac, 1.0), 0.0)
    x = x + scale[..., None] * torch.where(up[..., None], xhi - x, x - xlo)
    if clip:
        x = _clip(x, xlo, xhi)
    return x


def clip_and_weighted_sum(a, b, xlo, xhi, y):
    """CAAGS: like caas, but the discrepancy is spread along a blend of
    the proportional-headroom direction v and the constant-per-node
    direction w_i = 1/a_i (over nodes with headroom), the blend factor as
    large as the bounds allow."""
    x = _clip(y, xlo, xhi)
    m = b - torch.sum(a * x, dim=-1)
    up = m > 0
    v = torch.where(up[..., None], xhi - x, x - xlo)
    v_den = torch.sum(v * a, dim=-1)
    has_room = torch.where(up[..., None], y < xhi, y > xlo)
    wdir = torch.where(has_room, 1.0 / a, 0.0)
    w_den = torch.sum(wdir * a, dim=-1)
    v_den_safe = torch.where(v_den != 0, v_den, 1.0)
    w_den_safe = torch.where(w_den > 0, w_den, 1.0)
    vi = v / v_den_safe[..., None]
    wi = wdir / w_den_safe[..., None]
    bound = torch.where(up[..., None], xhi, xlo)
    num = bound - x - m[..., None] * vi
    den = m[..., None] * (wi - vi)
    frac = torch.where((wi > vi) & (torch.abs(num) < torch.abs(den)),
                       num / torch.where(den != 0, den, 1.0), 1.0)
    alpha = torch.clamp_max(torch.amin(frac, dim=-1), 1.0)
    alpha = torch.where(w_den > 0, alpha, 0.0)
    blend = (1 - alpha[..., None]) * vi + alpha[..., None] * wi
    step = torch.where((m != 0)[..., None] & (v_den != 0)[..., None],
                       m[..., None] * torch.where(alpha[..., None] > 0,
                                                  blend, vi), 0.0)
    return _clip(x + step, xlo, xhi)


def solve_1eq_nonneg(a, b, y, w, method: str = "caas"):
    """Nonnegativity-constrained distribution: bounds [0, b / a_i]. Lanes
    with b < 0 are infeasible and return y unchanged with info -1.
    Returns (x, info)."""
    xhi = b[..., None] / a
    zero = torch.zeros_like(y)
    if method == "caas":
        x = caas(a, b, zero, xhi, y)
        info = torch.ones(b.shape, dtype=torch.int32, device=b.device)
    else:
        x, info = solve_1eq_bc_qp(w, a, b, zero, xhi, y)
    feasible = b >= 0
    x = torch.where(feasible[..., None], x, y)
    info = torch.where(feasible, info, -1).to(torch.int32)
    return x, info


def solve_1eq_bc_qp(w, a, b, xlo, xhi, y, max_its: int = 50):
    """Single-equality bound-constrained QP by bisection-safeguarded Newton
    on the Lagrange multiplier. Returns (x, info): info 1 solved, -1
    infeasible, 0 input already satisfied the constraints. The loop stops
    when every lane has converged: one host sync per iteration. The
    residual tolerance keeps the JAX package's f64 eps in every dtype, so
    in f32 no lane converges and the loop runs all `max_its`."""
    r_tol = calc_r_tol(b, a, y)
    r_lo = torch.sum(a * xlo, dim=-1) - b
    r_hi = torch.sum(a * xhi, dim=-1) - b
    lo_is_sol = torch.abs(r_lo) <= r_tol
    hi_is_sol = torch.abs(r_hi) <= r_tol
    infeas = (~lo_is_sol) & (~hi_is_sol) & ((r_lo > 0) | (r_hi < 0))
    corner_done = lo_is_sol | hi_is_sol | infeas
    x_corner = torch.where((lo_is_sol | (r_lo > 0))[..., None], xlo, xhi)

    y_in = torch.all((y >= xlo) & (y <= xhi), dim=-1)
    ry = torch.abs(torch.sum(a * y, dim=-1) - b)
    y_done = y_in & (ry <= r_tol) & ~corner_done

    rq = w / a
    lamlo = torch.amin(rq * (xlo - y), dim=-1)
    lamhi = torch.amax(rq * (xhi - y), dim=-1)
    lam = torch.where((lamlo <= 0) & (lamhi >= 0), 0.0, lamlo)
    wall_dist = 1e-3
    q = a / w
    aq = a * q
    done = corner_done | y_done
    x_newton = y.clone()
    prev_bisect = torch.zeros_like(done)
    trace.count("qp.calls")
    for _ in range(max_its):
        if bool(torch.all(done)):
            break
        trace.count("qp.newton_iters")
        x_trial = y + lam[..., None] * q
        inside = (x_trial >= xlo) & (x_trial <= xhi)
        x_it = _clip(x_trial, xlo, xhi)
        r = torch.sum(a * x_it, dim=-1) - b
        r_lambda = torch.sum(torch.where(inside, aq, 0.0), dim=-1)
        converged = torch.abs(r) <= r_tol
        x_newton = torch.where((~done)[..., None], x_it, x_newton)
        done = done | converged
        lamhi = torch.where(r > 0, lam, lamhi)
        lamlo = torch.where(r > 0, lamlo, lam)
        nz = r_lambda != 0
        lam_newton = torch.where(nz, lam - r / torch.where(nz, r_lambda, 1.0),
                                 lamlo)
        D = torch.where(prev_bisect, 0.0, wall_dist * (lamhi - lamlo))
        need_bisect = (lam_newton - lamlo < D) | (lamhi - lam_newton < D)
        lam_next = torch.where(need_bisect, 0.5 * (lamlo + lamhi), lam_newton)
        lam = torch.where(done, lam, lam_next)
        prev_bisect = need_bisect & ~done
    info = torch.where(y_done, 0, torch.where(infeas, -1, 1)).to(torch.int32)
    x = torch.where(y_done[..., None], y,
                    torch.where(corner_done[..., None], x_corner, x_newton))
    return x, info
