"""CAAS: the standalone clip-and-assured-sum constrained density
reconstructor (compose_tpu.cdr.caas).

The global problem compresses to four sums per tracer (clipped mass, mass
target, lower and upper bound sums); the surplus or deficit is then spread
in proportion to each cell's headroom toward the bound it moves to. The
sums follow ops/reduce.bfb_sum's fixed adjacent-pair tree. This is not the
spf filter's global CAAS (kernel K1, transport/cdr_fused.glbl_caas): its
mass target is sum(Qm_prev) when given, it picks the headroom by the sign
of the discrepancy, and it clips once more at the end.
"""

import torch

from ..ops.reduce import bfb_sum


def run(Qm, Qm_min, Qm_max, Qm_prev=None):
    """One CAAS solve over (nt, ncells) masses. With `Qm_prev` the mass
    target is sum(Qm_prev) (the conserve problem type), else sum(Qm).
    Returns the reconstructed Qm: its sum is the target, each cell within
    its bounds up to roundoff, and a feasible input with no discrepancy is
    returned clipped, i.e. unchanged."""
    Qm_clip = torch.minimum(torch.maximum(Qm, Qm_min), Qm_max)
    Qm_term = Qm if Qm_prev is None else Qm_prev
    clip_sum = bfb_sum(Qm_clip)
    m = bfb_sum(Qm_term) - clip_sum                           # (nt,)
    # m < 0: remove mass toward Qm_min; m > 0: add toward Qm_max.
    up = m > 0
    fac = torch.where(up, bfb_sum(Qm_max) - clip_sum,
                      clip_sum - bfb_sum(Qm_min))
    ok = fac > 0
    scale = torch.where(ok, m / torch.where(ok, fac, 1.0), 0.0)
    dirn = torch.where(up[:, None], Qm_max - Qm_clip, Qm_clip - Qm_min)
    out = Qm_clip + scale[:, None] * dirn
    # The final safety clip against the bound moved toward.
    out = torch.where(up[:, None], torch.minimum(out, Qm_max),
                      torch.maximum(out, Qm_min))
    return torch.where((m == 0)[:, None], Qm_clip, out)
