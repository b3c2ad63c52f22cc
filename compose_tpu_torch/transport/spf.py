"""Shape-preservation filters: global mass redistribution over cells
(compose_tpu.transport.spf), methods caas, qlt and mn2.

Given per-cell (rho_mass, Q_min, Q_mass, Q_max) and a global mass
discrepancy `extra_mass`, produce per-cell masses summing to
sum(Q_mass) + extra_mass, inside [Q_min, Q_max] when feasible.

  caas - closed-form clip and proportional fill (kernel K1);
  qlt  - the CEDR QLT tree over cells (cdr/qlt.py) with the
         shape-preserving node solve and the root-mass override;
  mn2  - one QP over all cells minimizing the l2 change.
"""

import torch

from .. import _native, trace
from ..cdr import qlt as qlt_mod
from ..ops import local_qp
from ..ops.reduce import bfb_sum
from .cdr_fused import glbl_caas


def record(F, rho, Q, q_min, q_max):
    """Per-cell reduction of nodal data: (rho_mass, Q_min, Q_mass, Q_max),
    each (..., ncell), from (..., ncell, np2) inputs."""
    rhom = F * rho
    rho_mass = torch.sum(rhom, dim=-1)
    Q_min = torch.sum(rhom * q_min, dim=-1)
    Q_max = torch.sum(rhom * q_max, dim=-1)
    Q_mass = torch.sum(F * Q, dim=-1)
    return rho_mass, Q_min, Q_mass, Q_max


def run_mn2(Q_min, Q_mass, Q_max, extra_mass):
    """Global min-norm-2 redistribution: one QP over all cells with unit
    weights. In f32 its Newton never meets the f64 residual tolerance, so
    it runs all 100 iterations (one host sync each)."""
    ones = torch.ones_like(Q_mass)
    b = bfb_sum(Q_mass) + extra_mass
    x, _ = local_qp.solve_1eq_bc_qp(ones, ones, b, Q_min, Q_max, Q_mass,
                                    max_its=100)
    return x


class MassRedistributor:
    """spf::MassRedistributor for the methods caas (kernel K1), qlt and
    mn2."""

    def __init__(self, ncell: int, method: str = "caas"):
        if method not in ("caas", "qlt", "mn2"):
            raise NotImplementedError(f"spf method '{method}' is not ported")
        self.ncell = ncell
        self.method = method
        # qlt: shape-preserving leaves and a direct root-mass override; no
        # conserve (Qm_prev) channel is needed.
        self._qlt = (qlt_mod.QLT(ncell, problem_type=qlt_mod.SHAPEPRESERVE)
                     if method == "qlt" else None)

    def redistribute(self, rho_mass, Q_min, Q_mass, Q_max, extra_mass):
        """Per-cell redistributed masses; Q_* (ncell,) or (nt, ncell),
        extra_mass scalar or (nt,), rho_mass (ncell,)."""
        if self.method == "caas":
            return glbl_caas(Q_min, Q_mass, Q_max, extra_mass)
        if self.method == "mn2":
            return run_mn2(Q_min, Q_mass, Q_max, extra_mass)
        args = (rho_mass, Q_min, Q_mass, Q_max, extra_mass)
        if _native.has_dtensor(*args):
            # The tree fills its node arrays in place, which DTensor cannot
            # propagate into plain buffers: each rank runs its whole copy.
            return _native.on_local(self.redistribute, args)
        squeeze = Q_mass.dim() == 1
        Qm, Qm_min, Qm_max = (torch.atleast_2d(x)
                              for x in (Q_mass, Q_min, Q_max))
        extra = torch.as_tensor(extra_mass, dtype=Qm.dtype,
                                device=Qm.device).expand(Qm.shape[:1])
        with trace.span("cdr.qlt"):
            out = self._qlt.run(rho_mass, Qm, Qm_min, Qm_max,
                                root_extra=extra)
        return out[0] if squeeze else out
