"""Shape-preservation filters: global mass redistribution over cells
(compose_tpu.transport.spf), the CAAS method only.

Given per-cell (rho_mass, Q_min, Q_mass, Q_max) and a global mass
discrepancy `extra_mass`, produce per-cell masses summing to
sum(Q_mass) + extra_mass, inside [Q_min, Q_max] when feasible.
"""

import torch

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


class MassRedistributor:
    """spf::MassRedistributor for method 'caas' (kernel K1)."""

    def __init__(self, ncell: int, method: str = "caas"):
        if method != "caas":
            raise NotImplementedError(f"spf method '{method}' is not ported")
        self.ncell = ncell
        self.method = method

    def redistribute(self, rho_mass, Q_min, Q_mass, Q_max, extra_mass):
        """Per-cell redistributed masses; Q_* (ncell,) or (nt, ncell),
        extra_mass scalar or (nt,)."""
        return glbl_caas(Q_min, Q_mass, Q_max, extra_mass)
