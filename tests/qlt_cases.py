"""Inputs for the QLT tree kernel's tests (tests/test_torch_qlt_kernel.py
on the CPU, tests/test_torch_cuda.py on the card), and the bitwise
comparison they share."""

import numpy as np
import torch


def qlt_case(ncell, nt, dtype, kind, seed=0):
    """(rhom, Qm, Qm_min, Qm_max, extra): "perturbed" as qlt_perftest draws
    them (masses off their bounds) with a nonzero extra; "feasible" masses
    inside their bounds and no extra (every node passes its kids' masses
    through); "infeasible" an extra beyond the bounds' total; "ties" small
    multiples of 1/2 (exact sums, tied wall crossings, signed zeros)."""
    rng = np.random.default_rng(seed)
    if kind == "ties":
        r = rng.integers(1, 3, ncell).astype(float)
        lo = rng.integers(-2, 2, (nt, ncell)) * 0.5
        hi = lo + rng.integers(0, 3, (nt, ncell)) * 0.5
        Qm = rng.integers(-3, 4, (nt, ncell)) * 0.5
        extra = rng.integers(-2, 3, nt) * 0.5
        return [torch.tensor(x, dtype=dtype) for x in (r, Qm, lo, hi, extra)]
    r = rng.uniform(0.5, 1.0, ncell)
    qmin = rng.uniform(0, .3, (nt, ncell))
    qmax = qmin + rng.uniform(.2, .5, (nt, ncell))
    frac = rng.uniform(0, 1, (nt, ncell))
    Qm = (qmin + (qmax - qmin) * frac) * r
    extra = np.zeros(nt)
    if kind == "perturbed":
        Qm = Qm + 0.2 * rng.standard_normal((nt, ncell)) * r
        extra = 0.1 * rng.standard_normal(nt) * np.sqrt(ncell)
    elif kind == "infeasible":
        span = ((qmax - qmin) * r).sum(-1)
        extra = np.where(rng.random(nt) < 0.5, -1.0, 1.0) * (span + 1.0)
    return [torch.tensor(x, dtype=dtype)
            for x in (r, Qm, qmin * r, qmax * r, extra)]


def same_bits(a, b):
    """Bitwise equality, the sign of zero included; NaN where both are."""
    ints = {torch.float64: torch.int64, torch.float32: torch.int32}[a.dtype]
    return a.shape == b.shape and bool(
        ((a.view(ints) == b.view(ints)) | (a.isnan() & b.isnan())).all())
