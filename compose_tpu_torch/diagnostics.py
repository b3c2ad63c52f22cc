"""Observer: per-step mass and extrema time series with the reference's
PASS/FAIL check (compose_tpu.diagnostics.Observer)."""

import dataclasses

import numpy as np
import torch

from .config import F64
from .ops.reduce import bfb_sum


@dataclasses.dataclass
class FieldSeries:
    name: str
    mass_gll: list = dataclasses.field(default_factory=list)
    mass_sphere: list = dataclasses.field(default_factory=list)
    min_: list = dataclasses.field(default_factory=list)
    max_: list = dataclasses.field(default_factory=list)


class Observer:
    """Per-step mass/extrema series; `check` applies the reference's bars
    (mass err < 1e-12, bounds err < 5e-13). Each observation reads its four
    numbers per field back to the host (a device sync). Masses are summed
    in f64 whatever the fields' dtype, so that an f32 run's series does not
    measure its own rounding."""

    def __init__(self, F_gll, F_sphere, names):
        self.F_gll = F_gll.reshape(-1).to(F64)
        self.F_sphere = F_sphere.reshape(-1).to(F64)
        self.fields = [FieldSeries(n) for n in names]
        self.times = []

    def add_obs(self, t, rho, qs):
        self.times.append(float(t))
        for fs, data in zip(self.fields, [rho] + list(qs)):
            Q = rho.to(F64).reshape(-1) if fs.name == "rho" \
                else (data.to(F64) * rho.to(F64)).reshape(-1)
            vals = torch.stack([bfb_sum(self.F_gll * Q),
                                bfb_sum(self.F_sphere * Q),
                                torch.amin(data).to(F64),
                                torch.amax(data).to(F64)]).tolist()
            fs.mass_gll.append(vals[0])
            fs.mass_sphere.append(vals[1])
            fs.min_.append(vals[2])
            fs.max_.append(vals[3])

    def check(self, mass_tol=1e-12, bounds_tol=5e-13, measure="gll"):
        """Return (ok, max_mass_err, max_bounds_err) over the series. Mass
        is checked for every field, in the measure the model conserves
        ("gll", or "sphere" for dmc es); bounds for the tracers only (a
        divergent flow changes the density's range)."""
        if measure not in ("gll", "sphere"):
            raise ValueError(f"measure '{measure}': expected gll | sphere")
        max_mass = 0.0
        max_bounds = 0.0
        for fs in self.fields:
            m = np.asarray(fs.mass_gll if measure == "gll"
                           else fs.mass_sphere)
            if len(m) > 1:
                max_mass = max(max_mass, float(np.max(
                    np.abs(np.diff(m)) / np.maximum(1.0, np.abs(m[1:])))))
            if fs.name == "rho":
                continue
            mn = np.asarray(fs.min_)
            mx = np.asarray(fs.max_)
            if len(mn) > 1:
                max_bounds = max(
                    max_bounds,
                    float(np.max(np.maximum(0.0, mn[0] - mn[1:]))),
                    float(np.max(np.maximum(0.0, mx[1:] - mx[0]))))
        return (max_mass < mass_tol and max_bounds < bounds_tol,
                max_mass, max_bounds)
