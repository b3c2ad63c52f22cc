"""Run diagnostics (compose_tpu.diagnostics): the Observer, per-step mass
and extrema time series with the reference's PASS/FAIL check and a JSON
dump, and the Lauritzen et al. (GMD 2012) standard-suite diagnostics,
filament preservation and numerical mixing. The Lauritzen diagnostics are
host numpy in f64 on the fields moved to the CPU, as in the JAX package.
"""

import dataclasses
import json

import numpy as np
import torch

from .config import F64
from .ops.reduce import bfb_sum


def _host(x):
    """A tensor or array as a flat f64 numpy array on the host."""
    if torch.is_tensor(x):
        x = x.detach().to(device="cpu", dtype=F64).numpy()
    return np.asarray(x, dtype=np.float64).ravel()


def filament_diag(q, dA, fila_t0=None, jlevels: int = 18):
    """Filament preservation. q, dA: (n,) mixing ratio and cell areas.
    With fila_t0 None, returns (thresholds, A0) for the initial field;
    otherwise (thresholds, 100 * A(tau) / A0(tau))."""
    q, dA = _host(q), _host(dA)
    tiny = 1e-12
    thresholds = 0.1 + (np.arange(jlevels + 1) / jlevels) * 0.9
    areas = np.array([dA[q >= thr - tiny].sum() for thr in thresholds])
    if fila_t0 is None:
        return thresholds, areas
    out = np.where(fila_t0 < tiny, 0.0, 100.0 * areas
                   / np.where(fila_t0 < tiny, 1.0, fila_t0))
    return thresholds, out


def correlation_diag(q1, q2, dA):
    """Numerical-mixing diagnostics of the cosinebells /
    correlatedcosinebells pair: (real_mixing, range_pres_unmixing,
    overshooting), i.e. l_r, l_u, l_o."""
    q1, q2, dA = _host(q1), _host(q2), _host(dA)
    eps = 1e-7
    q1_min, q1_max = 0.1, 1.0

    def corr(x):
        return -0.8 * x * x + 0.9

    q2_min = corr(q1_min)
    q2_max = corr(q1_max)
    sqrt_arg = (-1687296.0 + 12168000.0 * q2 - 29250000.0 * q2 ** 2
                + 23437500.0 * q2 ** 3 + 29648025.0 * q1 ** 2)
    sqrt_arg = np.maximum(sqrt_arg, 0.0)
    c = np.cbrt(65340.0 * q1 + 12.0 * np.sqrt(sqrt_arg)) / 60.0
    c = np.where(c == 0, 1.0, c)
    root = c - (-(13.0 / 75.0) + (5.0 / 12.0) * q2) / c
    root = np.clip(root, 0.1, 1.0)
    dist = np.sqrt((root - q1) ** 2 / 0.9 ** 2
                   + (corr(root) - q2) ** 2 / 0.792 ** 2)
    a = (q2_max - q2_min) / (q1_max - q1_min)
    b = q2_min - q1_min * a
    on_curve_side = (q2 < corr(q1) + eps) & (q2 > a * q1 + b - eps)
    in_box = ((q1 < q1_max + eps) & (q1 > q1_min - eps)
              & (q2 < q2_min + eps) & (q2 > q2_max - eps))
    total = dA.sum()
    wreal = np.where(on_curve_side, dist, 0.0)
    wunmix = np.where(~on_curve_side & in_box, dist, 0.0)
    wover = np.where(~on_curve_side & ~in_box, dist, 0.0)
    return (float((wreal * dA).sum() / total),
            float((wunmix * dA).sum() / total),
            float((wover * dA).sum() / total))


class LauritzenDiag:
    """The reference's LauritzenDiag: A0 of the cosinebells tracer at
    t = 0, then filament preservation and (with correlatedcosinebells)
    the mixing diagnostics at day 6, the middle of a 12-day run."""

    def __init__(self, nsteps_per_12days, ics, q0, dA):
        self.nsteps = nsteps_per_12days
        self.dA = _host(dA)
        self.i_cb = self.i_ccb = -1
        for i, name in enumerate(ics):
            if name.lower() == "cosinebells":
                self.i_cb = i
            elif name.lower() == "correlatedcosinebells":
                self.i_ccb = i
        self.results = {}
        if self.i_cb >= 0:
            self.thresholds, self.fila_t0 = filament_diag(q0[self.i_cb],
                                                          self.dA)

    def run(self, step, q):
        """Call after each step; acts only at day 6. Returns whether it
        acted."""
        if self.i_cb < 0:
            return False
        if not (self.nsteps % 2 == 0 and step + 1 == self.nsteps // 2):
            return False
        _, fila = filament_diag(q[self.i_cb], self.dA, self.fila_t0)
        self.results["filament"] = fila
        if self.i_ccb >= 0:
            lr, lu, lo = correlation_diag(q[self.i_cb], q[self.i_ccb],
                                          self.dA)
            self.results.update(l_r=lr, l_u=lu, l_o=lo)
        return True

    def print_(self):
        r = self.results
        if "l_r" in r:
            print(f"L    l_r {r['l_r']:8.2e} l_u {r['l_u']:8.2e} "
                  f"l_o {r['l_o']:8.2e}")
        if "filament" in r:
            print("L    thr " + " ".join(f"{t:1.3f}" for t in self.thresholds))
            print("L    fil " + " ".join(f"{f:1.2f}" for f in r["filament"]))


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

    def dump(self, path):
        """The series as JSON: {"times": [...], "fields": {name:
        {"mass_gll", "mass_sphere", "min", "max"}}}, the JAX package's
        keys."""
        out = {"times": self.times, "fields": {
            fs.name: {"mass_gll": fs.mass_gll, "mass_sphere": fs.mass_sphere,
                      "min": fs.min_, "max": fs.max_}
            for fs in self.fields}}
        with open(path, "w") as f:
            json.dump(out, f)
