"""Offline Islet basis derivation and verification tools
(compose_tpu.islet_tools), on the port's own bases:

  - `isl_op`: the 1-D periodic semi-Lagrangian advection operator of a
    nodal basis;
  - `MaxEigComputer.max_eig_amp` and `bloch_max_eig_amp`: the stability
    metric lambda_max, the largest |eigenvalue| over a sweep of Courant
    offsets, batched through the native C++/LAPACK library built from
    native/islet_native.cpp at first use (a failed build raises);
  - `pum_metric`: lambda_max over randomly perturbed meshes;
  - the node-set accuracy metrics (a_1, a_2, a_inf), Lebesgue constants,
    `MetricsTracker` and the two-stage basis search.

They run on the host: numpy, the bases evaluated as f64 torch tensors on
the CPU, the eigensolves in native threads.
"""

import ctypes
import itertools
import os
import subprocess
import tempfile

import numpy as np
import torch

from . import basis as basis_mod
from .config import F64

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_ROOT, "native", "islet_native.cpp")
_LIB = os.path.join(_ROOT, "native", "build", "libislet_native.so")

_native = None


def _build_native():
    """g++ the library into a temporary file beside its target, then move
    it into place, so that no reader ever loads a half-written library."""
    os.makedirs(os.path.dirname(_LIB), exist_ok=True)
    lapack = "-llapack"
    if not os.path.exists("/usr/lib/x86_64-linux-gnu/liblapack.so"):
        lapack = "-l:liblapack.so.3"
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(_LIB))
    os.close(fd)
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", tmp,
           lapack, "-pthread"]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError("building the native Islet library failed: "
                               f"{' '.join(cmd)}\n{res.stderr}")
        os.replace(tmp, _LIB)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load_native():
    """The native eigensolver, built if it is missing or older than its
    source, then loaded with ctypes."""
    global _native
    if _native is not None:
        return _native
    if not os.path.exists(_LIB) or (
            os.path.getmtime(_SRC) > os.path.getmtime(_LIB)):
        _build_native()
    try:
        lib = ctypes.CDLL(_LIB)
    except OSError:
        # Another process (the JAX package's loader writes the library in
        # place) may be midway through writing it: build our own copy.
        _build_native()
        lib = ctypes.CDLL(_LIB)
    lib.islet_spectral_radius.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_double), ctypes.c_int]
    lib.islet_spectral_radius.restype = None
    _native = lib
    return lib


def spectral_radius(mats, nthreads: int = 0):
    """Batched spectral radius of dense matrices (n_mats, n, n) by the
    native library's LAPACK threads. Raises if LAPACK fails on one."""
    mats = np.ascontiguousarray(mats, dtype=np.float64)
    if mats.ndim == 2:
        mats = mats[None]
    n_mats, n, n2 = mats.shape
    if n != n2:
        raise ValueError(f"matrices of shape {mats.shape[1:]} are not square")
    lib = _load_native()
    out = np.empty(n_mats, dtype=np.float64)
    lib.islet_spectral_radius(
        mats.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n_mats, n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), nthreads)
    if np.any(out < 0):
        raise RuntimeError("LAPACK dgeev failed on matrices "
                           f"{np.nonzero(out < 0)[0].tolist()}")
    return out


def _eval(basis, x):
    """Basis values (..., np) at the numpy points x, as numpy f64."""
    return basis.eval(torch.tensor(np.asarray(x), dtype=F64)).numpy()


# ----------------------------------------------------------------------------
# 1-D periodic ISL operator.

def isl_op(basis, ne: int, dx: float, mesh_x=None):
    """The 1-D periodic ISL advection operator A of `basis` on `ne` cells
    covering [0, ne] (cell width 1 unless `mesh_x` gives the ne + 1 cell
    boundaries), for the displacement dx per step in mesh units. Unique
    nodes only (N = ne (np - 1)); A[i, j] is basis function j at the
    departure point of node i."""
    np_ = basis.np
    xn = np.asarray(basis.x)
    if mesh_x is None:
        mesh_x = np.arange(ne + 1, dtype=np.float64)
    mesh_x = np.asarray(mesh_x, dtype=np.float64)
    L = mesh_x[-1] - mesh_x[0]
    width = np.diff(mesh_x)
    N = ne * (np_ - 1)
    coords = np.empty(N)
    for c in range(ne):
        coords[c * (np_ - 1):(c + 1) * (np_ - 1)] = (
            mesh_x[c] + (xn[:-1] + 1) * 0.5 * width[c])
    A = np.zeros((N, N))
    dep = coords - dx
    dep = mesh_x[0] + np.mod(dep - mesh_x[0], L)
    cell = np.clip(np.searchsorted(mesh_x, dep, side="right") - 1, 0, ne - 1)
    a = 2 * (dep - mesh_x[cell]) / width[cell] - 1
    vals = _eval(basis, a)                                  # (N, np)
    for i in range(N):
        c = cell[i]
        for k in range(np_):
            A[i, (c * (np_ - 1) + k) % N] += vals[i, k]
    return A


class MaxEigComputer:
    """Stability analysis: lambda_max over a Courant sweep."""

    def __init__(self, basis):
        self.basis = basis

    def max_eig_amp(self, ne: int, ndx: int = 64, mesh_x=None):
        """Max |eig| of the ISL operator over ndx Courant offsets in (0, 1)
        (integer parts are exact shifts)."""
        dxs = (np.arange(ndx) + 0.5) / ndx
        mats = np.stack([isl_op(self.basis, ne, dx, mesh_x) for dx in dxs])
        return float(np.max(spectral_radius(mats)))


def bloch_max_eig_amp(basis, ne: int = 96, ndx: int = 64):
    """Bloch-wave stability analysis: on a uniform mesh the ISL operator
    is block circulant, so its spectrum is the union over the ne
    wavenumbers mu = exp(2 pi i k / ne) of the eigenvalues of the
    (np - 1) x (np - 1) blocks

        B(mu)[r, c] = mu^s(r) A[r, c] + (c == 0) mu^(s(r)+1) A[r, np-1],

    A the kernel block of each interior node's basis row at its shifted
    reference coordinate (wrapped across the cell) and s(r) 0 for rows
    still in the cell, 1 for wrapped ones. Returns max |lambda| over ndx
    Courant offsets in (0, 1)."""
    np_ = basis.np
    xg = np.asarray(basis.x)
    npm1 = np_ - 1
    worst = 0.0
    mus = np.exp(2j * np.pi * np.arange(ne) / ne)
    for dx in (np.arange(ndx) + 0.5) / ndx:
        K = int(np.sum(xg + 2 * dx < 1))
        refs = xg[:npm1] + 2 * dx
        refs = np.where(refs >= 1, refs - 2, refs)
        A = _eval(basis, refs)                              # (npm1, np)
        B = np.empty((ne, npm1, npm1), complex)
        B[:, :K, :] = A[None, :K, :npm1]
        B[:, K:, :] = mus[:, None, None] * A[None, K:, :npm1]
        B[:, :K, 0] += mus[:, None] * A[None, :K, npm1]
        B[:, K:, 0] += (mus * mus)[:, None] * A[None, K:, npm1]
        worst = max(worst, float(np.max(np.abs(np.linalg.eigvals(B)))))
    return worst


class MetricsTracker:
    """Pareto filter over (accuracy metrics, PUM) candidates: nbin
    log-spaced PUM bins from 1 down to machine eps, and per bin the best
    (a_1, a_2, a_inf) seen. A candidate is kept if it improves a metric in
    a bin whose PUM level it meets."""

    nmet, nbin = 3, 30

    def __init__(self, np_: int = 0, very_strict: bool = False):
        fac = np.finfo(np.float64).eps ** (1.0 / self.nbin)
        self.pum_bins = np.empty(self.nbin + 1)
        self.pum_bins[0] = 1.0
        for i in range(self.nbin):
            self.pum_bins[i + 1] = self.pum_bins[i] * fac
        self.best = np.full((self.nbin, self.nmet), np.inf)
        self.pum_max = 1.0
        self.pum_min = 1.0

    def set_pum_max(self, pum_max: float):
        if not 0 < pum_max <= 1:
            raise ValueError(f"pum_max {pum_max} outside (0, 1]")
        self.pum_max = pum_max

    def acceptable_metrics(self, metrics) -> bool:
        """Could these metrics update some bin (before the PUM is known)?"""
        return bool((np.asarray(metrics)[None, :] < self.best).any())

    def pum_to_accept(self, metrics) -> float:
        """The PUM a candidate with these metrics must beat to update."""
        m = np.asarray(metrics)
        for b in range(self.nbin):
            if (m < self.best[b]).any():
                return min(self.pum_max, float(self.pum_bins[b]))
        return 0.0

    def would_update(self, metrics, pum: float) -> bool:
        if pum > self.pum_max:
            return False
        b = 0
        while b < self.nbin - 1 and pum < self.pum_bins[b + 1]:
            b += 1
        return bool((np.asarray(metrics) < self.best[b]).any())

    def update(self, metrics, pum: float):
        m = np.asarray(metrics)
        updated = False
        for b in range(self.nbin):
            if pum > self.pum_bins[b]:
                break
            sel = m < self.best[b]
            if sel.any():
                self.best[b][sel] = m[sel]
                updated = True
        if updated:
            self.pum_min = min(self.pum_min, pum)

    def get_metrics(self, pum: float):
        b = 0
        while b < self.nbin and pum <= self.pum_bins[b]:
            b += 1
        return self.best[max(0, b - 1)].copy()


def pum_metric(basis, ne: int = 6, n_mesh: int = 8, ndx: int = 16,
               perturb: float = 0.25, seed: int = 0):
    """The perturbed-uniform-mesh stability metric: max |eig| over n_mesh
    randomly perturbed meshes (numpy's default_rng(seed)) and ndx Courant
    offsets."""
    rng = np.random.default_rng(seed)
    worst = 0.0
    mec = MaxEigComputer(basis)
    for _ in range(n_mesh):
        x = np.arange(ne + 1, dtype=np.float64)
        x[1:-1] += perturb * (2 * rng.random(ne - 1) - 1)
        worst = max(worst, mec.max_eig_amp(ne, ndx, mesh_x=x))
    return worst


# ----------------------------------------------------------------------------
# Node-set accuracy metrics.

def lebesgue_constant(basis, nsamp: int = 1001):
    """Max over [-1, 1] of sum_i |phi_i(x)|."""
    v = _eval(basis, np.linspace(-1.0, 1.0, nsamp))
    return float(np.max(np.sum(np.abs(v), axis=-1)))


class OffsetNodalBasis:
    """A GLL-node basis with the caller's region windows (os, subnp): the
    search space of the offset-nodal search."""

    def __init__(self, np_: int, regions):
        g = basis_mod.GLL(np_)
        self.np = np_
        self.x = g.x
        self.w = g.w       # placeholder weights; the search scores stability
        self.regions = tuple(regions)

    def eval(self, x):
        subsets = [list(range(os_, os_ + sub)) for (os_, sub) in self.regions]
        return basis_mod._regionwise_eval(self.x, subsets, x)


def search_offset_nodal(np_: int, ne: int = 5, ndx: int = 24,
                        tol: float = 1e-9, min_subnp: int = None):
    """The offset-nodal region configurations of np_ GLL nodes that are
    stable (lambda_max <= 1 + tol over the Courant sweep), sorted by the
    interpolation accuracy metric: a list of (regions, lambda_max,
    accuracy)."""
    nreg = np_ // 2
    if min_subnp is None:
        min_subnp = max(2, np_ - 2)
    per_region = []
    for i in range(nreg):
        # Region [x_i, x_i+1] must lie in its window so that nodal
        # interpolation stays exact in the region.
        per_region.append([(os_, sub) for sub in range(min_subnp, np_ + 1)
                           for os_ in range(0, np_ - sub + 1)
                           if os_ <= i and os_ + sub - 1 >= i + 1])
    out = []
    for regions in itertools.product(*per_region):
        b = OffsetNodalBasis(np_, regions)
        try:
            lam = MaxEigComputer(b).max_eig_amp(ne, ndx)
        except np.linalg.LinAlgError:
            continue
        if lam <= 1 + tol:
            out.append((regions, lam, interp_error_metric(b)))
    out.sort(key=lambda r: r[2])
    return out


def interp_error_metric(basis, degree: int = None, nsamp: int = 501):
    """Worst-case interpolation error of sin(pi x) on [-1, 1]: a simple
    accuracy proxy for ranking node sets."""
    xs = np.linspace(-1.0, 1.0, nsamp)
    v = _eval(basis, xs)
    fn = np.sin(np.pi * np.asarray(basis.x))
    return float(np.max(np.abs(v @ fn - np.sin(np.pi * xs))))


def _factorial(n):
    f = 1.0
    for i in range(2, n + 1):
        f *= i
    return f


def calc_xnodes_metrics(xnodes, subsets, nseg: int = 100):
    """The exact a_1 / a_2 / a_inf node-set accuracy metrics: per left-half
    region, midpoint-rule integrals of |prod_i (x - x_active_i)| / subnp!,
    the Lagrange remainder of the region's sub-polynomial. subsets: per
    region, its active node indices (left half)."""
    xnodes = np.asarray(xnodes)
    np_ = len(xnodes)
    a1 = a2 = ainf = 0.0
    for ireg in range(np_ // 2):
        center = (np_ % 2 == 0) and ireg == np_ // 2 - 1
        xs_, xe = xnodes[ireg], xnodes[ireg + 1]
        active = np.asarray(subsets[ireg])
        x = xs_ + (np.arange(nseg) + 0.5) * (xe - xs_) / nseg
        f = np.prod(x[:, None] - xnodes[active][None, :], axis=1)
        fac = _factorial(len(active))
        scale = (1 if center else 2) * (xe - xs_) / fac / nseg
        a1 += scale * np.abs(f).sum()
        a2 += scale * (f * f).sum() / fac
        ainf = max(ainf, np.abs(f).max() / fac)
    return a1, np.sqrt(a2), ainf


def calc_lebesgue_consts(xnodes, subsets, nseg: int = 100):
    """L1 / L2 / Linf Lebesgue constants of the region-wise basis."""
    xnodes = np.asarray(xnodes)
    np_ = len(xnodes)
    l1 = l2 = linf = 0.0
    for ireg in range(np_ // 2):
        center = (np_ % 2 == 0) and ireg == np_ // 2 - 1
        xs_, xe = xnodes[ireg], xnodes[ireg + 1]
        active = np.asarray(subsets[ireg])
        x = xs_ + (np.arange(nseg) + 0.5) * (xe - xs_) / nseg
        xa = xnodes[active]
        f = np.zeros(nseg)
        for i in range(len(active)):
            g = np.ones(nseg)
            for j in range(len(active)):
                if j != i:
                    g *= (x - xa[j]) / (xa[i] - xa[j])
            f += np.abs(g)
        scale = (1 if center else 2) * (xe - xs_) / nseg
        l1 += scale * f.sum()
        l2 += scale * (f * f).sum()
        linf = max(linf, f.max())
    return l1, np.sqrt(l2), linf


class NodalSubsetBasis:
    """A nodal-subset basis on GLL nodes: per left-half region, any active
    node subset."""

    def __init__(self, np_: int, subsets):
        g = basis_mod.GLL(np_)
        self.np = np_
        self.x = g.x
        self.subsets = tuple(tuple(s) for s in subsets)
        self.w = np.asarray(self.calc_weights())

    def eval(self, x):
        return basis_mod._regionwise_eval(self.x,
                                          [list(s) for s in self.subsets], x)

    def calc_weights(self):
        """The modified quadrature weights: per-region integrals of the
        basis functions (7-point Gauss), symmetrized."""
        qx, qw = np.polynomial.legendre.leggauss(7)
        xn = np.asarray(self.x)
        integral = np.zeros(self.np)
        for ireg in range(self.np - 1):
            x = 0.5 * (xn[ireg] + xn[ireg + 1]) \
                + 0.5 * (xn[ireg + 1] - xn[ireg]) * qx
            integral += 0.5 * (xn[ireg + 1] - xn[ireg]) * (qw @ _eval(self, x))
        for i in range(self.np // 2):
            o = self.np - i - 1
            integral[i] = integral[o] = 0.5 * (integral[i] + integral[o])
        return integral


def _nodal_subsets(np_, subnp_sig):
    """Per region i of the signature, the subsets of subnp_sig[i] nodes
    that hold the region's endpoints i, i + 1."""
    per_region = []
    for i, sub in enumerate(subnp_sig):
        others = [k for k in range(np_) if k not in (i, i + 1)]
        per_region.append([tuple(sorted((i, i + 1) + extra))
                           for extra in itertools.combinations(others,
                                                               sub - 2)])
    return per_region


def enumerate_nodal_candidates(np_: int, subnp_sig):
    """Every nodal-subset basis with the region signature `subnp_sig`;
    yields subset tuples."""
    return itertools.product(*_nodal_subsets(np_, subnp_sig))


def evaluate_nodal_candidate(np_: int, subsets, stab_ne: int = 96,
                             stab_ndx: int = 24, tol: float = 1e-9,
                             pum_kw=None):
    """Stability (Bloch), weight positivity, the accuracy metrics and the
    PUM of one nodal-subset basis; None if it is unstable or has a
    nonpositive weight."""
    b = NodalSubsetBasis(np_, subsets)
    if np.any(b.w <= 0):
        return None
    lam = bloch_max_eig_amp(b, ne=stab_ne, ndx=stab_ndx)
    if lam > 1 + tol:
        return None
    a1, a2, ainf = calc_xnodes_metrics(np.asarray(b.x), subsets)
    pum = pum_metric(b, **(pum_kw or dict(ne=4, n_mesh=3, ndx=8)))
    return dict(subsets=subsets, meam1=max(lam - 1.0, 0.0),
                a1=a1, a2=a2, ainf=ainf, pum=max(pum - 1.0, 0.0))


def search_nodal_given_bestosn(np_: int, ne: int = 5, ndx: int = 24,
                               tol: float = 1e-9, max_eval: int = 20000,
                               verbose: bool = True):
    """The two-stage Islet basis search: the stable offset-nodal
    configurations and the best one's subnp signature, then the general
    nodal subsets of that signature, filtered by stability, positive
    weights and the PUM metric and ranked by a_1. Returns (osn_results,
    nodal_results), the latter dicts {subsets, meam1, wpos, a1, a2, ainf,
    pum}, best first."""
    osn = search_offset_nodal(np_, ne=ne, ndx=ndx, tol=tol)
    if not osn:
        return [], []
    subnp_sig = [sub for (_, sub) in osn[0][0]]
    if verbose:
        print(f"np {np_:3d}")
        for (regions, lam, acc) in osn[:4]:
            subnp = " ".join(str(s) for (_, s) in regions)
            offst = " ".join(str(o) for (o, _) in regions)
            print(f"meam1 {max(lam - 1, 0):.1e} | np {np_:3d} "
                  f"subnp {subnp} offst {offst}")
    per_region = _nodal_subsets(np_, subnp_sig)
    results = []
    count = 0
    total = int(np.prod([len(o) for o in per_region]))
    for subsets in itertools.product(*per_region):
        count += 1
        if count > max_eval:
            break
        b = NodalSubsetBasis(np_, subsets)
        if np.any(b.w <= 0):
            continue
        a1, a2, ainf = calc_xnodes_metrics(np.asarray(b.x), subsets)
        try:
            lam = MaxEigComputer(b).max_eig_amp(ne, ndx)
        except np.linalg.LinAlgError:
            continue
        if lam > 1 + tol:
            continue
        pum = pum_metric(b, ne=min(ne, 4), n_mesh=3, ndx=8)
        if pum > 1 + 1e-6:
            continue
        results.append(dict(subsets=subsets, meam1=max(lam - 1.0, 0.0),
                            wpos=True, a1=a1, a2=a2, ainf=ainf,
                            pum=max(pum - 1.0, 0.0)))
    results.sort(key=lambda r: r["a1"])
    if verbose:
        print(f"count {total}")
        print(f"NsbSearchAtom::eval {min(count, max_eval)}/{total}")
        for r in results[:8]:
            nodes = " | ".join(" ".join(str(n) for n in s)
                               for s in r["subsets"])
            subnp = " ".join(str(len(s)) for s in r["subsets"])
            print(f"meam1 {r['meam1']:9.2e} w>0 1 npm {r['a1']:.2e} "
                  f"{r['a2']:.2e} {r['ainf']:.2e} pum {r['pum']:9.2e} | "
                  f"np {np_:3d} subnp {subnp} nodes | {nodes}")
    return osn, results
