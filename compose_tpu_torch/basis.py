"""Nodal bases on [-1, 1]: GLL and the stabilized Islet GllNodal basis
(compose_tpu.basis).

Only np4 Islet evaluation is carried (the ISL default, `create("GllNodal",
4)`); plain GLL works at any np. GLL nodes and weights are computed by a
Newton solve on the Legendre derivative, in numpy, exactly as the JAX
package computes them. Evaluation runs in the query tensor's dtype, so an
f32 geometry pipeline stays f32.
"""

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def gll_nodes_weights(np_: int):
    """Gauss-Lobatto-Legendre nodes and weights on [-1, 1] (numpy)."""
    n = np_
    if n < 2:
        raise ValueError("np must be >= 2")
    x = -np.cos(np.pi * np.arange(n) / (n - 1))
    leg = np.polynomial.legendre
    cPn = np.zeros(n)
    cPn[-1] = 1.0
    dPn = leg.legder(cPn)
    d2Pn = leg.legder(dPn)
    if n > 2:
        for _ in range(100):
            xi = x[1:-1]
            dx = leg.legval(xi, dPn) / leg.legval(xi, d2Pn)
            x[1:-1] = xi - dx
            if np.max(np.abs(dx)) < 1e-16:
                break
    Pn = leg.legval(x, cPn)
    w = 2.0 / (n * (n - 1) * Pn * Pn)
    x = 0.5 * (x - x[::-1])
    w = 0.5 * (w + w[::-1])
    return x, w


def _prod_chain(t):
    """Product over the last axis as a left-to-right multiply chain."""
    acc = t[..., 0]
    for j in range(1, t.shape[-1]):
        acc = acc * t[..., j]
    return acc


def _lagrange_eval(xnodes, x):
    """Lagrange basis values at x (...,) -> (..., m), in x's dtype."""
    xn = xnodes.to(dtype=x.dtype, device=x.device)
    m = xn.shape[0]
    d = x[..., None] - xn
    v = []
    for i in range(m):
        num = _prod_chain(torch.cat([d[..., :i], d[..., i + 1:]], dim=-1))
        den = _prod_chain(torch.stack([xn[i] - xn[j] for j in range(m)
                                       if j != i]))
        v.append(num / den)
    return torch.stack(v, dim=-1)


def _lagrange_eval_derivative(xnodes, x):
    """Derivative of the Lagrange basis: (...,) -> (..., m)."""
    xn = xnodes.to(dtype=x.dtype, device=x.device)
    m = xn.shape[0]
    d = x[..., None] - xn
    out = []
    for i in range(m):
        den = _prod_chain(torch.stack([xn[i] - xn[j] for j in range(m)
                                       if j != i]))
        acc = torch.zeros_like(x)
        for k in range(m):
            if k == i:
                continue
            idx = [j for j in range(m) if j != i and j != k]
            if idx:
                term = _prod_chain(torch.stack([d[..., j] for j in idx],
                                               dim=-1))
            else:
                term = torch.ones_like(x)
            acc = acc + term
        out.append(acc / den)
    return torch.stack(out, dim=-1)


class GLL:
    """Standard GLL nodal basis."""

    name = "Gll"

    def __init__(self, np_: int):
        self.np = np_
        x, w = gll_nodes_weights(np_)
        self.x = torch.tensor(x, dtype=torch.float64)
        self.w = torch.tensor(w, dtype=torch.float64)

    def eval(self, x):
        """x (...,) -> basis values (..., np)."""
        return _lagrange_eval(self.x, x)

    def eval_deriv(self, x):
        return _lagrange_eval_derivative(self.x, x)


# Modified quadrature weights of islet::GllNodal at np4 (offline-derived
# data, the same constants as compose_tpu.basis._GLL_NODAL_W[4]).
_GLL_NODAL_W4 = [1.6666666666666666e-01, 8.3333333333333337e-01,
                 8.3333333333333337e-01, 1.6666666666666666e-01]


def _np4_subgrid_eval(xn, x):
    """Stabilized np4 eval: blend the full cubic with the one-sided
    quadratic in the outer regions."""
    c1 = 0.306
    xn = xn.to(dtype=x.dtype, device=x.device)
    y4 = _lagrange_eval(xn, x)
    yl3 = _lagrange_eval(xn[0:3], x)
    yr3 = _lagrange_eval(xn[1:4], x)
    zero = torch.zeros_like(x)
    yl = torch.stack([yl3[..., 0], yl3[..., 1], yl3[..., 2], zero], dim=-1)
    yr = torch.stack([zero, yr3[..., 0], yr3[..., 1], yr3[..., 2]], dim=-1)
    left = x < xn[1]
    right = x > xn[2]
    ysub = torch.where(left[..., None], yl, yr)
    x0 = 2 * (1 - torch.abs(x)) / (1 - xn[2]) - 1
    alpha = (c1 + (0.5 - c1) * x0) * (x0 + 1)
    yblend = alpha[..., None] * ysub + (1 - alpha[..., None]) * y4
    return torch.where((left | right)[..., None], yblend, y4)


class IsletGllNodal(GLL):
    """islet::GllNodal at np4: GLL nodes, modified weights, stabilized
    evaluation. The default ISL basis."""

    name = "GllNodal"

    def __init__(self, np_: int):
        if np_ != 4:
            raise NotImplementedError(f"IsletGllNodal np={np_}: only np4 is "
                                      "ported")
        super().__init__(np_)
        self.w = torch.tensor(_GLL_NODAL_W4, dtype=torch.float64)

    def eval(self, x):
        return _np4_subgrid_eval(self.x, x)


_BASIS_REGISTRY = {"gll": GLL, "Gll": GLL, "gllnodal": IsletGllNodal,
                   "GllNodal": IsletGllNodal}


def create(name: str, np_: int):
    """Basis factory for the ported bases (Gll, GllNodal)."""
    key = name if name in _BASIS_REGISTRY else name.lower()
    if key not in _BASIS_REGISTRY:
        raise NotImplementedError(f"basis '{name}' is not ported")
    return _BASIS_REGISTRY[key](np_)
