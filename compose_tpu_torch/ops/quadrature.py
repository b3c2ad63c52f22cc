"""Triangle quadrature rules (compose_tpu.ops.quadrature).

``get_coef(order)`` returns barycentric points (nq, 3) and weights (nq,)
with sum(w) == 1, used as integral ~= 0.5 * sum_q w_q f(x_q) J(x_q). The
published orders 4, 6, 8, 12, 14, 16, 18 and 20 come from the tables in
``quadrature_tables``; any other order falls back to a Duffy
(collapsed-coordinate) tensor-product Gauss-Legendre rule of that
exactness.
"""

import functools

import numpy as np

from . import quadrature_tables as _qt


@functools.lru_cache(maxsize=None)
def get_coef(order: int):
    """Return (bary, w): barycentric points (nq, 3) and weights summing to
    1, exact up to roundoff for polynomials of total degree <= order."""
    if order in _qt.COORD:
        bary = np.asarray(_qt.COORD[order], dtype=np.float64).reshape(-1, 3)
        return bary, np.asarray(_qt.WEIGHT[order], dtype=np.float64)
    # The Duffy map a1 = u, a2 = v (1 - u) has Jacobian (1 - u): a Gauss
    # rule of n points per axis with n = ceil((order + 2) / 2).
    n = (order + 3) // 2
    xu, wu = np.polynomial.legendre.leggauss(n)
    xu = 0.5 * (xu + 1.0)
    wu = 0.5 * wu
    u = xu[:, None] * np.ones_like(xu)[None, :]
    v = np.ones_like(xu)[:, None] * xu[None, :]
    w = (wu[:, None] * wu[None, :]) * (1.0 - u)
    a1 = u
    a2 = v * (1.0 - u)
    a3 = 1.0 - a1 - a2
    bary = np.stack([a1.ravel(), a2.ravel(), a3.ravel()], axis=-1)
    return bary, 2.0 * w.ravel()
