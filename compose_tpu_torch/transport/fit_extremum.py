"""Quadratic sub-grid extremum reconstruction, the `-fitext` bound
relaxation (compose_tpu.transport.fit_extremum).

Fit a biquadratic m(x, y) (9 terms) and per-edge 1-D quadratics to a cell's
nodal values by L2 projection; where the fits are good (relative error
below np-scaled thresholds), locate their critical points and use the
extremal values to relax the cell's q bounds. Vectorized over all cells,
with a fixed 5-step Newton for the interior critical point. As in the JAX
package, the 2-D relative error removes the constant term coef[8].
"""

import numpy as np
import torch

from .. import basis as basis_mod

_MAX_RELERR_1D_NP6 = 0.025
_MAX_RELERR_2D_NP6 = 0.025


def _eval_2d_basis(k, x, y):
    return [x * x * y * y, x * x * y, x * y * y, x * x, x * y, y * y,
            x, y, np.ones_like(x)][k]


class FitExtremum:
    def __init__(self, np_: int):
        self.np_ = np_
        self.max_relerr_1d = (np_ / 6.0) * _MAX_RELERR_1D_NP6
        self.max_relerr_2d = (np_ * np_ / 36.0) * _MAX_RELERR_2D_NP6
        gll = basis_mod.GLL(np_)
        self.gx, self.gw = gll.x, gll.w

        # 2-D projection matrices over [-1,1]^2 (Gauss product rule, exact).
        qx, qw = np.polynomial.legendre.leggauss(np_ + 4)
        X, Y = np.meshgrid(qx, qx, indexing="ij")
        W = np.outer(qw, qw)
        B = np.stack([_eval_2d_basis(k, X, Y) for k in range(9)])
        Mtgt = np.einsum('aij,bij,ij->ab', B, B, W)
        gl = basis_mod._lagrange_eval(gll.x, torch.tensor(qx)).numpy()
        # GLL node c = i*np + j carries phi_j(x) phi_i(y).
        phi = np.zeros((np_ * np_, len(qx), len(qx)))
        for i in range(np_):
            for j in range(np_):
                phi[i * np_ + j] = gl[:, j][:, None] * gl[:, i][None, :]
        Mmix = np.einsum('aij,cij,ij->ac', B, phi, W)
        self.P2 = torch.tensor(np.linalg.solve(Mtgt, Mmix))   # (9, np2)

        # 1-D quadratic projection via 12-point GLL quadrature.
        q1x, q1w = basis_mod.gll_nodes_weights(12)
        g1 = basis_mod._lagrange_eval(gll.x, torch.tensor(q1x)).numpy()
        B1 = np.stack([q1x ** 2, q1x, np.ones_like(q1x)])
        Mt1 = np.einsum('aq,bq,q->ab', B1, B1, q1w)
        Mm1 = np.einsum('aq,qc,q->ac', B1, g1, q1w)
        self.P1 = torch.tensor(np.linalg.solve(Mt1, Mm1))     # (3, np)

    @staticmethod
    def _eval2(c, x, y):
        x2, y2 = x * x, y * y
        return (c[..., 0] * x2 * y2 + c[..., 1] * x2 * y
                + c[..., 2] * x * y2 + c[..., 3] * x2 + c[..., 4] * x * y
                + c[..., 5] * y2 + c[..., 6] * x + c[..., 7] * y
                + c[..., 8])

    def calc(self, y_gll):
        """y_gll: (..., np2) nodal values. Returns (min, max, use), each of
        shape (...,)."""
        np_ = self.np_
        kw = dict(dtype=y_gll.dtype, device=y_gll.device)
        gx, gw = self.gx.to(**kw), self.gw.to(**kw)
        P1, P2 = self.P1.to(**kw), self.P2.to(**kw)
        shape = y_gll.shape[:-1]
        yv = y_gll.reshape(shape + (np_, np_))       # [i(y), j(x)]
        inf = float("inf")

        # 1-D edge fits: x = +1, y = +1, x = -1, y = -1.
        edges = torch.stack([yv[..., :, np_ - 1], yv[..., np_ - 1, :],
                             yv[..., :, 0], yv[..., 0, :]], dim=-2)
        c1 = torch.einsum('ac,...dc->...da', P1, edges)     # (..., 4, 3)
        a, b, c0 = c1[..., 0], c1[..., 1], c1[..., 2]
        fit_vals = a[..., None] * gx ** 2 + b[..., None] * gx + c0[..., None]
        g = edges - c0[..., None]
        f = fit_vals - c0[..., None]
        num = torch.sum(gw * (f - g) ** 2, -1)
        den = torch.sum(gw * g * g, -1)
        relerr1 = torch.sqrt(num / torch.where(den == 0, 1.0, den))
        relerr1 = torch.where(den == 0, 0.0, relerr1)
        xstar = -b / torch.where(a == 0, 1.0, 2 * a)
        ok1 = ((relerr1 <= self.max_relerr_1d) & (a != 0)
               & (torch.abs(xstar) <= 1.0))
        v1 = (a * xstar + b) * xstar + c0
        min1 = torch.amin(torch.where(ok1, v1, inf), -1)
        max1 = torch.amax(torch.where(ok1, v1, -inf), -1)
        use1 = torch.any(ok1, -1)

        # 2-D fit.
        c2 = torch.einsum('ac,...c->...a', P2, y_gll)       # (..., 9)
        X = gx[None, :] * torch.ones((np_, 1), **kw)        # [i(y), j(x)]
        Y = gx[:, None] * torch.ones((1, np_), **kw)
        fit2 = self._eval2(c2[..., None, None, :], X, Y)
        g2 = yv - c2[..., 8][..., None, None]
        f2 = fit2 - c2[..., 8][..., None, None]
        num2 = torch.sum(gw[:, None] * (f2 - g2) ** 2, (-2, -1))
        den2 = torch.sum(gw[:, None] * g2 * g2, (-2, -1))
        relerr2 = torch.sqrt(num2 / torch.where(den2 == 0, 1.0, den2))
        relerr2 = torch.where(den2 == 0, 0.0, relerr2)
        ok2 = relerr2 <= self.max_relerr_2d
        bounded = (torch.all(relerr1 <= self.max_relerr_1d, -1)
                   & (relerr2 <= self.max_relerr_2d))

        # Interior critical point: 5 Newton steps on grad m = 0.
        x = torch.zeros(shape, **kw)
        y = torch.zeros(shape, **kw)
        cc = c2
        for _ in range(5):
            gx_ = (2 * (cc[..., 0] * y * y + cc[..., 1] * y + cc[..., 3]) * x
                   + (cc[..., 2] * y * y + cc[..., 4] * y + cc[..., 6]))
            gy_ = (2 * (cc[..., 0] * x * x + cc[..., 2] * x + cc[..., 5]) * y
                   + (cc[..., 1] * x * x + cc[..., 4] * x + cc[..., 7]))
            H0 = 2 * (cc[..., 0] * y * y + cc[..., 1] * y + cc[..., 3])
            H1 = (4 * cc[..., 0] * x * y + 2 * (cc[..., 1] * x
                                                + cc[..., 2] * y)
                  + cc[..., 4])
            H2 = 2 * (cc[..., 0] * x * x + cc[..., 2] * x + cc[..., 5])
            det = H0 * H2 - H1 * H1
            det_s = torch.where(det == 0, 1.0, det)
            x = torch.where(det == 0, 2.0, x + (-H2 * gx_ + H1 * gy_) / det_s)
            y = torch.where(det == 0, 2.0, y + (H1 * gx_ - H0 * gy_) / det_s)
        inb = (torch.abs(x) <= 1.0) & (torch.abs(y) <= 1.0)
        use2 = ok2 & inb
        v2 = self._eval2(c2, x, y)

        mn = torch.where(use1, min1, inf)
        mn = torch.where(use2, torch.minimum(mn, v2), mn)
        mx = torch.where(use1, max1, -inf)
        mx = torch.where(use2, torch.maximum(mx, v2), mx)
        use = bounded & (use1 | use2)
        return (torch.where(use, mn, 0.0), torch.where(use, mx, 0.0), use)
