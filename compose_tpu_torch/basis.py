"""Nodal bases on [-1, 1]: GLL and the stabilized Islet bases
(compose_tpu.basis).

Every family and np that `compose_tpu.basis.create` builds: GLL at any np;
the Islet GllNodal and GllOffsetNodal bases (np 2-13 and 16), the
UniformOffsetNodal and FreeNodal bases, UniformReduced and ConstantCell,
and the string-defined bases (GllNodalFromString, FreeNodalFromString).
GLL nodes and weights are computed by a Newton solve on the Legendre
derivative, in numpy, exactly as the JAX package computes them; the Islet
weights, node windows and free nodes are offline-derived data, copied
here. Evaluation runs in the query tensor's dtype, so an f32 geometry
pipeline stays f32.
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


def _f64(a):
    return torch.tensor(np.asarray(a, dtype=np.float64), dtype=torch.float64)


class GLL:
    """Standard GLL nodal basis."""

    name = "Gll"

    def __init__(self, np_: int):
        self.np = np_
        x, w = gll_nodes_weights(np_)
        self.x = _f64(x)
        self.w = _f64(w)

    def eval(self, x):
        """x (...,) -> basis values (..., np)."""
        return _lagrange_eval(self.x, x)

    def eval_deriv(self, x):
        return _lagrange_eval_derivative(self.x, x)


# ----------------------------------------------------------------------------
# Islet bases: offline-derived data (the JAX package's tables).

# Modified quadrature weights of islet::GllOffsetNodal.
_GLL_OFFSET_NODAL_W = {
    2: [1.0, 1.0],
    3: [1.0 / 3.0, 4.0 / 3.0, 1.0 / 3.0],
    4: [1.6666666666666666e-01, 8.3333333333333337e-01,
        8.3333333333333337e-01, 1.6666666666666666e-01],
    5: [7.2438673929622860e-02, 6.0875420527532442e-01,
        6.3761424159010549e-01, 6.0875420527532442e-01,
        7.2438673929622860e-02],
    6: [6.6666666666666624e-02, 3.7847495629784700e-01,
        5.5485837703548646e-01, 5.5485837703548646e-01,
        3.7847495629784700e-01, 6.6666666666666624e-02],
    7: [5.6454983633034334e-02, 2.5552182504453469e-01,
        4.5835116513528573e-01, 4.5934405237429038e-01,
        4.5835116513528573e-01, 2.5552182504453469e-01,
        5.6454983633034334e-02],
    8: [4.3144193831569533e-02, 1.9497214769017937e-01,
        3.5470956393990549e-01, 4.0717409453834563e-01,
        4.0717409453834563e-01, 3.5470956393990549e-01,
        1.9497214769017937e-01, 4.3144193831569533e-02],
    9: [4.1812271854496312e-02, 1.3123902435694160e-01,
        3.1866016571917827e-01, 2.9686582599803263e-01,
        4.2284542414270215e-01, 2.9686582599803263e-01,
        3.1866016571917827e-01, 1.3123902435694160e-01,
        4.1812271854496312e-02],
    10: [1.5509733280217758e-02, 1.4842357596604355e-01,
         2.0911374516621034e-01, 3.0367249606634206e-01,
         3.2328044952118629e-01, 3.2328044952118629e-01,
         3.0367249606634206e-01, 2.0911374516621034e-01,
         1.4842357596604355e-01, 1.5509733280217758e-02],
    11: [1.4115415593113077e-02, 1.1746481483677482e-01,
         1.8251645617210899e-01, 2.4597010811609454e-01,
         2.9538296815410536e-01, 2.8910047425560659e-01,
         2.9538296815410536e-01, 2.4597010811609454e-01,
         1.8251645617210899e-01, 1.1746481483677482e-01,
         1.4115415593113077e-02],
    12: [9.2548354381213702e-03, 1.0539058985971034e-01,
         1.4237539955323250e-01, 2.2648452767205887e-01,
         2.4168148450452953e-01, 2.7481316297234754e-01,
         2.7481316297234754e-01, 2.4168148450452953e-01,
         2.2648452767205887e-01, 1.4237539955323250e-01,
         1.0539058985971034e-01, 9.2548354381213702e-03],
    13: [1.5986387115823793e-02, 7.1039463009726772e-02,
         1.4100673941822789e-01, 1.8090611106261884e-01,
         2.1922209886060423e-01, 2.4908449372434635e-01,
         2.4550941361730400e-01, 2.4908449372434635e-01,
         2.1922209886060423e-01, 1.8090611106261884e-01,
         1.4100673941822789e-01, 7.1039463009726772e-02,
         1.5986387115823793e-02],
    16: [6.6054381853532362e-03, 5.4731980471730592e-02,
         8.5313396530798766e-02, 1.2750075018473614e-01,
         1.5206243160880162e-01, 1.7830331300698002e-01,
         1.9354559587015541e-01, 2.0193709414144417e-01,
         2.0193709414144417e-01, 1.9354559587015541e-01,
         1.7830331300698002e-01, 1.5206243160880162e-01,
         1.2750075018473614e-01, 8.5313396530798766e-02,
         5.4731980471730592e-02, 6.6054381853532362e-03],
}

# islet::GllOffsetNodal regions: per left-half region i ([x_i, x_{i+1}],
# x <= 0) a contiguous node window (offset, subnp).
_GLL_OFFSET_REGIONS = {
    5: [(0, 3), (0, 4)],
    6: [(0, 6), (0, 5)],
    7: [(0, 5), (0, 5), (0, 6)],
    8: [(0, 6), (0, 6), (0, 7), (1, 6)],
    9: [(0, 7), (0, 8), (0, 7), (1, 7)],
    10: [(0, 7), (0, 7), (0, 7), (0, 8), (1, 8)],
    11: [(0, 8), (0, 9), (0, 8), (0, 9), (1, 8)],
    12: [(0, 9), (0, 9), (0, 10), (0, 10), (1, 9), (1, 10)],
    13: [(0, 10), (0, 10), (0, 10), (0, 10), (0, 11), (1, 10)],
    16: [(0, 12), (0, 13), (0, 13), (0, 13), (0, 13), (0, 14), (1, 13),
         (2, 12)],
}

# Modified quadrature weights of islet::GllNodal where they differ.
_GLL_NODAL_W = {
    2: [1.0, 1.0],
    3: [1.0 / 3.0, 4.0 / 3.0, 1.0 / 3.0],
    4: [1.6666666666666666e-01, 8.3333333333333337e-01,
        8.3333333333333337e-01, 1.6666666666666666e-01],
    5: [7.2438673929622860e-02, 6.0875420527532442e-01,
        6.3761424159010549e-01, 6.0875420527532442e-01,
        7.2438673929622860e-02],
    6: [6.6666666666666624e-02, 3.7847495629784705e-01,
        5.5485837703548646e-01, 5.5485837703548646e-01,
        3.7847495629784705e-01, 6.6666666666666624e-02],
    7: [5.6454983633034334e-02, 2.5552182504453469e-01,
        4.5835116513528573e-01, 4.5934405237429038e-01,
        4.5835116513528573e-01, 2.5552182504453469e-01,
        5.6454983633034334e-02],
    8: [4.3144193831569533e-02, 1.9497214769017937e-01,
        3.5470956393990549e-01, 4.0717409453834563e-01,
        4.0717409453834563e-01, 3.5470956393990549e-01,
        1.9497214769017937e-01, 4.3144193831569533e-02],
    9: [3.6046050775536347e-02, 1.4531360464413259e-01,
        3.0053239765036854e-01, 3.1722918197442412e-01,
        4.0175752991107733e-01, 3.1722918197442412e-01,
        3.0053239765036854e-01, 1.4531360464413259e-01,
        3.6046050775536347e-02],
}

# Explicit (non-contiguous) node subsets of islet::GllNodal at np 6 and 9.
_GLL_NODAL_SUBSETS = {
    6: [[0, 1, 2, 3, 4], [0, 1, 2, 3, 5], [0, 1, 2, 3, 4, 5]],
    9: [[0, 1, 2, 3, 4, 5, 8], [0, 1, 2, 3, 4, 5, 7, 8],
        [0, 1, 2, 3, 4, 5, 6, 8], [1, 2, 3, 4, 5, 6, 7]],
}

# islet::UniformOffsetNodal: uniform nodes, contiguous windows, weights.
_UNIFORM_OFFSET_W = {
    2: [1.0, 1.0],
    3: [1.0 / 3.0, 4.0 / 3.0, 1.0 / 3.0],
    4: [2.4999999999999992e-01, 7.5e-01, 7.5e-01, 2.4999999999999992e-01],
    5: [1.8750000000000006e-01, 5.8333333333333337e-01,
        4.5833333333333343e-01, 5.8333333333333337e-01,
        1.8750000000000006e-01],
    6: [1.5305555555555561e-01, 4.5750000000000002e-01,
        3.8944444444444448e-01, 3.8944444444444448e-01,
        4.5750000000000002e-01, 1.5305555555555561e-01],
    7: [1.2754629629629630e-01, 3.8379629629629636e-01,
        3.1689814814814821e-01, 3.4351851851851856e-01,
        3.1689814814814821e-01, 3.8379629629629636e-01,
        1.2754629629629630e-01],
    8: [9.5238095238095247e-02, 3.6904761904761907e-01,
        2.3809523809523803e-01, 2.9761904761904762e-01,
        2.9761904761904762e-01, 2.3809523809523803e-01,
        3.6904761904761907e-01, 9.5238095238095247e-02],
    9: [8.3333333333333329e-02, 3.2291666666666669e-01,
        2.0833333333333337e-01, 2.6041666666666669e-01,
        2.5000000000000006e-01, 2.6041666666666669e-01,
        2.0833333333333337e-01, 3.2291666666666669e-01,
        8.3333333333333329e-02],
    10: [7.7469135802469141e-02, 2.7345679012345675e-01,
         2.0555555555555555e-01, 2.1790123456790123e-01,
         2.2561728395061736e-01, 2.2561728395061736e-01,
         2.1790123456790123e-01, 2.0555555555555555e-01,
         2.7345679012345675e-01, 7.7469135802469141e-02],
    11: [6.9722222222222227e-02, 2.4611111111111111e-01,
         1.8500000000000008e-01, 1.9611111111111118e-01,
         2.0305555555555560e-01, 1.9999999999999998e-01,
         2.0305555555555560e-01, 1.9611111111111118e-01,
         1.8500000000000008e-01, 2.4611111111111111e-01,
         6.9722222222222227e-02],
    12: [6.3383838383838390e-02, 2.2651515151515156e-01,
         1.5707070707070694e-01, 1.9494949494949498e-01,
         1.7348484848484846e-01, 1.8459595959595959e-01,
         1.8459595959595959e-01, 1.7348484848484846e-01,
         1.9494949494949498e-01, 1.5707070707070694e-01,
         2.2651515151515156e-01, 6.3383838383838390e-02],
    13: [5.9374999999999990e-02, 2.0127314814814809e-01,
         1.5671296296296305e-01, 1.6597222222222227e-01,
         1.6539351851851855e-01, 1.6793981481481482e-01,
         1.6666666666666663e-01, 1.6793981481481482e-01,
         1.6539351851851855e-01, 1.6597222222222227e-01,
         1.5671296296296305e-01, 2.0127314814814809e-01,
         5.9374999999999990e-02],
}
_UNIFORM_OFFSET_REGIONS = {
    4: [(0, 3), (0, 4)],
    5: [(0, 3), (0, 4)],
    6: [(0, 3), (0, 4), (0, 6)],
    7: [(0, 3), (0, 4), (1, 4)],
    8: [(0, 4), (0, 4), (1, 4), (2, 4)],
    9: [(0, 4), (0, 4), (1, 4), (2, 4)],
    10: [(0, 4), (0, 4), (1, 4), (2, 4), (3, 4)],
    11: [(0, 4), (0, 4), (1, 4), (2, 4), (3, 4)],
    12: [(0, 4), (0, 4), (1, 4), (2, 4), (3, 4), (4, 4)],
    13: [(0, 4), (0, 4), (1, 4), (2, 4), (3, 4), (4, 4)],
}

# islet::FreeNodal: freely placed nodes, their weights and node subsets.
_FREE_NODAL_X = {
    4: [-1, -4.4721359549995793e-01, 4.4721359549995793e-01, 1],
    5: [-1, -6.6678658540509828e-01, 0, 6.6678658540509828e-01, 1],
    6: [-1, -7.6692663677851514e-01, -3.0080515728048823e-01,
        3.0080515728048823e-01, 7.6692663677851514e-01, 1],
    7: [-1, -9.0990710644769845e-01, -5.2121920370139296e-01, 0,
        5.2121920370139296e-01, 9.0990710644769845e-01, 1],
    8: [-1, -8.5140924689985531e-01, -6.8076136583943381e-01,
        -3.3295319583926342e-01, 3.3295319583926342e-01,
        6.8076136583943381e-01, 8.5140924689985531e-01, 1],
    10: [-1, -9.1953390816645886e-01, -7.3979280618087628e-01,
         -5.5608644784645889e-01, -2.3500601793189407e-01,
         2.3500601793189407e-01, 5.5608644784645889e-01,
         7.3979280618087628e-01, 9.1953390816645886e-01, 1],
}
_FREE_NODAL_W = {
    4: [1.6666666666666666e-01, 8.3333333333333326e-01,
        8.3333333333333326e-01, 1.6666666666666666e-01],
    5: [4.9870438822580979e-02, 6.3756212508301224e-01,
        6.2513487218881347e-01, 6.3756212508301224e-01,
        4.9870438822580979e-02],
    6: [7.2085444326295170e-02, 3.5621719740552549e-01,
        5.7169735826817936e-01, 5.7169735826817936e-01,
        3.5621719740552549e-01, 7.2085444326295170e-02],
    7: [6.5052894249013657e-02, 1.3476067847565915e-01,
        5.7683298128860117e-01, 4.4670689197345193e-01,
        5.7683298128860117e-01, 1.3476067847565915e-01,
        6.5052894249013657e-02],
    8: [1.2725008869179433e-02, 3.3555941579644766e-01,
        1.4505431324948675e-02, 6.3721014400942422e-01,
        6.3721014400942422e-01, 1.4505431324948675e-02,
        3.3555941579644766e-01, 1.2725008869179433e-02],
    10: [2.8881226543594377e-02, 1.1714238963320928e-01,
         2.3127422749964027e-01, 1.7494931493842375e-01,
         4.4775284138513227e-01, 4.4775284138513227e-01,
         1.7494931493842375e-01, 2.3127422749964027e-01,
         1.1714238963320928e-01, 2.8881226543594377e-02],
}
_FREE_NODAL_SUBSETS = {
    4: [[0, 1, 2], [0, 1, 2, 3]],
    5: [[0, 1, 2, 3], [0, 1, 2, 3]],
    6: [[0, 1, 2, 3, 4], [0, 1, 2, 3, 4], [0, 1, 2, 3, 4, 5]],
    7: [[0, 1, 2, 4, 5, 6], [0, 1, 2, 3, 4, 5, 6], [0, 1, 2, 3, 4, 5]],
    8: [[0, 1, 2, 3, 4, 5, 7], [0, 1, 2, 3, 4, 5, 6, 7],
        [0, 1, 2, 3, 4, 5, 6], [0, 1, 2, 3, 4, 5, 6, 7]],
    10: [[0, 1, 2, 3, 4, 5, 6, 7, 8], [0, 1, 2, 3, 4, 5, 7, 8, 9],
         [0, 1, 2, 3, 4, 5, 6, 7, 8, 9], [0, 1, 2, 3, 4, 5, 6, 7, 8],
         [0, 1, 2, 3, 4, 5, 6, 7, 8, 9]],
}


def _windows(regions):
    return [list(range(os, os + sub)) for (os, sub) in regions]


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


def _regionwise_eval(xn, subsets, x):
    """Region-wise sub-Lagrange evaluation with left-half symmetry: each
    left-half region [xn[i], xn[i+1]] interpolates through its node subset,
    evaluated at xm = -|x| and mirrored for x > 0."""
    n = xn.shape[0]
    xn = xn.to(dtype=x.dtype, device=x.device)
    xm = -torch.abs(x)
    nreg = len(subsets)
    vals = []
    for nodes in subsets:
        sub_v = _lagrange_eval(xn[nodes], xm)           # (..., len(nodes))
        full = torch.zeros(x.shape + (n,), dtype=x.dtype, device=x.device)
        full[..., nodes] = sub_v
        vals.append(full)
    vals = torch.stack(vals, dim=-2)                    # (..., nreg, np)
    # Region of xm: the smallest i with xm <= xn[i+1].
    r = torch.searchsorted(xn[1:nreg].contiguous(), xm.contiguous())
    v = torch.gather(vals, -2, r[..., None, None].expand(
        r.shape + (1, n)))[..., 0, :]
    return torch.where((x > 0)[..., None], torch.flip(v, (-1,)), v)


class IsletGllOffsetNodal(GLL):
    """islet::GllOffsetNodal: GLL nodes, modified weights, stabilized
    region-wise evaluation with contiguous node windows."""

    name = "GllOffsetNodal"

    def __init__(self, np_: int):
        super().__init__(np_)
        if np_ not in _GLL_OFFSET_NODAL_W:
            raise NotImplementedError(
                f"islet GllOffsetNodal np={np_} not tabulated")
        self.w = _f64(_GLL_OFFSET_NODAL_W[np_])

    def _subsets(self):
        return _windows(_GLL_OFFSET_REGIONS[self.np])

    def eval(self, x):
        if self.np <= 3:
            return _lagrange_eval(self.x, x)
        if self.np == 4:
            return _np4_subgrid_eval(self.x, x)
        return _regionwise_eval(self.x, self._subsets(), x)


def np4_subgrid_nodes(bas):
    """The nodes `bas.eval` hands to `_np4_subgrid_eval` (the Islet GLL
    bases at np 4), or None where its eval is another function."""
    if getattr(bas, "np", None) == 4 \
            and type(bas).eval is IsletGllOffsetNodal.eval:
        return bas.x
    return None


class IsletGllNodal(IsletGllOffsetNodal):
    """islet::GllNodal: GllOffsetNodal with free node subsets at np 6 and 9
    and its own weights. The default ISL basis."""

    name = "GllNodal"

    def __init__(self, np_: int):
        super().__init__(np_)
        if np_ in _GLL_NODAL_W:
            self.w = _f64(_GLL_NODAL_W[np_])

    def _subsets(self):
        if self.np in _GLL_NODAL_SUBSETS:
            return _GLL_NODAL_SUBSETS[self.np]
        return super()._subsets()


class IsletUniformOffsetNodal(GLL):
    """islet::UniformOffsetNodal: uniform nodes, offset sub-polynomials."""

    name = "UniformOffsetNodal"

    def __init__(self, np_: int):
        if np_ not in _UNIFORM_OFFSET_W:
            raise NotImplementedError(f"UniformOffsetNodal np={np_}")
        self.np = np_
        self.x = _f64(np.linspace(-1.0, 1.0, np_))
        self.w = _f64(_UNIFORM_OFFSET_W[np_])

    def eval(self, x):
        if self.np <= 3:
            return _lagrange_eval(self.x, x)
        return _regionwise_eval(
            self.x, _windows(_UNIFORM_OFFSET_REGIONS[self.np]), x)


class IsletFreeNodal(GLL):
    """islet::FreeNodal: freely placed stabilized nodes."""

    name = "FreeNodal"

    def __init__(self, np_: int):
        if np_ not in _FREE_NODAL_X:
            raise NotImplementedError(f"FreeNodal np={np_}")
        self.np = np_
        self.x = _f64(_FREE_NODAL_X[np_])
        self.w = _f64(_FREE_NODAL_W[np_])

    def eval(self, x):
        return _regionwise_eval(self.x, _FREE_NODAL_SUBSETS[self.np], x)


def compute_weights(bas):
    """Basis::compute_weights: integrate each basis function per nodal
    region with 10-node GLL quadrature (exact to degree 17), then
    symmetrize. Returns (np,) numpy weights."""
    xn = bas.x.numpy()
    n = xn.shape[0]
    qx, qw = gll_nodes_weights(10)
    integral = np.zeros(n)
    for ireg in range(n - 1):
        alpha = 0.5 * (qx + 1.0)
        xs = (1 - alpha) * xn[ireg] + alpha * xn[ireg + 1]
        v = bas.eval(_f64(xs)).numpy()                  # (10, np)
        integral += 0.5 * (xn[ireg + 1] - xn[ireg]) * (qw[:, None] * v).sum(0)
    for i in range(n // 2):
        integral[i] = integral[n - i - 1] = \
            0.5 * (integral[i] + integral[n - i - 1])
    return integral


class UniformReduced:
    """slmm::UniformNodeReduced: uniform nodes, piecewise-linear
    region-wise evaluation, weights from compute_weights."""

    name = "UniformReduced"

    def __init__(self, np_: int):
        if np_ > 13 and np_ != 16:
            raise NotImplementedError(f"UniformReduced np={np_}")
        self.np = np_
        self.x = _f64(np.linspace(-1.0, 1.0, np_))
        self.w = _f64(compute_weights(self))

    def eval(self, x):
        subsets = [[i, i + 1] for i in range(self.np // 2)]
        return _regionwise_eval(self.x, subsets, x)


class ConstantCell:
    """Basis::Type::constant_cell: uniform nodes, one-hot evaluation by the
    nearest subinterval."""

    name = "ConstantCell"

    def __init__(self, np_: int):
        self.np = np_
        self.x = _f64(np.linspace(-1.0, 1.0, np_))
        self.w = _f64(compute_weights(self))

    def eval(self, x):
        xn = np.linspace(-1.0, 1.0, self.np)
        mid = torch.tensor(0.5 * (xn[1:] + xn[:-1]), dtype=x.dtype,
                           device=x.device)
        r = torch.searchsorted(mid, x.contiguous())
        return (r[..., None] == torch.arange(self.np, device=x.device)).to(
            x.dtype)


class GllNodalFromString(GLL):
    """islet::GllNodalFromString: a region-wise nodal-subset basis over the
    GLL nodes from a basis string; weights from compute_weights."""

    def __init__(self, np_: int, subsets):
        super().__init__(np_)
        self.name = "GllNodalFromString"
        self._subsets = subsets
        self.w = _f64(compute_weights(self))

    def eval(self, x):
        return _regionwise_eval(self.x, self._subsets, x)


class FreeNodalFromString(GLL):
    """islet::FreeNodalFromString: a region-wise nodal-subset basis over
    freely placed nodes (the string's trailing "x c0 c1 ..."); weights from
    compute_weights."""

    def __init__(self, np_: int, subsets, xnodes):
        self.np = np_
        self.name = "FreeNodalFromString"
        if len(xnodes) != np_:
            raise ValueError(f"basis string needs {np_} x-nodes, got "
                             f"{len(xnodes)}")
        x = np.asarray(xnodes, dtype=np.float64)
        if np.any(np.diff(x) <= 0) or x[0] != -1.0 or x[-1] != 1.0:
            raise ValueError("x-nodes must strictly increase from -1 to 1")
        self.x = _f64(x)
        self._subsets = subsets
        self.w = _f64(compute_weights(self))

    def eval(self, x):
        return _regionwise_eval(self.x, self._subsets, x)


def parse_basis_string(s: str):
    """Parse the basis-string format "np 1 | 0 subnp: n0 n1 .. | 1 subnp:
    .." (one group per left-half region), optionally followed by "x c0 c1
    ..." free node coordinates. Returns (np, subsets, xnodes-or-None)."""
    xnodes = None
    if "x" in s:
        s, _, tail = s.partition("x")
        xnodes = [float(v) for v in tail.split()]
    head, *regions = s.split("|")
    vals = head.split()
    np_, include_bdy = int(vals[0]), int(vals[1])
    if include_bdy != 1:
        raise ValueError("include_bdy=0 strings are not supported")
    nh = np_ // 2
    if len(regions) != nh:
        raise ValueError(f"basis string needs {nh} regions, got "
                         f"{len(regions)}")
    subsets = []
    for ni, reg in enumerate(regions):
        pre, nodes_s = reg.split(":")
        ni_chk, subnp = (int(v) for v in pre.split())
        if ni_chk != ni:
            raise ValueError(f"region {ni} labeled {ni_chk}")
        nodes = [int(v) for v in nodes_s.split()]
        if len(nodes) != subnp:
            raise ValueError(f"region {ni}: expected {subnp} nodes")
        if subnp < 2 or any(b <= a for a, b in zip(nodes, nodes[1:])):
            raise ValueError(f"region {ni}: nodes must strictly increase")
        if sum(1 for v in nodes if v in (ni, ni + 1)) != 2:
            raise ValueError(f"region {ni}: must contain nodes "
                             f"{ni} and {ni + 1}")
        subsets.append(nodes)
    return np_, subsets, xnodes


_BASIS_REGISTRY = {
    "gll": GLL, "Gll": GLL,
    "gllnodal": IsletGllNodal, "GllNodal": IsletGllNodal,
    "glloffsetnodal": IsletGllOffsetNodal,
    "GllOffsetNodal": IsletGllOffsetNodal,
    "uniformoffsetnodal": IsletUniformOffsetNodal,
    "UniformOffsetNodal": IsletUniformOffsetNodal,
    "freenodal": IsletFreeNodal, "FreeNodal": IsletFreeNodal,
    "uniform_reduced": UniformReduced, "UniformReduced": UniformReduced,
    "uniformreduced": UniformReduced,
    "constant_cell": ConstantCell, "ConstantCell": ConstantCell,
    "constantcell": ConstantCell,
}


def create(name: str, np_: int):
    """Basis factory: known names dispatch to the registry; a name holding
    '|' is parsed as a string-defined basis."""
    if "|" in name:
        np_s, subsets, xnodes = parse_basis_string(name)
        if np_s != np_:
            raise ValueError(f"basis string np={np_s} but mesh np={np_}")
        if xnodes is not None:
            return FreeNodalFromString(np_, subsets, xnodes)
        return GllNodalFromString(np_, subsets)
    key = name if name in _BASIS_REGISTRY else name.lower()
    if key not in _BASIS_REGISTRY:
        raise ValueError(f"unknown basis '{name}'")
    return _BASIS_REGISTRY[key](np_)
