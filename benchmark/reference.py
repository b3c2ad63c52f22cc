"""The plain reference of the ISL transport step, for the benchmark's
comparison: plain PyTorch and NumPy, on whatever device its inputs are.

It works everything out again from the inputs the benchmark hands both
sides (the mesh size, the wind, the time step and the state): the
equiangular cubed-sphere mesh and its continuous numbering, the Homme
mass weights, the GllNodal np4 basis, the DoPri5 departure points, the
cell location and Newton inverse, the interpolation with the Jacobian
ratio, the density and tracer CDR (global CAAS or the QLT tree, the
cell-local CAAS or the mn2 QP, the positivity limiter) and the DSS. It
covers only what the benchmark's configurations use: a uniform, unrotated
mesh, pisl (rho_isl), dmc f, exact trajectories, filters caas | qlt,
limiters caas | mn2, f64 or f32 geometry and interpolation over an f64 or
f32 CDR.

The arithmetic is a frozen copy of the port's plain (CPU) code, operation
for operation, so that on one device the two differ only where the port
runs its CUDA kernels or orders a sum otherwise. It imports nothing of
the port, of JAX or of the JAX package.
"""

import dataclasses
import math

import numpy as np
import torch

F64 = torch.float64
F32 = torch.float32
EARTH_RADIUS_M = 6.37122e6
DAY_S = 86400.0
_NP_SCALAR = {F64: np.float64, F32: np.float32}
_EPS = 2.220446049250313e-16
_QUARTER_PI = float(0.25 * np.pi)


# ---------------------------------------------------------------------------
# Sums

def next_pow2(n):
    p = 1
    while p < n:
        p *= 2
    return p


def _pair_fold(x):
    while x.shape[-1] > 1:
        y = x.reshape(x.shape[:-1] + (x.shape[-1] // 2, 2))
        x = y[..., 0] + y[..., 1]
    return x[..., 0]


def bfb_sum(x, dim=-1):
    """Adjacent-pair binary-tree sum along `dim`, zero-padded to a power of
    two."""
    x = torch.movedim(x, dim, -1)
    n = x.shape[-1]
    p = next_pow2(n)
    if p != n:
        x = torch.nn.functional.pad(x, (0, p - n))
    return _pair_fold(x)


def bfb_sum_cells(x):
    np2 = x.shape[-1]
    if np2 & (np2 - 1):
        return bfb_sum(x.reshape(x.shape[:-2] + (-1,)))
    return bfb_sum(_pair_fold(x))


# ---------------------------------------------------------------------------
# Sphere and the quad <-> reference-square maps

def dot(a, b):
    return torch.sum(a * b, dim=-1)


def norm2(a):
    return dot(a, a)


def norm(a):
    return torch.sqrt(norm2(a))


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def normalize(a):
    return a / norm(a)[..., None]


def xyz2ll(p):
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    return torch.atan2(z, torch.sqrt(x * x + y * y)), torch.atan2(y, x)


def ll2xyz(lat, lon):
    coslat = torch.cos(lat)
    return torch.stack([torch.cos(lon) * coslat, torch.sin(lon) * coslat,
                        torch.sin(lat)], dim=-1)


def _shape_fns(a, b):
    qtr = 0.25
    return torch.stack([qtr * (1 - a) * (1 - b), qtr * (1 + a) * (1 - b),
                        qtr * (1 + a) * (1 + b), qtr * (1 - a) * (1 + b)],
                       dim=-1)


def _shape_fns_da(a, b):
    qtr = 0.25
    return torch.stack([-qtr * (1 - b), qtr * (1 - b), qtr * (1 + b),
                        -qtr * (1 + b)], dim=-1)


def _shape_fns_db(a, b):
    qtr = 0.25
    return torch.stack([-qtr * (1 - a), -qtr * (1 + a), qtr * (1 + a),
                        qtr * (1 - a)], dim=-1)


def _combine(N, corners):
    return torch.sum(N[..., :, None] * corners, dim=-2)


def _sphere_jacobian(corners, a, b):
    s = _combine(_shape_fns(a, b), corners)
    sa = _combine(_shape_fns_da(a, b), corners)
    sb = _combine(_shape_fns_db(a, b), corners)
    r2 = torch.clamp_min(norm2(s)[..., None], torch.finfo(s.dtype).tiny)
    r = torch.sqrt(r2)
    sa = (sa - s * (dot(s, sa)[..., None] / r2)) / r
    sb = (sb - s * (dot(s, sb)[..., None] / r2)) / r
    return s / r, sa, sb


def _solve_Jxr(sa, sb, r):
    tiny = torch.finfo(sa.dtype).tiny
    n1 = torch.clamp_min(norm(sa), tiny)
    q1 = sa / n1[..., None]
    alpha = dot(q1, sb)
    v2 = sb - alpha[..., None] * q1
    n2 = torch.clamp_min(norm(v2), tiny)
    q2 = v2 / n2[..., None]
    qtr1 = dot(q1, r)
    qtr2 = dot(q2, r)
    db = qtr2 / n2
    da = (qtr1 - alpha * db) / n1
    return da, db


def sphere_to_ref(corners, q, max_its, tol=None, a0=None, b0=None):
    """Masked Newton inverse of the normalized bilinear map, `max_its`
    iterations from (a0, b0)."""
    if tol is None:
        tol = 1e2 * torch.finfo(torch.float64).eps
    tol2 = tol * tol
    a, b = a0, b0
    lim = 1e3
    for _ in range(max_its):
        s, sa, sb = _sphere_jacobian(corners, a, b)
        r = s - q
        active = norm2(r) > tol2
        da, db = _solve_Jxr(sa, sb, r)
        a = torch.clamp(torch.where(active, a - da, a), -lim, lim)
        b = torch.clamp(torch.where(active, b - db, b), -lim, lim)
    return a, b


def bilinear_jacobian_norm(corners, a, b):
    _, sa, sb = _sphere_jacobian(corners, a, b)
    return norm(cross(sa, sb))


# ---------------------------------------------------------------------------
# GLL nodes and the GllNodal np4 basis

def gll_nodes_weights(n):
    """Gauss-Lobatto-Legendre nodes and weights on [-1, 1] (numpy)."""
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
    return 0.5 * (x - x[::-1]), 0.5 * (w + w[::-1])


def _prod_chain(t):
    acc = t[..., 0]
    for j in range(1, t.shape[-1]):
        acc = acc * t[..., j]
    return acc


def lagrange_eval(xnodes, x):
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


def lagrange_eval_derivative(xnodes, x):
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
            term = (_prod_chain(torch.stack([d[..., j] for j in idx], dim=-1))
                    if idx else torch.ones_like(x))
            acc = acc + term
        out.append(acc / den)
    return torch.stack(out, dim=-1)


def gllnodal4_eval(x):
    """The Islet GllNodal np4 basis: the cubic blended with the one-sided
    quadratic in the outer regions."""
    xn = torch.tensor(gll_nodes_weights(4)[0], dtype=x.dtype,
                      device=x.device)
    c1 = 0.306
    y4 = lagrange_eval(xn, x)
    yl3 = lagrange_eval(xn[0:3], x)
    yr3 = lagrange_eval(xn[1:4], x)
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


# ---------------------------------------------------------------------------
# The mesh

def _face_point(face, X, Y):
    O = np.ones_like(X)
    return np.stack({0: [X, -O, Y], 1: [O, X, Y], 2: [-X, O, Y],
                     3: [-O, -X, Y], 4: [X, Y, O], 5: [-X, Y, -O]}[face],
                    axis=-1)


def _face_key(face, gx2, gy2, N):
    O = np.full_like(gx2, N)
    return np.stack({0: (gx2, -O, gy2), 1: (O, gx2, gy2),
                     2: (-gx2, O, gy2), 3: (-O, -gx2, gy2),
                     4: (gx2, gy2, O), 5: (-gx2, gy2, -O)}[face], axis=-1)


@dataclasses.dataclass(frozen=True)
class Mesh:
    ne: int
    np_: int
    ncell: int
    cnn: int
    corners: torch.Tensor      # (ncell, 4, 3) f64
    dgll2cgll: torch.Tensor    # (ncell, np2) int64
    cgll_xyz: torch.Tensor     # (cnn, 3) f64
    c2d_idx: torch.Tensor      # (cnn, 4) int64
    c2d_mask: torch.Tensor     # (cnn, 4) bool
    jac_node: torch.Tensor     # (ncell, np2)
    F: torch.Tensor            # (ncell, np2) the Homme (GLL) mass weights

    @property
    def np2(self):
        return self.np_ * self.np_


def build_mesh(ne, np_=4, device="cpu", dtype=F64):
    """The equiangular cubed-sphere mesh: cell (face, iy, ix) has id
    face*ne^2 + iy*ne + ix, its nodes the normalized bilinear images of
    the GLL grid over its corners; the continuous numbering from exact
    integer cube keys."""
    ncell = 6 * ne * ne
    np2 = np_ * np_
    gx, gw = gll_nodes_weights(np_)
    i = np.arange(ne)
    Xe = np.tan(_QUARTER_PI * np.concatenate([-1.0 + 2.0 * i / ne, [1.0]]))
    corners = np.empty((6, ne, ne, 4, 3))
    XX0, YY0 = np.meshgrid(Xe[:-1], Xe[:-1], indexing='xy')
    XX1, YY1 = np.meshgrid(Xe[1:], Xe[1:], indexing='xy')
    for f in range(6):
        corners[f, :, :, 0] = _face_point(f, XX0, YY0)
        corners[f, :, :, 1] = _face_point(f, XX1, YY0)
        corners[f, :, :, 2] = _face_point(f, XX1, YY1)
        corners[f, :, :, 3] = _face_point(f, XX0, YY1)
    corners = corners.reshape(ncell, 4, 3)
    corners /= np.linalg.norm(corners, axis=-1, keepdims=True)
    A, B = np.meshgrid(gx, gx, indexing='xy')
    qtr = 0.25
    N = np.stack([qtr * (1 - A) * (1 - B), qtr * (1 + A) * (1 - B),
                  qtr * (1 + A) * (1 + B), qtr * (1 - A) * (1 + B)], axis=-1)
    nodes = np.einsum('jik,ckd->cjid', N, corners)
    nodes /= np.linalg.norm(nodes, axis=-1, keepdims=True)
    N_ = ne * (np_ - 1)
    f_idx, iy_idx, ix_idx = np.unravel_index(np.arange(ncell), (6, ne, ne))
    li = np.arange(np_)
    lat_i = ix_idx[:, None, None] * (np_ - 1) + li[None, None, :]
    lat_j = iy_idx[:, None, None] * (np_ - 1) + li[None, :, None]
    gx2 = (2 * lat_i - N_) * np.ones((1, np_, 1), dtype=np.int64)
    gy2 = (2 * lat_j - N_) * np.ones((1, 1, np_), dtype=np.int64)
    keys = np.empty((ncell, np_, np_, 3), dtype=np.int64)
    for f in range(6):
        sel = f_idx == f
        keys[sel] = _face_key(f, gx2[sel], gy2[sel], N_)
    _, first_idx, inverse = np.unique(keys.reshape(ncell * np2, 3), axis=0,
                                      return_index=True, return_inverse=True)
    inverse = inverse.reshape(-1)
    cnn = first_idx.shape[0]
    cgll_xyz = nodes.reshape(ncell * np2, 3)[first_idx]
    order = np.argsort(inverse, kind="stable")
    counts = np.bincount(inverse, minlength=cnn)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    c2d_idx = np.zeros((cnn, 4), np.int64)
    c2d_mask = np.zeros((cnn, 4), bool)
    for k in range(4):
        sel = counts > k
        c2d_idx[sel, k] = order[starts[sel] + k]
        c2d_mask[sel, k] = True
    c2d_idx[~c2d_mask] = np.repeat(c2d_idx[:, 0], 4).reshape(cnn, 4)[
        ~c2d_mask]
    tc = torch.tensor(corners, dtype=F64)
    jac = bilinear_jacobian_norm(
        tc[:, None, :, :], torch.tensor(A.ravel(), dtype=F64)[None, :],
        torch.tensor(B.ravel(), dtype=F64)[None, :]).numpy()
    F = jac * np.outer(gw, gw).ravel()[None, :]

    def t(a, dt=dtype):
        return torch.tensor(a, dtype=dt, device=device)

    return Mesh(ne=ne, np_=np_, ncell=ncell, cnn=cnn, corners=t(corners, F64),
                dgll2cgll=t(inverse.reshape(ncell, np2), torch.int64),
                cgll_xyz=t(cgll_xyz, F64), c2d_idx=t(c2d_idx, torch.int64),
                c2d_mask=t(c2d_mask, torch.bool), jac_node=t(jac), F=t(F))


def locate(ne, p):
    """Equiangular point location: (cell id, a0, b0), the in-cell
    reference coordinates' closed-form estimate."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    ax, ay, az = torch.abs(x), torch.abs(y), torch.abs(z)

    def pick(c, a, b):
        return torch.where(c, a, b)

    i64 = dict(dtype=torch.int64, device=p.device)
    one, two, three, four, five, zero = (torch.tensor(v, **i64)
                                         for v in (1, 2, 3, 4, 5, 0))
    face = pick(ax >= ay,
                pick(ax >= az, pick(x > 0, one, three),
                     pick(z > 0, four, five)),
                pick(ay >= az, pick(y > 0, two, zero),
                     pick(z > 0, four, five)))
    dmap = torch.stack([ay, ax, ay, ax, az, az], dim=-1)
    d = torch.gather(dmap, -1, face[..., None])[..., 0]
    fx = torch.where(face == 0, x / d,
         torch.where(face == 1, y / d,                           # noqa: E128
         torch.where(face == 2, -x / d,                          # noqa: E128
         torch.where(face == 3, -y / d,                          # noqa: E128
         torch.where(face == 4, x / d, -x / d)))))               # noqa: E128
    fy = torch.where(face >= 4, y / d, z / d)
    fx = torch.atan(fx) / _QUARTER_PI
    fy = torch.atan(fy) / _QUARTER_PI
    gx = 0.5 * (1 + fx) * ne
    gy = 0.5 * (1 + fy) * ne
    ix = torch.clamp(torch.floor(gx).to(torch.int64), 0, ne - 1)
    iy = torch.clamp(torch.floor(gy).to(torch.int64), 0, ne - 1)
    return (ne * ne * face + ne * iy + ix, 2.0 * (gx - ix) - 1.0,
            2.0 * (gy - iy) - 1.0)


# ---------------------------------------------------------------------------
# The divergent deformational flow (Nair and Lauritzen 2010; Lauritzen et
# al. 2012, case 4) and DoPri5

class DivergentWind:
    T = 12 * DAY_S

    def velocity(self, t, p):
        T = self.T
        X, Y, Z = p[..., 0], p[..., 1], p[..., 2]
        r = torch.sqrt(X * X + Y * Y + Z * Z)
        d = torch.sqrt(X * X + Y * Y)
        sinth = Z / r
        costh = d / r
        polar = d < torch.finfo(d.dtype).tiny
        d_s = torch.where(polar, 1.0, d)
        coslam = torch.where(polar, 1.0, X / d_s)
        sinlam = torch.where(polar, 0.0, Y / d_s)
        s = _NP_SCALAR[p.dtype]
        tt, Ts = s(t), s(T)
        c = s(s(s(2 * np.pi) * tt) / Ts)
        cc, sc = float(np.cos(c)), float(np.sin(c))
        cost = float(np.cos(s(s(s(np.pi) * tt) / Ts)))
        sinlp = sinlam * cc - coslam * sc
        coslp = coslam * cc + sinlam * sc
        costh2 = costh * costh
        sin2lat = 2 * sinth * costh
        v = 2.5 / T * sinlp * costh2 * costh * cost
        u = 1 / T * (-5 * (0.5 * (1 - coslp)) * sin2lat * costh2 * cost
                     + 2 * np.pi * costh)
        # Tangent (u east, v north) to cartesian, plus a radial term.
        w = (1.0 - r) / EARTH_RADIUS_M
        e_r = p / r[..., None]
        den = torch.sqrt(X * X + Y * Y)
        polar = den < torch.finfo(den.dtype).tiny
        den_s = torch.where(polar, 1.0, den)
        e_e = torch.stack([torch.where(polar, 0.0, -Y / den_s),
                           torch.where(polar, 1.0, X / den_s),
                           torch.zeros_like(Z)], dim=-1)
        e_n = cross(e_r, e_e)
        return u[..., None] * e_e + v[..., None] * e_n + w[..., None] * e_r


_C = (0.0, 1.0 / 5, 3.0 / 10, 4.0 / 5, 8.0 / 9, 1.0, 1.0)
_A = (
    (),
    (1.0 / 5,),
    (3.0 / 40, 9.0 / 40),
    (44.0 / 45, -56.0 / 15, 32.0 / 9),
    (19372.0 / 6561, -25360.0 / 2187, 64448.0 / 6561, -212.0 / 729),
    (9017.0 / 3168, -355.0 / 33, 46732.0 / 5247, 49.0 / 176,
     -5103.0 / 18656),
    (35.0 / 384, 0.0, 500.0 / 1113, 125.0 / 192, -2187.0 / 6784,
     11.0 / 84),
)
_B5 = (35.0 / 384, 0.0, 500.0 / 1113, 125.0 / 192, -2187.0 / 6784,
       11.0 / 84, 0.0)


def integrate(velocity, ts, tf, p, nsub):
    """Dormand-Prince 5(4) from ts to tf in `nsub` fixed substeps; the
    coefficients dt*a rounded in p's dtype."""
    dt = (tf - ts) / nsub
    s = _NP_SCALAR[p.dtype]
    for n in range(nsub):
        t0 = ts + n * dt
        dtl = s(dt)
        ks = []
        for i in range(7):
            pi = p
            for j, a in enumerate(_A[i]):
                pi = pi + float(s(dtl * s(a))) * ks[j]
            ks.append(velocity(t0 + _C[i] * dt, pi))
        out = p
        for b, k in zip(_B5, ks):
            if b != 0.0:
                out = out + float(s(dtl * s(b))) * k
        p = out
    return normalize(p)


# ---------------------------------------------------------------------------
# Initial conditions (Lauritzen et al. 2012's gaussian hills, cosine bells,
# slotted cylinders, and the smooth xyztrig)

_lon1, _lat1 = 5 * np.pi / 6, 0.0
_lon2, _lat2 = -5 * np.pi / 6, 0.0


def _ll2xyz_np(lat, lon):
    return np.array([np.cos(lon) * np.cos(lat), np.sin(lon) * np.cos(lat),
                     np.sin(lat)])


def _gcd(lat, lon, lat_c, lon_c):
    a = ll2xyz(lat, lon)
    b = ll2xyz(torch.full_like(lat, lat_c), torch.full_like(lon, lon_c))
    return torch.atan2(norm(cross(a, b)), dot(a, b))


def xyztrig(lat, lon):
    p = ll2xyz(lat, lon)
    return 0.5 * (1 + torch.sin(3 * p[..., 0]) * torch.sin(3 * p[..., 1])
                  * torch.sin(4 * p[..., 2]))


def gaussianhills(lat, lon):
    p = ll2xyz(lat, lon)
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    out = torch.zeros_like(lat)
    for c in (_ll2xyz_np(_lat1, _lon1), _ll2xyz_np(_lat2, _lon2)):
        r2 = (x - float(c[0])) ** 2 + (y - float(c[1])) ** 2 \
            + (z - float(c[2])) ** 2
        out = out + 0.95 * torch.exp(-5.0 * r2)
    return out


def cosinebells(lat, lon):
    r, b, c = 0.5, 0.1, 0.9
    r1 = _gcd(lat, lon, _lat1, _lon1)
    r2 = _gcd(lat, lon, _lat2, _lon2)

    def cb(ri):
        return 0.5 * (1 + torch.cos(np.pi * ri / r))

    h = torch.where(r1 < r, cb(r1), torch.where(r2 < r, cb(r2), 0.0))
    return b + c * h


def slottedcylinders(lat, lon):
    b, c, r = 0.1, 1.0, 0.5
    lon_thr = r / 6
    lat_thr = 5 * (r / 12)
    r1 = _gcd(lat, lon, _lat1, _lon1)
    r2 = _gcd(lat, lon, _lat2, _lon2)
    in1 = (r1 <= r) & ((torch.abs(lon - _lon1) >= lon_thr)
                       | ((torch.abs(lon - _lon1) < lon_thr)
                          & (lat - _lat1 < -lat_thr)))
    in2 = (r2 <= r) & ((torch.abs(lon - _lon2) >= lon_thr)
                       | ((torch.abs(lon - _lon2) < lon_thr)
                          & (lat - _lat2 > lat_thr)))
    return torch.where(in1 | in2, torch.full_like(lat, c),
                       torch.full_like(lat, b))


IC_FAMILIES = {"gaussianhills": gaussianhills, "cosinebells": cosinebells,
               "slottedcylinders": slottedcylinders, "xyztrig": xyztrig}


def rotation(u):
    """A rotation matrix from three numbers in [0, 1) (Shoemake's uniform
    quaternion), numpy f64."""
    u1, u2, u3 = u
    a, b = math.sqrt(1 - u1), math.sqrt(u1)
    t2, t3 = 2 * math.pi * u2, 2 * math.pi * u3
    w, x = a * math.sin(t2), a * math.cos(t2)
    y, z = b * math.sin(t3), b * math.cos(t3)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]])


def tracer_plan(seed, families, ntracer):
    """Each tracer's IC family and rotation from the seed. Every seed gives
    each family the same number of tracers (the list tiled to ntracer), in
    a seeded order, each centred at a seeded rotation."""
    rng = np.random.default_rng(seed)
    names = [families[i % len(families)] for i in range(ntracer)]
    order = rng.permutation(ntracer)
    rots = rng.random((ntracer, 3))
    return [(names[k], rotation(rots[i])) for i, k in enumerate(order)]


def initial_state(mesh, plan, dtype):
    """rho = 1 and the tracers of `plan` evaluated at the CGLL nodes and
    injected to the DGLL slots: (ncell, np2), (nt, ncell, np2)."""
    xyz = mesh.cgll_xyz
    d2c = mesh.dgll2cgll.reshape(-1)
    qs = []
    for name, R in plan:
        p = xyz @ torch.tensor(R.T, dtype=F64, device=xyz.device)
        lat, lon = xyz2ll(p)
        qs.append(IC_FAMILIES[name](lat, lon)[d2c].reshape(mesh.ncell,
                                                           mesh.np2))
    rho = torch.ones((mesh.ncell, mesh.np2), dtype=dtype, device=xyz.device)
    return rho, torch.stack(qs).to(dtype)


# ---------------------------------------------------------------------------
# The CDR

def glbl_caas(Q_min, Q_mass, Q_max, extra_mass):
    delta = torch.where(Q_mass < Q_min, Q_min - Q_mass,
                        torch.where(Q_mass > Q_max, Q_max - Q_mass, 0.0))
    m = extra_mass - bfb_sum(delta)
    msd = Q_mass + delta
    v_up = torch.where(Q_mass >= Q_max, 0.0, Q_max - msd)
    v_dn = torch.where(Q_mass <= Q_min, 0.0, msd - Q_min)
    v = torch.where((m > 0)[..., None], v_up, v_dn)
    vsum = bfb_sum(v)
    nz = vsum != 0
    fac = torch.where(nz, m / torch.where(nz, vsum, 1.0), 0.0)
    return msd + fac[..., None] * v


def _clip(x, lo, hi):
    return torch.minimum(torch.maximum(x, lo), hi)


def local_caas(a, b, xlo, xhi, y):
    x = _clip(y, xlo, xhi)
    dhi = xhi - x
    dlo = x - xlo
    dm = b - bfb_sum(a * x)
    up = dm > 0
    fac = torch.where(up, bfb_sum(a * dhi), bfb_sum(a * dlo))
    pos = fac > 0
    scale = torch.where(pos, dm / torch.where(pos, fac, 1.0), 0.0)
    x = x + scale[..., None] * torch.where(up[..., None], dhi, dlo)
    return _clip(x, xlo, xhi)


def calc_r_tol(b, a, y):
    ab = torch.maximum(torch.abs(b), torch.amax(torch.abs(a * y), dim=-1))
    return 1e1 * _EPS * ab


def solve_1eq_bc_qp(w, a, b, xlo, xhi, y, max_its=50):
    """min sum w (x - y)^2 s.t. a'x = b, xlo <= x <= xhi: bisection-
    safeguarded Newton on the multiplier, until every lane converges."""
    r_tol = calc_r_tol(b, a, y)
    r_lo = torch.sum(a * xlo, dim=-1) - b
    r_hi = torch.sum(a * xhi, dim=-1) - b
    lo_is_sol = torch.abs(r_lo) <= r_tol
    hi_is_sol = torch.abs(r_hi) <= r_tol
    infeas = (~lo_is_sol) & (~hi_is_sol) & ((r_lo > 0) | (r_hi < 0))
    corner_done = lo_is_sol | hi_is_sol | infeas
    x_corner = torch.where((lo_is_sol | (r_lo > 0))[..., None], xlo, xhi)
    y_in = torch.all((y >= xlo) & (y <= xhi), dim=-1)
    ry = torch.abs(torch.sum(a * y, dim=-1) - b)
    y_done = y_in & (ry <= r_tol) & ~corner_done
    rq = w / a
    lamlo = torch.amin(rq * (xlo - y), dim=-1)
    lamhi = torch.amax(rq * (xhi - y), dim=-1)
    lam = torch.where((lamlo <= 0) & (lamhi >= 0), 0.0, lamlo)
    wall_dist = 1e-3
    q = a / w
    aq = a * q
    done = corner_done | y_done
    x_newton = y.clone()
    prev_bisect = torch.zeros_like(done)
    for _ in range(max_its):
        if bool(torch.all(done)):
            break
        x_trial = y + lam[..., None] * q
        inside = (x_trial >= xlo) & (x_trial <= xhi)
        x_it = _clip(x_trial, xlo, xhi)
        r = torch.sum(a * x_it, dim=-1) - b
        r_lambda = torch.sum(torch.where(inside, aq, 0.0), dim=-1)
        converged = torch.abs(r) <= r_tol
        x_newton = torch.where((~done)[..., None], x_it, x_newton)
        done = done | converged
        lamhi = torch.where(r > 0, lam, lamhi)
        lamlo = torch.where(r > 0, lamlo, lam)
        nz = r_lambda != 0
        lam_newton = torch.where(nz, lam - r / torch.where(nz, r_lambda, 1.0),
                                 lamlo)
        D = torch.where(prev_bisect, 0.0, wall_dist * (lamhi - lamlo))
        need_bisect = (lam_newton - lamlo < D) | (lamhi - lam_newton < D)
        lam_next = torch.where(need_bisect, 0.5 * (lamlo + lamhi), lam_newton)
        lam = torch.where(done, lam, lam_next)
        prev_bisect = need_bisect & ~done
    x = torch.where(y_done[..., None], y,
                    torch.where(corner_done[..., None], x_corner, x_newton))
    return x


def run_mn2(Q_min, Q_mass, Q_max, extra_mass):
    ones = torch.ones_like(Q_mass)
    b = bfb_sum(Q_mass) + extra_mass
    return solve_1eq_bc_qp(ones, ones, b, Q_min, Q_max, Q_mass, max_its=100)


# The QLT tree: leaves paired level by level, an odd node promoted through a
# single-kid node.

def qlt_tree(nleaf):
    levels = []
    cur = np.arange(nleaf, dtype=np.int64)
    next_id = nleaf
    while len(cur) > 1:
        n_pairs = len(cur) // 2
        k0 = cur[0:2 * n_pairs:2]
        k1 = cur[1:2 * n_pairs:2]
        ids = np.arange(next_id, next_id + n_pairs, dtype=np.int64)
        next_id += n_pairs
        if len(cur) % 2 == 1:
            ids = np.concatenate([ids, [next_id]])
            k0 = np.concatenate([k0, cur[-1:]])
            k1 = np.concatenate([k1, [-1]])
            next_id += 1
        levels.append((ids, k0, k1))
        cur = ids
    return int(next_id), levels


def _sum2(x):
    return x[..., 0] + x[..., 1]


def _qp_2d(w, a, b, xlo, xhi, y):
    """The closed-form two-unknown QP of a QLT node."""
    r_tol = calc_r_tol(b, a, y)
    r_lo = _sum2(a * xlo) - b
    r_hi = _sum2(a * xhi) - b
    lo_is_sol = torch.abs(r_lo) <= r_tol
    hi_is_sol = torch.abs(r_hi) <= r_tol
    infeas = (~lo_is_sol) & (~hi_is_sol) & ((r_lo > 0) | (r_hi < 0))
    corner_sel = lo_is_sol | (infeas & (r_lo > 0))
    x_corner = torch.where(corner_sel[..., None], xlo, xhi)
    corner_done = lo_is_sol | hi_is_sol | infeas
    q = a / w
    qmass = _sum2(a * q)
    dm = b - _sum2(a * y)
    lam = dm / qmass
    x_free = y + lam[..., None] * q
    free_ok = torch.all((x_free >= xlo) & (x_free <= xhi), dim=-1)
    x_base = 0.5 * b[..., None] / a
    x_dir = torch.stack([-a[..., 1], a[..., 0]], dim=-1)
    alphas = torch.stack([
        (xlo[..., 1] - x_base[..., 1]) / x_dir[..., 1],
        (xhi[..., 0] - x_base[..., 0]) / x_dir[..., 0],
        (xhi[..., 1] - x_base[..., 1]) / x_dir[..., 1],
        (xlo[..., 0] - x_base[..., 0]) / x_dir[..., 0],
    ], dim=-1)
    order = torch.argsort(alphas, dim=-1, stable=True)
    mid_ai = order[..., 1:3]
    mid_alpha = torch.gather(alphas, -1, mid_ai)

    def objective(k):
        d = y - (x_base + mid_alpha[..., k, None] * x_dir)
        return _sum2(w * (d * d))

    pick = torch.where(objective(0) <= objective(1), 0, 1)
    ai = torch.gather(mid_ai, -1, pick[..., None])[..., 0]
    fixed_is_x1 = (ai == 0) | (ai == 2)
    fixed_val = torch.where(
        ai == 0, xlo[..., 1], torch.where(
            ai == 1, xhi[..., 0], torch.where(ai == 2, xhi[..., 1],
                                              xlo[..., 0])))
    a_fixed = torch.where(fixed_is_x1, a[..., 1], a[..., 0])
    a_free = torch.where(fixed_is_x1, a[..., 0], a[..., 1])
    free_val = (b - a_fixed * fixed_val) / a_free
    free_lo = torch.where(fixed_is_x1, xlo[..., 0], xlo[..., 1])
    free_hi = torch.where(fixed_is_x1, xhi[..., 0], xhi[..., 1])
    free_val = torch.minimum(torch.maximum(free_val, free_lo), free_hi)
    x_wall = torch.where(
        fixed_is_x1[..., None],
        torch.stack([free_val, fixed_val], dim=-1),
        torch.stack([fixed_val, free_val], dim=-1))
    x = torch.where(free_ok[..., None], x_free, x_wall)
    return torch.where(corner_done[..., None], x_corner, x)


def _adjust_bounds(Qm_bnd, rhom, Qm_extra):
    q = Qm_bnd / rhom
    neg = Qm_extra < 0
    i0_is_0 = torch.where(neg, q[..., 0] >= q[..., 1], q[..., 0] <= q[..., 1])
    q_i0 = torch.where(i0_is_0, q[..., 0], q[..., 1])
    q_i1 = torch.where(i0_is_0, q[..., 1], q[..., 0])
    rhom_i0 = torch.where(i0_is_0, rhom[..., 0], rhom[..., 1])
    Qm_gap = (q_i1 - q_i0) * rhom_i0
    single_ok = torch.where(neg, Qm_gap <= Qm_extra, Qm_gap >= Qm_extra)
    zero = torch.zeros_like(Qm_extra)
    single = Qm_bnd + torch.stack([torch.where(i0_is_0, Qm_extra, zero),
                                   torch.where(i0_is_0, zero, Qm_extra)],
                                  dim=-1)
    Qm_tot = Qm_bnd[..., 0] + Qm_bnd[..., 1] + Qm_extra
    q_tot = (Qm_tot / (rhom[..., 0] + rhom[..., 1]))[..., None]
    return torch.where(single_ok[..., None], single, q_tot * rhom)


def _node_problem(pd, Qm, rhom0, k0d, rhom1, k1d):
    """The shape-preserving node QP: the kids' masses (Qm0, Qm1)."""
    Qm_min_kids = torch.stack([k0d[..., 0], k1d[..., 0]], dim=-1)
    Qm_orig_kids = torch.stack([k0d[..., 1], k1d[..., 1]], dim=-1)
    Qm_max_kids = torch.stack([k0d[..., 2], k1d[..., 2]], dim=-1)
    rhom_kids = torch.stack([rhom0, rhom1], dim=-1)
    Qm_min, Qm_max = pd[..., 0], pd[..., 2]
    lo = Qm < Qm_min
    hi = Qm > Qm_max
    discrepancy = torch.where(lo, Qm_min - Qm, Qm - Qm_max)
    act = (lo | hi) & (discrepancy > 10 * _EPS * (Qm_max - Qm_min))
    target = Qm - torch.where(lo, Qm_min, Qm_max)
    adj_min = _adjust_bounds(Qm_min_kids, rhom_kids, target)
    adj_max = _adjust_bounds(Qm_max_kids, rhom_kids, target)
    Qm_min_kids = torch.where((act & lo)[..., None], adj_min, Qm_min_kids)
    Qm_max_kids = torch.where((act & hi)[..., None], adj_max, Qm_max_kids)
    no_change = ((~lo) & (~hi) & (Qm == pd[..., 1])
                 & torch.all((Qm_orig_kids >= Qm_min_kids)
                             & (Qm_orig_kids <= Qm_max_kids), dim=-1))
    ones = torch.ones_like(Qm_min_kids)
    x = _qp_2d(1.0 / rhom_kids, ones, Qm, Qm_min_kids, Qm_max_kids,
               Qm_orig_kids)
    x = torch.where(no_change[..., None], Qm_orig_kids, x)
    return x[..., 0], x[..., 1]


def qlt(rhom, Qm, Qm_min, Qm_max, extra):
    """The QLT tree over cells, shape-preserving, with the root mass
    raised by `extra`: rhom (ncell,), Q* (nt, ncell), extra (nt,)."""
    nn, levels = qlt_tree(Qm.shape[-1])
    dev = Qm.device
    nt, nl = Qm.shape
    kw = dict(dtype=Qm.dtype, device=dev)

    def leaves(x):
        V = torch.zeros(x.shape[:-1] + (nn,), **kw)
        V[..., :nl] = x
        return V

    V_rho, V_min, V_Qm, V_max = (leaves(x) for x in (rhom, Qm_min, Qm, Qm_max))
    lv_t = []
    for ids, k0, k1 in levels:
        t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        lv_t.append((t(ids), t(k0), t(k1.clip(min=0)), t(k1 < 0),
                     t((k1 >= 0).nonzero()[0]), t(k1[k1 >= 0])))
    for ids, k0, k1s, single, _, _ in lv_t:
        for V in (V_rho, V_Qm, V_min, V_max):
            v1 = torch.where(single, 0.0, V[..., k1s])
            V.index_copy_(-1, ids, V[..., k0] + v1)
    root = nn - 1
    M = torch.zeros((nt, nn), **kw)
    M[:, root] = V_Qm[:, root] + extra

    def data(idx):
        return torch.stack([V_min[:, idx], V_Qm[:, idx], V_max[:, idx]],
                           dim=-1)

    for ids, k0, k1s, single, pair, k1_pair in reversed(lv_t):
        Qm_node = M[:, ids]
        shape = Qm_node.shape
        rhom0 = V_rho[k0].expand(shape)
        rhom1 = torch.where(single, 1.0, V_rho[k1s]).expand(shape)
        Qm0, Qm1 = _node_problem(data(ids), Qm_node, rhom0, data(k0), rhom1,
                                 data(k1s))
        M.index_copy_(1, k0, torch.where(single, Qm_node, Qm0))
        M.index_copy_(1, k1_pair, Qm1[:, pair])
    return M[:, :nl]


def redistribute(method, rho_mass, Q_min, Q_mass, Q_max, extra):
    """The global mass redistribution over cells (caas | qlt)."""
    if method == "caas":
        return glbl_caas(Q_min, Q_mass, Q_max, extra)
    squeeze = Q_mass.dim() == 1
    Qm, Qm_min, Qm_max = (torch.atleast_2d(x) for x in (Q_mass, Q_min, Q_max))
    ex = torch.as_tensor(extra, dtype=Qm.dtype,
                         device=Qm.device).expand(Qm.shape[:1])
    out = qlt(rho_mass, Qm, Qm_min, Qm_max, ex)
    return out[0] if squeeze else out


def limit_density(F, rho, extra_mass):
    """The positivity limiter: rho' >= 0 with the cell masses raised by
    extra_mass; a uniform shift unless it drives a node negative."""
    mass_tgt = torch.sum(rho * F, dim=-1) + extra_mass
    any_below = torch.any(rho < 0, dim=-1)
    need = any_below | (extra_mass != 0)
    rho_clip = torch.clamp_min(rho, 0.0)
    mass = torch.sum(rho_clip * F, dim=-1)
    delta = mass_tgt - mass
    fac = delta / torch.sum(F, dim=-1)
    rho_add = rho_clip + fac[..., None]
    if bool(torch.any(rho_add < 0.0)):
        big = rho_clip + torch.abs(mass_tgt)[..., None] + 1.0
        x_qp = solve_1eq_bc_qp(F, F, mass_tgt, torch.zeros_like(rho), big,
                               rho_clip)
    else:
        x_qp = rho_add
    sel = (delta >= 0) | torch.all(rho_add >= 0.0, dim=-1)
    out = torch.where(sel[..., None], rho_add, x_qp)
    return torch.where(need[..., None], out, rho)


def dss(w, F, q, mesh):
    """The DSS merge of (nt, ndgll) q: each continuous node's coincident
    slots averaged with weights w (F where the merged w is 0), clipped to
    their range, written back to every slot."""
    c2d_idx, c2d_mask = mesh.c2d_idx, mesh.c2d_mask

    def sum4(x):
        return ((x[..., 0] + x[..., 1]) + x[..., 2]) + x[..., 3]

    vals = torch.where(c2d_mask, q[:, c2d_idx], 0.0)
    ws = torch.where(c2d_mask, w[c2d_idx], 0.0)
    fs = torch.where(c2d_mask, F[c2d_idx], 0.0)
    den = sum4(ws)
    ok = den > 0
    cg = torch.where(ok, sum4(ws * vals) / torch.where(ok, den, 1.0),
                     sum4(fs * vals) / sum4(fs))
    inf = float("inf")
    mn = torch.amin(torch.where(c2d_mask, vals, inf), dim=-1)
    mx = torch.amax(torch.where(c2d_mask, vals, -inf), dim=-1)
    cg = torch.minimum(torch.maximum(cg, mn), mx)
    return cg[:, mesh.dgll2cgll.reshape(-1)]


# ---------------------------------------------------------------------------
# The step

@dataclasses.dataclass(frozen=True)
class Options:
    filter: str          # caas | qlt
    limiter: str         # caas | mn2
    nsub: int
    geom_dtype: torch.dtype
    interp_dtype: torch.dtype
    dtype: torch.dtype   # the working (CDR) type


class Reference:
    """The reference ISL step on `mesh` (built in opt.dtype)."""

    def __init__(self, mesh, opt):
        if opt.filter not in ("caas", "qlt") or opt.limiter not in ("caas",
                                                                    "mn2"):
            raise ValueError(f"reference: filter {opt.filter}, limiter "
                             f"{opt.limiter} not covered")
        self.mesh, self.opt = mesh, opt
        self.wind = DivergentWind()
        gll = torch.tensor(gll_nodes_weights(mesh.np_)[0], dtype=F64)
        self.deriv = lagrange_eval_derivative(gll, gll).to(mesh.F.device)
        self.d2c = mesh.dgll2cgll.reshape(-1)

    def departure(self, ts, tf):
        """(dep, ci, w) of the CGLL nodes for the step ts -> tf."""
        m, opt = self.mesh, self.opt
        f32 = opt.geom_dtype == F32
        dep = integrate(self.wind.velocity, tf, ts,
                        m.cgll_xyz.to(opt.geom_dtype), opt.nsub)
        ci, a0, b0 = locate(m.ne, dep)
        corners = m.corners[ci].to(opt.geom_dtype)
        if f32:
            a, b = sphere_to_ref(corners, dep, max_its=3,
                                 tol=1e1 * float(torch.finfo(F32).eps),
                                 a0=a0, b0=b0)
        else:
            a, b = sphere_to_ref(corners, dep, max_its=4, a0=a0, b0=b0)
        va, vb = gllnodal4_eval(a), gllnodal4_eval(b)
        w = (vb[:, :, None] * va[:, None, :]).reshape(-1, m.np2)
        return dep, ci, w.to(opt.dtype)

    def _jacobian(self, dep):
        m = self.mesh
        pc = dep[m.dgll2cgll].reshape(m.ncell, m.np_, m.np_, 3)
        D = self.deriv.to(pc.dtype)
        pcT = torch.movedim(pc, 0, -1)
        f = pcT
        fa = D[None, :, 0, None, None] * pcT[:, 0, None, :, :]
        fb = D[:, 0, None, None, None] * pcT[0][None, :, :, :]
        for i in range(1, m.np_):
            fa = fa + D[None, :, i, None, None] * pcT[:, i, None, :, :]
            fb = fb + D[:, i, None, None, None] * pcT[i][None, :, :, :]

        def dot_d(a, b):
            return (a[..., 0, :] * b[..., 0, :]
                    + a[..., 1, :] * b[..., 1, :]) \
                + a[..., 2, :] * b[..., 2, :]

        def cross_d(a, b):
            a0, a1, a2 = a[..., 0, :], a[..., 1, :], a[..., 2, :]
            b0, b1, b2 = b[..., 0, :], b[..., 1, :], b[..., 2, :]
            return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                                a0 * b1 - a1 * b0], dim=-2)

        r2 = dot_d(f, f)[..., None, :]
        r = torch.sqrt(r2)
        ua = (fa - f * (dot_d(f, fa)[..., None, :] / r2)) / r
        ub = (fb - f * (dot_d(f, fb)[..., None, :] / r2)) / r
        cr = cross_d(ua, ub)
        jac = torch.sqrt(dot_d(cr, cr))
        return torch.movedim(jac, -1, 0).reshape(m.ncell, m.np2)

    @staticmethod
    def _interp(field, ci, w):
        return torch.sum(field[..., ci, :] * w, dim=-1)

    def interp(self, rho, q, dep, ci, w):
        """(rho_tgt, q_tgt, each slot's departure cell)."""
        m, opt = self.mesh, self.opt
        nt = q.shape[0]
        d2c, real = self.d2c, opt.dtype
        it = opt.interp_dtype
        wi = w.to(it)
        qi = self._interp(q.to(it), ci, wi)
        q_tgt = qi[:, d2c].to(real).reshape(nt, m.ncell, m.np2)
        ri = self._interp(rho.to(it), ci, wi)
        if it == F32:
            ratio = self._jacobian(dep).to(F32) / m.jac_node.to(F32)
        else:
            ratio = self._jacobian(dep) / m.jac_node
        rho_tgt = (ratio * ri[d2c].reshape(m.ncell, m.np2)).to(real)
        return rho_tgt, q_tgt, ci[d2c].reshape(m.ncell, m.np2)

    def rho_cdr(self, rho, rho_tgt):
        F = self.mesh.F
        mm = bfb_sum_cells(torch.stack([F * rho, F * rho_tgt]))
        rhom = F * rho_tgt
        zero, two = torch.zeros_like(rho_tgt), torch.full_like(rho_tgt, 2.0)
        R_min = torch.sum(rhom * zero, dim=-1)
        R_max = torch.sum(rhom * two, dim=-1)
        R_mass = torch.sum(F * rho_tgt, dim=-1)
        redist = redistribute(self.opt.filter, torch.sum(rhom, dim=-1), R_min,
                              R_mass, R_max, mm[0] - mm[1])
        rho_tgt = limit_density(F, rho_tgt, redist - R_mass)
        Ff = F.reshape(-1)
        return dss(Ff, Ff, rho_tgt.reshape(1, -1), self.mesh).reshape(
            rho_tgt.shape)

    @staticmethod
    def node_bounds(q, node_src_cell):
        """Each slot's bounds: its departure cell's min and max of q."""
        return (torch.amin(q, dim=-1)[:, node_src_cell],
                torch.amax(q, dim=-1)[:, node_src_cell])

    def tracer_cdr(self, rho, q, rho_tgt, q_tgt, node_src_cell):
        F = self.mesh.F
        Q_tgt = q_tgt * rho_tgt[None]
        QQ = bfb_sum_cells(torch.stack([F[None] * q * rho[None],
                                        F[None] * Q_tgt]))
        rhom1 = F * rho_tgt
        q_min_node, q_max_node = self.node_bounds(q, node_src_cell)
        Qc_min = torch.sum(rhom1[None] * q_min_node, dim=-1)
        Qc_max = torch.sum(rhom1[None] * q_max_node, dim=-1)
        Qc_mass = torch.sum(F[None] * Q_tgt, dim=-1)
        redist = redistribute(self.opt.filter, torch.sum(rhom1, dim=-1),
                              Qc_min, Qc_mass, Qc_max, QQ[0] - QQ[1])
        b = Qc_mass + (redist - Qc_mass)
        rho_b = rho_tgt.expand(q_tgt.shape[0], -1, -1)
        y = Q_tgt * (1.0 / torch.where(rho_tgt == 0, 1.0, rho_tgt))
        if self.opt.limiter == "caas":
            a = torch.clamp_min(rhom1, 1e-300)
            x = local_caas(a, b, q_min_node, q_max_node, y)
        else:
            a = torch.clamp_min(rhom1, max(1e-300,
                                           torch.finfo(rhom1.dtype).tiny))
            x = solve_1eq_bc_qp(a, a, b, q_min_node, q_max_node, y)
        return torch.where(rho_b == 0, q_min_node, x)

    def step(self, rho, q, ts, tf):
        """One step ts -> tf: (rho', q'), and each slot's departure cell."""
        dep, ci, w = self.departure(ts, tf)
        rho_tgt, q_tgt, nsc = self.interp(rho, q, dep, ci, w)
        rho_tgt = self.rho_cdr(rho, rho_tgt)
        q_new = self.tracer_cdr(rho, q, rho_tgt, q_tgt, nsc)
        Ff = self.mesh.F.reshape(-1)
        q_out = dss(Ff * rho_tgt.reshape(-1), Ff,
                    q_new.reshape(q.shape[0], -1), self.mesh)
        return rho_tgt, q_out.reshape(q.shape), nsc
