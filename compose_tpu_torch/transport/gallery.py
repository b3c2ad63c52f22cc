"""Analytic wind fields and initial conditions (compose_tpu.transport.gallery):
the divergent and nondivergent deformational flows of Lauritzen et al.
(GMD 2012) in their cartesian form, the nondivergent flow without its
solid-body part, solid-body rotations (rotate, dcmip1d3ll), the
Nair-Jablonowski moving vortices and the deformational test flow with a
vertical-structure term (testfn); every initial condition of the JAX
package, and the terminator toy chemistry's tendency.

Winds take the time as a Python float and positions p (..., 3). The
time-only trig is scalar, so it is evaluated on the host, rounded to p's
dtype as the JAX package rounds it (an f32 geometry pipeline evaluates its
times in f32); only per-point arithmetic runs on the device.

The two deformational flows have a native form in the trajectory kernel
csrc/dopri5.cu: `native` is the flow's code there, and `vscale`, v's
factor over T, is handed to the kernel (timeint.dopri5_table). Other winds
have no `native` and are integrated eagerly.
"""

import numpy as np
import torch

from .. import constants
from ..config import np_scalar
from ..ops import sphere


def _uv2xyz(p, u, v):
    """Tangent (u east, v north) velocity to cartesian, plus a radial
    component pushing |p| back to 1."""
    X, Y, Z = p[..., 0], p[..., 1], p[..., 2]
    r = torch.sqrt(X * X + Y * Y + Z * Z)
    w = (1.0 - r) / constants.earth_radius_m
    e_r = p / r[..., None]
    den = torch.sqrt(X * X + Y * Y)
    polar = den < torch.finfo(den.dtype).tiny
    den_s = torch.where(polar, 1.0, den)
    e_e = torch.stack([torch.where(polar, 0.0, -Y / den_s),
                       torch.where(polar, 1.0, X / den_s),
                       torch.zeros_like(Z)], dim=-1)
    e_n = sphere.cross(e_r, e_e)
    return u[..., None] * e_e + v[..., None] * e_n + w[..., None] * e_r


def time_trig(t, T, dtype):
    """(cos c, sin c, cos(pi t/T)), c = 2 pi t/T: the time part of
    `_trig_frame`, each scalar rounded in `dtype` by numpy's scalar
    arithmetic on the host, as Python floats. The trajectory kernel's
    wrapper (timeint.dopri5_table) takes its stage scalars from here."""
    s = np_scalar(dtype)
    tt, Ts = s(t), s(T)
    c = s(s(s(2 * np.pi) * tt) / Ts)
    h = s(s(s(np.pi) * tt) / Ts)
    return float(np.cos(c)), float(np.sin(c)), float(np.cos(h))


def _trig_frame(t, p, T):
    """sin/cos of latitude and of the shifted longitude lon - 2 pi t/T,
    computed algebraically from the cartesian coordinates; plus cos(pi
    t/T). The time trig is rounded in p's dtype on the host."""
    X, Y, Z = p[..., 0], p[..., 1], p[..., 2]
    r = torch.sqrt(X * X + Y * Y + Z * Z)
    d = torch.sqrt(X * X + Y * Y)
    sinth = Z / r
    costh = d / r
    polar = d < torch.finfo(d.dtype).tiny
    d_s = torch.where(polar, 1.0, d)
    coslam = torch.where(polar, 1.0, X / d_s)
    sinlam = torch.where(polar, 0.0, Y / d_s)
    cc, sc, cost = time_trig(t, T, p.dtype)
    sinlp = sinlam * cc - coslam * sc
    coslp = coslam * cc + sinlam * sc
    return sinth, costh, sinlp, coslp, cost


class DivergentWindField:
    """Divergent deformational flow (slmm_gallery.cpp:361-388):
        u = -5 R/T sin^2(lam'/2) sin(2 th) cos^2(th) cos(pi t/T)
            + 2 pi R/T cos(th)
        v = 2.5 R/T sin(lam') cos^3(th) cos(pi t/T)."""

    T = constants.day2sec(12)
    vscale = 2.5            # v's factor over T
    native = 0              # the wind's code in csrc/dopri5.cu

    def velocity(self, t, p):
        T = self.T
        sinth, costh, sinlp, coslp, cost = _trig_frame(t, p, T)
        costh2 = costh * costh
        sin2lat = 2 * sinth * costh
        v = self.vscale / T * sinlp * costh2 * costh * cost
        u = 1 / T * (-5 * (0.5 * (1 - coslp)) * sin2lat * costh2 * cost
                     + 2 * np.pi * costh)
        return _uv2xyz(p, u, v)


class NonDivergentWindField:
    """Nondivergent deformational flow (slmm_gallery.cpp:332-359):
        u = 10 R/T sin^2(lam') sin(2 th) cos(pi t/T) + 2 pi R/T cos(th)
        v = 10 R/T sin(2 lam') cos(th) cos(pi t/T)."""

    T = constants.day2sec(12)
    vscale = 10.0
    native = 1

    def velocity(self, t, p):
        T = self.T
        sinth, costh, sinlp, coslp, cost = _trig_frame(t, p, T)
        sin2lat = 2 * sinth * costh
        v = self.vscale / T * (2 * sinlp * coslp) * costh * cost
        u = 1 / T * (10 * sinlp * sinlp * sin2lat * cost + 2 * np.pi * costh)
        return _uv2xyz(p, u, v)


def _scalar(p, x):
    """A time-only scalar rounded in p's dtype, as a Python float."""
    return float(np_scalar(p.dtype)(x))


class NonDivergentWindFieldHack:
    """Nondivergent flow without the solid-body translation
    (slmm_gallery.cpp:466-492)."""

    T = constants.day2sec(12)

    def velocity(self, t, p):
        lat, lon = sphere.xyz2ll(p)
        R = constants.earth_radius_m
        T = self.T
        costh = torch.cos(lat)
        cost = _scalar(p, np.cos(np.pi * t / T))
        v = 10 * R / T * torch.sin(2 * lon) * costh * cost
        u = 10 * R / T * torch.sin(lon) ** 2 * torch.sin(2 * lat) * cost
        return _uv2xyz(p, u / R, v / R)


class _SolidBody:
    """Solid-body rotation omega * (axis x p)."""

    def velocity(self, t, p):
        axis = torch.tensor(self.axis, dtype=p.dtype, device=p.device)
        return self.omega * sphere.cross(axis.expand(p.shape), p)


class Rotate(_SolidBody):
    """Solid-body rotation about a tilted axis, period 12 days."""

    def __init__(self, axis=(0.2, 0.7, 1.0)):
        a = np.asarray(axis, dtype=np.float64)
        self.axis = a / np.linalg.norm(a)
        self.omega = 2 * np.pi / constants.day2sec(12)


class Dcmip1d3ll(_SolidBody):
    """DCMIP 1-3 background flow: solid-body rotation about an axis tilted
    pi/6 from the pole, period 1036800 s (slmm_gallery.cpp:300-330)."""

    def __init__(self):
        alpha = np.pi / 6
        self.axis = np.array([-np.sin(alpha), 0.0, np.cos(alpha)])
        self.omega = 2 * np.pi / 1036800.0


class MovingVortices:
    """Nair-Jablonowski moving vortices (slmm_gallery.cpp:390-464)."""

    rho0 = 3.0
    gamma = 5.0

    @staticmethod
    def Omega():
        return 2 * np.pi / constants.day2sec(12)

    @classmethod
    def calc_rho(cls, theta, lam):
        return cls.rho0 * torch.sqrt(
            1 - (torch.cos(theta) * torch.sin(lam)) ** 2)

    @classmethod
    def calc_omega(cls, Omega, rho):
        R = constants.earth_radius_m
        safe = rho != 0
        rho_s = torch.where(safe, rho, 1.0)
        om = (Omega * R * 1.5 * np.sqrt(3.0) * torch.tanh(rho_s)
              / (rho_s * torch.cosh(rho_s) ** 2))
        return torch.where(safe, om, 0.0)

    def velocity(self, t, p):
        lat, lon = sphere.xyz2ll(p)
        R = constants.earth_radius_m
        Omega = self.Omega()
        lam_p = lon - _scalar(p, Omega * t)
        rho = self.calc_rho(lat, lam_p)
        omega = self.calc_omega(Omega, rho)
        v = omega * torch.cos(lam_p)
        u = omega * torch.sin(lam_p) * torch.sin(lat) \
            + R * Omega * torch.cos(lat)
        return _uv2xyz(p, u / R, v / R)

    @classmethod
    def calc_tracer(cls, time, lat, lon):
        """The analytic tracer field at `time` (slmm_gallery.cpp:418-431)."""
        R = constants.earth_radius_m
        Omega = cls.Omega()
        lon_d = lon - Omega * time
        lam_p = torch.atan2(-torch.cos(lon_d), torch.tan(lat))
        rho = cls.calc_rho(lat, lon_d)
        omega = cls.calc_omega(Omega, rho)
        return 1 - torch.tanh(
            (rho / cls.gamma) * torch.sin(lam_p - (omega / R) * time))


class TestWindField:
    """The nondivergent deformational flow plus a vertical-structure
    perturbation ud at the fixed level z = 0.05 ztop
    (slmm_gallery.cpp:494-543)."""

    T = constants.day2sec(12)

    def velocity(self, t, p):
        lat, lon = sphere.xyz2ll(p)
        R = constants.earth_radius_m
        T = self.T
        ztop = 12000.0
        z = 0.05 * ztop
        T0, Rd, g, p0 = 300.0, 287.04, 9.80616, 100000.0
        H = Rd * T0 / g
        omega0 = (2 * 23000 * np.pi) / T
        lam_p = lon - _scalar(p, 2 * np.pi * t / T)
        costh = torch.cos(lat)
        cost = _scalar(p, np.cos(np.pi * t / T))
        pr = p0 * np.exp(-z / H)
        ptop = p0 * np.exp(-ztop / H)
        bs = 0.2
        s_p = (-np.exp((pr - p0) / (bs * ptop))
               + np.exp((ptop - pr) / (bs * ptop))) / (bs * ptop)
        ud = (omega0 * R) * torch.cos(lam_p) * costh ** 2 * cost * s_p
        v = 10 * R / T * torch.sin(2 * lam_p) * costh * cost
        u = (R / T * (10 * torch.sin(lam_p) ** 2 * torch.sin(2 * lat) * cost
                      + 2 * np.pi * costh) + ud)
        return _uv2xyz(p, u / R, v / R)


WINDS = {"divergent": DivergentWindField,
         "nondivergent": NonDivergentWindField,
         "nondivergenthack": NonDivergentWindFieldHack,
         "rotate": Rotate,
         "movingvortices": MovingVortices,
         "dcmip1d3ll": Dcmip1d3ll,
         "testfn": TestWindField}


def create_wind(name: str):
    return WINDS[name.lower()]()


# ----------------------------------------------------------------------------
# Initial conditions; all take (lat, lon) tensors.

_lon1, _lat1 = 5 * np.pi / 6, 0.0
_lon2, _lat2 = -5 * np.pi / 6, 0.0


def _ll2xyz_np(lat, lon):
    return np.array([np.cos(lon) * np.cos(lat), np.sin(lon) * np.cos(lat),
                     np.sin(lat)])


def _gcd(lat, lon, lat_c, lon_c):
    return sphere.great_circle_dist(lat, lon, torch.full_like(lat, lat_c),
                                    torch.full_like(lon, lon_c))


def xyztrig(lat, lon):
    p = sphere.ll2xyz(lat, lon)
    return 0.5 * (1 + torch.sin(3 * p[..., 0]) * torch.sin(3 * p[..., 1])
                  * torch.sin(4 * p[..., 2]))


def gaussianhills(lat, lon):
    p = sphere.ll2xyz(lat, lon)
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    h_max, b = 0.95, 5.0
    out = torch.zeros_like(lat)
    for c in (_ll2xyz_np(_lat1, _lon1), _ll2xyz_np(_lat2, _lon2)):
        r2 = (x - float(c[0])) ** 2 + (y - float(c[1])) ** 2 \
            + (z - float(c[2])) ** 2
        out = out + h_max * torch.exp(-b * r2)
    return out


def _cb(r_i, r):
    return 0.5 * (1 + torch.cos(np.pi * r_i / r))


def cosinebells(lat, lon):
    r, b, c = 0.5, 0.1, 0.9
    r1 = _gcd(lat, lon, _lat1, _lon1)
    r2 = _gcd(lat, lon, _lat2, _lon2)
    h = torch.where(r1 < r, _cb(r1, r),
                    torch.where(r2 < r, _cb(r2, r), 0.0))
    return b + c * h


def slottedcylinders(lat, lon):
    b, c = 0.1, 1.0
    R = 1.0
    r = 0.5 * R
    lon_thr = r / (6 * R)
    lat_thr = 5 * (r / (12 * R))
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


def correlatedcosinebells(lat, lon):
    c = cosinebells(lat, lon)
    return -0.8 * (c * c) + 0.9


def constant(lat, lon):
    return torch.full_like(lat, 0.42)


def zero(lat, lon):
    return torch.zeros_like(lat)


def vortextracer(lat, lon):
    return MovingVortices.calc_tracer(0.0, lat, lon)


def equatorstep(lat, lon):
    return torch.where(lat >= 0, torch.ones_like(lat),
                       torch.full_like(lat, 0.1))


def equatorsmoothstep(lat, lon):
    lat_thr, a, b = np.pi / 4, 0.1, 1.0
    smooth = a + ((b - a) / 2) * (1 + torch.sin(np.pi / 2 * (lat / lat_thr)))
    return torch.where(torch.abs(lat) >= lat_thr,
                       torch.where(lat >= 0, torch.full_like(lat, b),
                                   torch.full_like(lat, a)), smooth)


def slotcyltrig(lat, lon):
    sc = slottedcylinders(lat, lon)
    return torch.where(sc > 0.9, sc, xyztrig(lat, lon))


def smoothbelts(lat, lon):
    # The third row of a rotation about the x axis by 0.1 pi
    # (slmm_gallery.cpp:193-208).
    angle = 0.1 * np.pi
    ca, sa = np.cos(angle), np.sin(angle)
    p = sphere.ll2xyz(lat, lon)
    y2 = sa * p[..., 1] + ca * p[..., 2]
    return 0.5 * (1 + torch.cos(np.pi * y2))


def cbandsc(lat, lon):
    out = torch.full_like(lat, 0.1)
    lon1 = 3 * np.pi / 6
    r, c = 0.5, 0.9
    r1 = _gcd(lat, lon, _lat1, lon1)
    out = out + torch.where(r1 < r, c * _cb(r1, r), 0.0)
    R = 1.0
    rr = 0.5 * R
    lon_thr = rr / (6 * R)
    lat_thr = 5 * (rr / (12 * R))
    r2 = _gcd(lat, lon, _lat2, _lon2)
    in2 = (r2 <= rr) & ((torch.abs(lon - _lon2) >= lon_thr)
                        | ((torch.abs(lon - _lon2) < lon_thr)
                           & (lat - _lat2 > lat_thr)))
    return torch.where(in2, c, out)


# The terminator toy chemistry (slmm_gallery.cpp:240-268), evaluated in the
# dtype of its inputs (f64 on every path that runs it).
_K1_LAT_CENTER = np.pi * 20.0 / 180.0
_K1_LON_CENTER = np.pi * 300.0 / 180.0
_TOYCHEM_CONSTANT = 4e-6


def _k_vals(lat, lon):
    k1 = torch.clamp_min(
        torch.sin(lat) * np.sin(_K1_LAT_CENTER)
        + torch.cos(lat) * np.cos(_K1_LAT_CENTER)
        * torch.cos(lon - _K1_LON_CENTER), 0.0)
    return k1, torch.ones_like(lat)


def toychem1(lat, lon):
    k1, k2 = _k_vals(lat, lon)
    r = k1 / (4 * k2)
    det = torch.sqrt(r * r + 2 * _TOYCHEM_CONSTANT * r)
    return det - r


def toychem2(lat, lon):
    return _TOYCHEM_CONSTANT - toychem1(lat, lon)


def toychem_tendency(lat, lon, cl, cl2, dt):
    """The terminator chemistry's tendencies (d cl/dt, d cl2/dt)
    (slmm_gallery.cpp:247-268)."""
    cl2 = 0.5 * cl2
    k1, k2 = _k_vals(lat, lon)
    r = k1 / (4 * k2)
    cly = cl + 2 * cl2
    det = torch.sqrt(r * r + 2 * r * cly)
    expdt = torch.exp(-4 * k2 * det * dt)
    el = torch.where(torch.abs(det * k2 * dt) > 1e-16,
                     (1 - expdt) / torch.where(det * dt != 0, det * dt, 1.0),
                     4 * k2)
    cl_f = (-el * (cl - det + r) * (cl + det + r)
            / (1 + expdt + dt * el * (cl + r)))
    return cl_f, -cl_f


ICS = {"xyztrig": xyztrig, "gaussianhills": gaussianhills,
       "cosinebells": cosinebells, "slottedcylinders": slottedcylinders,
       "correlatedcosinebells": correlatedcosinebells, "constant": constant,
       "zero": zero, "vortextracer": vortextracer, "equatorstep": equatorstep,
       "equatorsmoothstep": equatorsmoothstep, "slotcyltrig": slotcyltrig,
       "smoothbelts": smoothbelts, "cbandsc": cbandsc, "toychem1": toychem1,
       "toychem2": toychem2}


def initial_condition(name: str, lat, lon):
    return ICS[name.lower()](lat, lon)
