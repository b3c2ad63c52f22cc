"""Analytic wind fields and initial conditions (compose_tpu.transport.gallery):
the divergent and nondivergent deformational flows of Lauritzen et al.
(GMD 2012) in their cartesian form; the initial conditions gaussianhills,
cosinebells, slottedcylinders, xyztrig, correlatedcosinebells and
constant.

Winds take the time as a Python float and positions p (..., 3). The
time-only trig is scalar, so it is evaluated on the host, rounded to p's
dtype as the JAX package rounds it (an f32 geometry pipeline evaluates its
times in f32); only per-point arithmetic runs on the device.
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
    s = np_scalar(p.dtype)
    tt, Ts = s(t), s(T)
    c = s(s(s(2 * np.pi) * tt) / Ts)
    cc, sc = float(np.cos(c)), float(np.sin(c))
    cost = float(np.cos(s(s(s(np.pi) * tt) / Ts)))
    sinlp = sinlam * cc - coslam * sc
    coslp = coslam * cc + sinlam * sc
    return sinth, costh, sinlp, coslp, cost


class DivergentWindField:
    """Divergent deformational flow (slmm_gallery.cpp:361-388):
        u = -5 R/T sin^2(lam'/2) sin(2 th) cos^2(th) cos(pi t/T)
            + 2 pi R/T cos(th)
        v = 2.5 R/T sin(lam') cos^3(th) cos(pi t/T)."""

    T = constants.day2sec(12)

    def velocity(self, t, p):
        T = self.T
        sinth, costh, sinlp, coslp, cost = _trig_frame(t, p, T)
        costh2 = costh * costh
        sin2lat = 2 * sinth * costh
        v = 2.5 / T * sinlp * costh2 * costh * cost
        u = 1 / T * (-5 * (0.5 * (1 - coslp)) * sin2lat * costh2 * cost
                     + 2 * np.pi * costh)
        return _uv2xyz(p, u, v)


class NonDivergentWindField:
    """Nondivergent deformational flow (slmm_gallery.cpp:332-359):
        u = 10 R/T sin^2(lam') sin(2 th) cos(pi t/T) + 2 pi R/T cos(th)
        v = 10 R/T sin(2 lam') cos(th) cos(pi t/T)."""

    T = constants.day2sec(12)

    def velocity(self, t, p):
        T = self.T
        sinth, costh, sinlp, coslp, cost = _trig_frame(t, p, T)
        sin2lat = 2 * sinth * costh
        v = 10 / T * (2 * sinlp * coslp) * costh * cost
        u = 1 / T * (10 * sinlp * sinlp * sin2lat * cost + 2 * np.pi * costh)
        return _uv2xyz(p, u, v)


WINDS = {"divergent": DivergentWindField,
         "nondivergent": NonDivergentWindField}


def create_wind(name: str):
    key = name.lower()
    if key not in WINDS:
        raise NotImplementedError(f"wind '{name}' is not ported")
    return WINDS[key]()


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


ICS = {"xyztrig": xyztrig, "gaussianhills": gaussianhills,
       "cosinebells": cosinebells, "slottedcylinders": slottedcylinders,
       "correlatedcosinebells": correlatedcosinebells, "constant": constant}


def initial_condition(name: str, lat, lon):
    key = name.lower()
    if key not in ICS:
        raise NotImplementedError(f"initial condition '{name}' is not ported")
    return ICS[key](lat, lon)
