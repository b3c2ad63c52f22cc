"""Raster output (compose_tpu.vis): a DGLL field sampled on a regular
lat-lon or orthographic grid, by one batched point location, the Newton
inverse to reference coordinates and the transport basis's tensor
evaluation in each point's cell, on the mesh's device; and binary raster
snapshots of float32 frames."""

import numpy as np
import torch

from . import basis as basis_mod
from .config import F64
from .mesh import cubed_sphere
from .ops import sphere, sqr


def latlon_grid(nlat: int, nlon: int):
    """(lat, lon), each (nlat, nlon), radians: nlat latitudes from pole to
    pole, nlon longitudes from -pi."""
    lat = np.linspace(-np.pi / 2, np.pi / 2, nlat)
    lon = np.linspace(-np.pi, np.pi, nlon, endpoint=False)
    return np.meshgrid(lat, lon, indexing="ij")


def ortho_grid(res: int, center_lat: float = 0.0, center_lon: float = 0.0):
    """The orthographic view of the hemisphere centred at (center_lat,
    center_lon): (lat, lon, mask), each (res, res); mask is False outside
    the disk."""
    X, Y = np.meshgrid(np.linspace(-1, 1, res), np.linspace(-1, 1, res),
                       indexing="xy")
    r2 = X * X + Y * Y
    mask = r2 <= 1.0
    Z = np.sqrt(np.maximum(0.0, 1.0 - r2))
    c = np.asarray([np.cos(center_lat) * np.cos(center_lon),
                    np.cos(center_lat) * np.sin(center_lon),
                    np.sin(center_lat)])
    east = np.asarray([-np.sin(center_lon), np.cos(center_lon), 0.0])
    north = np.cross(c, east)
    p = X[..., None] * east + Y[..., None] * north + Z[..., None] * c
    lat = np.arcsin(np.clip(p[..., 2], -1, 1))
    lon = np.arctan2(p[..., 1], p[..., 0])
    return lat, lon, mask


def sample_field(mesh: cubed_sphere.CubedSphereMesh, field_dgll, lat, lon,
                 basis_name: str = None, mask=None):
    """A DGLL field (..., ncell, np2) evaluated at the points (lat, lon)
    (numpy arrays of one shape), with the transport basis (`basis_name`,
    by default the mesh's). Returns a numpy array (..., *lat.shape) in the
    field's dtype; `mask` (lat's shape) sets the samples outside it to 0.
    On a nonuniform mesh the location itself converges the reference
    coordinates."""
    bas = basis_mod.create(basis_name or mesh.basis_name, mesh.np_)
    shape = np.shape(lat)
    kw = dict(dtype=mesh.dtype, device=mesh.device)
    p = sphere.ll2xyz(torch.tensor(np.ravel(lat), dtype=F64).to(**kw),
                      torch.tensor(np.ravel(lon), dtype=F64).to(**kw))
    ci, a, b = cubed_sphere.locate(mesh, p)
    if not mesh.nonuni:
        a, b = sqr.sphere_to_ref(mesh.corners[ci], p, a0=a, b0=b)
    va = bas.eval(a)                                  # (npts, np)
    vb = bas.eval(b)
    w = (vb[:, :, None] * va[:, None, :]).reshape(p.shape[0], mesh.np2)
    src = field_dgll[..., ci, :]                      # (..., npts, np2)
    out = torch.einsum('...px,px->...p', src, w.to(src.dtype))
    out = out.cpu().numpy().reshape(out.shape[:-1] + shape)
    if mask is not None:
        out = np.where(mask, out, 0.0)
    return out


def write_raster(path, arrays):
    """Binary raster snapshot: the header (nframes, nlat, nlon) as int32,
    then the frames as float32."""
    arrays = [np.asarray(a, dtype=np.float32) for a in arrays]
    nlat, nlon = arrays[0].shape
    with open(path, "wb") as f:
        np.array([len(arrays), nlat, nlon], dtype=np.int32).tofile(f)
        for a in arrays:
            a.tofile(f)
