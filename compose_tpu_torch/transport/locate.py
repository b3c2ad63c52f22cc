"""Cell location of departure points on the card: the kernel
csrc/locate.cu and the operands it reads.

One thread per point computes the equiangular cell index and its warm
start (cubed_sphere.get_cell_coords), the masked Newton inverse to the
cell's reference square (sqr.sphere_to_ref) and, for the Islet GLL bases
at np 4, the basis weights (basis._np4_subgrid_eval and their outer
product), bitwise as the eager ops compute them. For any other basis or
np the entry `locate_ab` writes the reference coordinates (a, b) instead,
and the basis evaluates the weights eagerly.

`CellLocator` holds one mesh's operands, built once per device
(the corner table in the geometry's type, the rotation, the host table of
scalars), so that a call makes no host-to-device copy. IslTransport and
PRefineTransport call it for CUDA points; the eager chains stay for the
CPU (and, in IslTransport, the nonuniform and subcell meshes).
"""

import numpy as np
import torch

from .. import _native, basis as basis_mod
from ..config import np_scalar
from ..mesh import cubed_sphere

# basis._np4_subgrid_eval's blend constant.
_C1 = 0.306
TABLE_LEN = 19


def locate_table(dtype, tol: float, nodes=None):
    """The kernel's host scalars for points of `dtype`, rounded as the
    eager chain rounds them and held in float64: 1 / (pi / 4) (PyTorch
    divides by a Python float so), tol * tol, 0.306 and 0.5 - 0.306, then
    for the np4 nodes `nodes` (or zeros): 1 - x[2], the nodes, and the
    Lagrange denominators over x[0..3], x[0..2] and x[1..3] as
    basis._lagrange_eval forms them (left-to-right products of x[i] -
    x[j])."""
    s = np_scalar(dtype)
    head = [s(1.0) / s(cubed_sphere._QUARTER_PI), s(tol * tol), s(_C1),
            s(0.5 - _C1)]
    if nodes is None:
        return np.array(head + [0.0] * (TABLE_LEN - len(head)))
    x = [s(v) for v in np.asarray(nodes, dtype=np.float64)]

    def dens(sub):
        out = []
        for i in sub:
            d = [x[i] - x[j] for j in sub if j != i]
            acc = d[0]
            for v in d[1:]:
                acc = acc * v
            out.append(acc)
        return out

    vals = head + [s(1.0) - x[2]] + x + dens([0, 1, 2, 3]) \
        + dens([0, 1, 2]) + dens([1, 2, 3])
    return np.array(vals, dtype=np.float64)


def locate_cells(p, corners, ne: int, max_its: int, table, *, p_idx=None,
                 wdtype=None):
    """The kernel csrc/locate.cu on contiguous CUDA points p (N, 3) of f64
    or f32, the corner table (6 ne^2, 4, 3) in p's type, `max_its` Newton
    iterations and `locate_table`'s scalars. `p_idx`: the points the cell
    index reads (a rotated mesh's p R), p itself if None. Returns (ci,
    w) with w (N, 16) of `wdtype` (p's type or float64) when `wdtype` is
    given, else (ci, a, b). One launch on the current stream; raises on
    operands it cannot read, never computing them another way."""
    dt = p.dtype
    k = _native.kernel("locate" if wdtype is not None else "locate_ab", dt)
    if p.dim() != 2 or p.shape[1] != 3:
        raise ValueError(f"locate: expected points (N, 3), got "
                         f"{tuple(p.shape)}")
    n = p.shape[0]
    p_idx = p if p_idx is None else p_idx
    _native.require(p, "p", dt, (n, 3))
    _native.require(p_idx, "p_idx", dt, (n, 3))
    _native.require(corners, "corners", dt, (6 * ne * ne, 4, 3))
    if p_idx.device != p.device or corners.device != p.device:
        raise ValueError("locate: operands on different devices")
    table = np.ascontiguousarray(table, dtype=np.float64)
    if table.shape != (TABLE_LEN,):
        raise ValueError(f"locate: expected a table of {TABLE_LEN} "
                         f"scalars, got {table.shape}")
    ci = torch.empty(n, dtype=torch.int64, device=p.device)
    stream = _native.stream_of(p)
    if wdtype is None:
        a = torch.empty(n, dtype=dt, device=p.device)
        b = torch.empty(n, dtype=dt, device=p.device)
        k(p_idx.data_ptr(), p.data_ptr(), corners.data_ptr(), ci.data_ptr(),
          a.data_ptr(), b.data_ptr(), n, ne, max_its, 0, table.ctypes.data,
          stream=stream)
        return ci, a, b
    if wdtype not in (dt, torch.float64):
        raise TypeError(f"locate: weights of {wdtype} from {dt} points")
    w = torch.empty((n, 16), dtype=wdtype, device=p.device)
    k(p_idx.data_ptr(), p.data_ptr(), corners.data_ptr(), ci.data_ptr(),
      w.data_ptr(), None, n, ne, max_its, int(wdtype != dt),
      table.ctypes.data, stream=stream)
    return ci, w


def basis_weights(basis, a, b, np2: int):
    """The tensor-product basis weights (N, np2) at (a, b), w[j np + i] =
    vb[j] va[i], as the eager chains form them."""
    va = basis.eval(a)
    vb = basis.eval(b)
    return (vb[:, :, None] * va[:, None, :]).reshape(-1, np2)


class CellLocator:
    """Cell location on one mesh by the kernel, for departure points of the
    geometry type `geom`: the equiangular index of the mesh's `ne` (after
    its rotation), `max_its` Newton iterations at `tol` on its corners, and
    the weights of `basis` widened to `real`."""

    def __init__(self, mesh, basis, geom, max_its: int, tol: float, real):
        self.mesh = mesh
        self.basis = basis
        self.geom = geom
        self.max_its = max_its
        self.tol = tol
        self.real = real
        self.nodes = basis_mod.np4_subgrid_nodes(basis)
        self._consts = {}

    def constants(self, device):
        """(corners, R, table) on `device`, in the geometry's type, built
        at the first call and kept."""
        c = self._consts.get(device)
        if c is None:
            m, g = self.mesh, self.geom
            c = self._consts.setdefault(device, (
                m.corners.to(device=device, dtype=g).contiguous(),
                None if m.rot_R is None else m.rot_R.to(device=device,
                                                        dtype=g),
                locate_table(g, self.tol, self.nodes)))
        return c

    def __call__(self, dep):
        """(ci, w) of contiguous CUDA points dep (N, 3) of the geometry's
        type: one launch, and the basis's eager weights where the kernel
        does not evaluate them. Raises on points of another type."""
        if dep.dtype != self.geom:
            raise TypeError(f"locate: points of {dep.dtype}, the geometry "
                            f"is {self.geom}")
        corners, R, table = self.constants(dep.device)
        p_idx = dep if R is None else dep @ R
        ne, its = self.mesh.ne, self.max_its
        if self.nodes is not None:
            return locate_cells(dep, corners, ne, its, table, p_idx=p_idx,
                                wdtype=self.real)
        ci, a, b = locate_cells(dep, corners, ne, its, table, p_idx=p_idx)
        w = basis_weights(self.basis, a, b, self.mesh.np2)
        return ci, w.to(self.real)
