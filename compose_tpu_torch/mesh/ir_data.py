"""Static data of the cell-integrated remap, IR/CDG
(compose_tpu.mesh.ir_data): the per-cell full mass matrix (triangle
quadrature on the sphere, Cholesky factored) and what replaces the
reference's octree search:

  - deduplicated cell-corner vertices and a cell -> vertex map, so that
    advected cells stay watertight (every cell sees the same advected
    corner floats);
  - inward edge normals of the Eulerian cells, from the same vertex array
    on both sides of an edge;
  - a static 2-ring candidate table (<= MAX_CANDS = 25 cells, the cell
    itself included) in which an advected cell's overlaps are sought;
  - for facet transport (dmc f, ef): the reference-square GLL mass matrix's
    Cholesky factor, the node Jacobians Jt and the tensor GLL weights.

Built on the host (numpy, and torch f64 on the CPU for the quadrature)
from the f64 corners, then moved to the mesh's device and rounded once to
the mesh's dtype (f32 on the single-precision route, as the f32 mesh
tables are); integer tables are int64.
"""

import dataclasses

import numpy as np
import torch

from .. import basis as basis_mod
from ..config import F64
from ..ops import quadrature, sphere, sqr
from . import cubed_sphere

MAX_CANDS = 25


@dataclasses.dataclass(frozen=True)
class IrData:
    vert_xyz: torch.Tensor       # (nvert, 3) unique cell corner vertices
    cell2vert: torch.Tensor      # (ncell, 4) int64
    edge_nmls: torch.Tensor      # (ncell, 4, 3) inward edge normals
    cands: torch.Tensor          # (ncell, MAX_CANDS) int64 candidate cells
    cands_mask: torch.Tensor     # (ncell, MAX_CANDS) bool
    chol: torch.Tensor           # (ncell, np2, np2) Cholesky factors of M
    tq_bary: torch.Tensor        # (nq, 3) T-fill quadrature points
    tq_w: torch.Tensor           # (nq,)
    chol_ref: torch.Tensor       # (np2, np2) ref-square mass matrix factor
    Jt: torch.Tensor             # (ncell, np2) node Jacobians
    gll_w2: torch.Tensor         # (np2,) tensor GLL weights w_j w_i


FIELDS = tuple(f.name for f in dataclasses.fields(IrData))
_CACHE = {}


def _tensor(a, device, dtype):
    a = np.asarray(a)
    if a.dtype == np.bool_:
        return torch.tensor(a, dtype=torch.bool, device=device)
    if np.issubdtype(a.dtype, np.integer):
        return torch.tensor(a, dtype=torch.int64, device=device)
    return torch.tensor(a, dtype=F64, device=device).to(dtype)


def from_numpy(tables: dict, device, dtype=F64) -> IrData:
    """IrData from numpy tables keyed by the field names (e.g. a
    compose_tpu IrData's fields converted with np.asarray), float tables
    rounded once to `dtype`."""
    return IrData(**{k: _tensor(tables[k], device, dtype) for k in FIELDS})


def build(mesh: cubed_sphere.CubedSphereMesh, tq_order: int = None) -> IrData:
    """Cached per mesh geometry, dtype and T-fill quadrature order (None:
    the accuracy-matched order of the mesh's np)."""
    rot = (None if mesh.rot_R is None
           else tuple(mesh.rot_R.cpu().reshape(-1).tolist()))
    # Meshes that share (ne, np) (a gllsubcell and a runisubcell mesh, a
    # geometric np2 mesh) differ by their subcell identity.
    sub = (mesh.sub_parent_ne, None if mesh.sub_breaks is None
           else tuple(mesh.sub_breaks.cpu().tolist()))
    key = (mesh.ne, mesh.np_, tq_order, rot, mesh.nonuni, sub,
           str(mesh.device), mesh.dtype)
    if key not in _CACHE:
        _CACHE[key] = from_numpy(_build(mesh, tq_order), mesh.device,
                                 mesh.dtype)
    return _CACHE[key]


def _build(mesh, tq_order):
    ne, np_ = mesh.ne, mesh.np_
    ncell, np2 = mesh.ncell, mesh.np2
    m_order = {3: 14, 4: 18, 5: 20}.get(np_, 8 if np_ < 3 else 20)
    if tq_order is None:
        tq_order = m_order
    # The mass matrix always takes at least the accuracy-matched order: a
    # reduced T-fill order would make it singular for np > 2.
    m_order = max(m_order, tq_order)
    corners = mesh.corners.to(F64).cpu().numpy()           # (ncell, 4, 3)

    # Unique corner vertices by the integer cube keys of the corner lattice.
    f_idx, iy, ix = np.unravel_index(np.arange(ncell), (6, ne, ne))
    gx = np.stack([ix, ix + 1, ix + 1, ix], axis=-1)
    gy = np.stack([iy, iy, iy + 1, iy + 1], axis=-1)
    gx2 = 2 * gx.astype(np.int64) - ne
    gy2 = 2 * gy.astype(np.int64) - ne
    keys = np.empty((ncell, 4, 3), np.int64)
    for f in range(6):
        sel = f_idx == f
        keys[sel] = cubed_sphere._face_key(f, gx2[sel], gy2[sel], ne)
    _, first, inverse = np.unique(keys.reshape(-1, 3), axis=0,
                                  return_index=True, return_inverse=True)
    cell2vert = inverse.reshape(ncell, 4)
    vert_xyz = corners.reshape(-1, 3)[first]

    # Inward edge normals from the canonical vertices.
    v = vert_xyz[cell2vert]
    nml = np.cross(v, np.roll(v, -1, axis=1))
    nml /= np.linalg.norm(nml, axis=-1, keepdims=True)

    # 2-ring candidate table, sorted, padded with cell 0 (masked).
    v2c = {}
    for c in range(ncell):
        for k in range(4):
            v2c.setdefault(cell2vert[c, k], []).append(c)
    ring1 = [set() for _ in range(ncell)]
    for c in range(ncell):
        for k in range(4):
            ring1[c].update(v2c[cell2vert[c, k]])
    cands = np.zeros((ncell, MAX_CANDS), np.int64)
    mask = np.zeros((ncell, MAX_CANDS), bool)
    for c in range(ncell):
        r2 = set()
        for c1 in ring1[c]:
            r2.update(ring1[c1])
        r2 = sorted(r2)
        assert len(r2) <= MAX_CANDS, (c, len(r2))
        cands[c, :len(r2)] = r2
        mask[c, :len(r2)] = True

    # Full mass matrix per cell over the triangles (0,1,2), (0,2,3).
    bary, qw = quadrature.get_coef(m_order)
    jb, jqw = torch.tensor(bary, dtype=F64), torch.tensor(qw, dtype=F64)
    jc = torch.tensor(corners, dtype=F64)
    gll = basis_mod.GLL(np_)
    M = 0.0
    for (k1, k2) in ((1, 2), (2, 3)):
        jac, pq = sphere.tri_jacobian(
            jc[:, 0, :][:, None, :], jc[:, k1, :][:, None, :],
            jc[:, k2, :][:, None, :], jb[None, :, :])
        al, be = sqr.sphere_to_ref(jc[:, None, :, :], pq)
        gi, gj = gll.eval(al), gll.eval(be)
        phi = (gj[..., :, None] * gi[..., None, :]).reshape(ncell, -1, np2)
        M = M + torch.einsum('q,cq,cqa,cqb->cab', 0.5 * jqw, jac, phi, phi)
    chol = torch.linalg.cholesky(M)

    # Facet extras: the exact ref-square mass matrix (tensor product of the
    # 1-D Lagrange mass matrix by Gauss-Legendre) and the node Jacobians.
    gq, gwq = np.polynomial.legendre.leggauss(np_ + 2)
    gv = gll.eval(torch.tensor(gq, dtype=F64)).numpy()
    M1 = np.einsum('q,qa,qb->ab', gwq, gv, gv)
    chol_ref = torch.linalg.cholesky(torch.tensor(np.kron(M1, M1)))
    xn = gll.x.numpy()
    A = torch.tensor(np.tile(xn, np_), dtype=F64)
    B = torch.tensor(np.repeat(xn, np_), dtype=F64)
    Jt = sqr.bilinear_jacobian_norm(jc[:, None, :, :], A[None, :],
                                    B[None, :])
    w1 = gll.w.numpy()
    tq_bary, tq_w = quadrature.get_coef(tq_order)
    return dict(vert_xyz=vert_xyz, cell2vert=cell2vert, edge_nmls=nml,
                cands=cands, cands_mask=mask, chol=chol.numpy(),
                tq_bary=tq_bary, tq_w=tq_w, chol_ref=chol_ref.numpy(),
                Jt=Jt.numpy(), gll_w2=np.repeat(w1, np_) * np.tile(w1, np_))
