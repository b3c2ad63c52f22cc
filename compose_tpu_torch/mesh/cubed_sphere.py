"""Quasiuniform equiangular cubed-sphere spectral-element mesh
(compose_tpu.mesh.cubed_sphere), optionally rotated (`rotate`) or warped
by the reference's nonuniform map (`nonuni`), or refined into subcells
(`mesh_type` gllsubcell | runisubcell: each geometric parent cell split
into (np-1)^2 np=2 subcells at the GLL or uniform break points of its
reference square).

Cell (face, iy, ix) has id face*ne^2 + iy*ne + ix; its np x np nodes are the
normalized bilinear images of the reference-square grid over the cell
corners: the GLL nodes, or the basis's own nodes for bases whose nodes are
not GLL (uniform, free). The continuous (CGLL) numbering comes from exact
integer keys on the cube surface. Construction runs on the host (numpy,
plus torch f64 for the Jacobians and sphere integrals); the finished
tables are moved to the requested device. Integer tables are int64 (torch
indexing wants int64).

Point location is O(1) on uniform meshes (the equiangular index, after
un-rotating the point). On a nonuniform mesh it inverts the analytic warp,
takes the equiangular candidate, and picks among its ring-1 neighbours
(the cells sharing a corner with it) by the Newton inverse. On a subcell
mesh it locates the parent cell first (equiangular index, Newton on the
parent), then the subcell by a sorted search over the static breaks.
"""

import dataclasses
import functools

import numpy as np
import torch

from .. import basis as basis_mod
from ..config import F64, resolve_device
from ..ops import quadrature, sphere, sqr

_QUARTER_PI = float(0.25 * np.pi)


def _face_point(face, X, Y):
    """Gnomonic coords (X, Y) on `face` -> unnormalized cube point."""
    O = np.ones_like(X)
    if face == 0:
        return np.stack([X, -O, Y], axis=-1)
    if face == 1:
        return np.stack([O, X, Y], axis=-1)
    if face == 2:
        return np.stack([-X, O, Y], axis=-1)
    if face == 3:
        return np.stack([-O, -X, Y], axis=-1)
    if face == 4:
        return np.stack([X, Y, O], axis=-1)
    return np.stack([-X, Y, -O], axis=-1)


def _face_key(face, gx2, gy2, N):
    """Exact integer cube-surface key of a face lattice point."""
    O = np.full_like(gx2, N)
    if face == 0:
        k = (gx2, -O, gy2)
    elif face == 1:
        k = (O, gx2, gy2)
    elif face == 2:
        k = (-gx2, O, gy2)
    elif face == 3:
        k = (-O, -gx2, gy2)
    elif face == 4:
        k = (gx2, gy2, O)
    else:
        k = (-gx2, gy2, -O)
    return np.stack(k, axis=-1)


@dataclasses.dataclass(frozen=True)
class CubedSphereMesh:
    """Static mesh tables, all tensors on `device`, float tables in
    `dtype`."""
    ne: int
    np_: int
    ncell: int
    cnn: int
    basis_name: str
    device: torch.device
    dtype: torch.dtype
    corners: torch.Tensor        # (ncell, 4, 3) cell corner unit vectors
    cell_nodes_xyz: torch.Tensor  # (ncell, np, np, 3) node positions
    dgll2cgll: torch.Tensor      # (ncell, np2) int64 -> continuous node id
    cgll_xyz: torch.Tensor       # (cnn, 3) canonical node coordinates
    cgll_rep: torch.Tensor       # (cnn,) int64 representative dgll slot
    c2d_idx: torch.Tensor        # (cnn, 4) int64 coincident dgll slots
    c2d_mask: torch.Tensor       # (cnn, 4) bool
    jac_node: torch.Tensor       # (ncell, np2) corner-bilinear |J|
    dgbfi_gll: torch.Tensor      # (ncell, np2) Homme mass weights
    dgbfi_sphere: torch.Tensor   # (ncell, np2) spherical integrals
    basis_x: torch.Tensor        # (np,)
    basis_w: torch.Tensor        # (np,)
    rot_R: torch.Tensor = None   # (3, 3) grid rotation, or None
    warp_R: torch.Tensor = None  # (3, 3) nonuniform warp rotation, or None
    ring1: torch.Tensor = None   # (ncell, 9) int64 corner-sharing cells
    ring1_mask: torch.Tensor = None  # (ncell, 9) bool
    # Subcell meshes: the parent mesh's ne (0: not a subcell mesh), the
    # reference-square break points and the parent cells' corners.
    sub_parent_ne: int = 0
    sub_breaks: torch.Tensor = None          # (np_geo,)
    sub_parent_corners: torch.Tensor = None  # (6 * parent ne^2, 4, 3)

    @property
    def is_subcell(self):
        return self.sub_parent_ne > 0

    @property
    def np2(self):
        return self.np_ * self.np_

    @property
    def nonuni(self):
        return self.warp_R is not None


_TABLES = ("corners", "cell_nodes_xyz", "dgll2cgll", "cgll_xyz", "cgll_rep",
           "c2d_idx", "c2d_mask", "jac_node", "dgbfi_gll", "dgbfi_sphere",
           "basis_x", "basis_w")
# Tables of rotated, nonuniform and subcell meshes; None on the others.
_OPTIONAL = ("rot_R", "warp_R", "ring1", "ring1_mask", "sub_breaks",
             "sub_parent_corners")


def _to_tensor(a, device, dtype):
    a = np.asarray(a)
    if a.dtype == np.bool_:
        return torch.tensor(a, dtype=torch.bool, device=device)
    if np.issubdtype(a.dtype, np.integer):
        return torch.tensor(a, dtype=torch.int64, device=device)
    return torch.tensor(a, dtype=dtype, device=device)


def from_numpy(tables: dict, device="cuda", dtype=F64) -> CubedSphereMesh:
    """Mesh from numpy tables (e.g. a compose_tpu mesh's fields converted
    with np.asarray): keys ne, np_ and the table names of CubedSphereMesh;
    the optional tables (rot_R, warp_R, ring1, ring1_mask, sub_breaks,
    sub_parent_corners) and sub_parent_ne may be absent or None. Float
    tables are cast to `dtype`."""
    dev = resolve_device(device)
    ne, np_ = int(tables["ne"]), int(tables["np_"])
    t = {k: _to_tensor(tables[k], dev, dtype) for k in _TABLES}
    t.update({k: None if tables.get(k) is None
              else _to_tensor(tables[k], dev, dtype) for k in _OPTIONAL})
    return CubedSphereMesh(
        ne=ne, np_=np_, ncell=6 * ne * ne, cnn=int(t["cgll_xyz"].shape[0]),
        basis_name=str(tables.get("basis_name", "GllNodal")), device=dev,
        dtype=dtype, sub_parent_ne=int(tables.get("sub_parent_ne") or 0),
        **t)


_BUILD_CACHE = {}
_MESH_TYPES = ("geometric", "gllsubcell", "runisubcell")


def form_rotation(axis, angle):
    """Rodrigues rotation matrix about `axis` by `angle` (numpy)."""
    a = np.asarray(axis, dtype=np.float64)
    a = a / np.linalg.norm(a)
    K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * (K @ K)


_WARP_F = 0.5  # squash factor of the nonuniform warp


def _warp_points(p, R, inverse=False):
    """Nonuniform warp w(p) = R' normalize(S (R p)), S = diag(1, f, f);
    the inverse uses S^-1. Numpy arrays (build) or tensors (locate)."""
    f = (1.0 / _WARP_F) if inverse else _WARP_F
    if torch.is_tensor(p):
        Rm = R.to(p.dtype)
        s = torch.tensor([1.0, f, f], dtype=p.dtype, device=p.device)
        q = (p @ Rm) * s
        q = q / torch.sqrt((q * q).sum(-1))[..., None]
        return q @ Rm.T
    q = p @ R
    q = q * np.asarray([1.0, f, f])
    q = q / np.sqrt((q * q).sum(-1))[..., None]
    return q @ R.T


def build(ne: int, np_: int = 4, basis_name: str = "GllNodal", *,
          device="cuda", dtype=F64, tq_order: int = 18, rotate=None,
          nonuni: bool = False,
          mesh_type: str = "geometric") -> CubedSphereMesh:
    """Cached mesh construction on `device` (the current CUDA device unless
    the CPU is asked for), float tables in `dtype`. `rotate` is an optional
    (axis, angle) grid rotation; `nonuni` applies the nonuniform warp;
    `mesh_type` gllsubcell or runisubcell refines each of the 6 ne^2
    parent cells into (np-1)^2 subcells and forces np 2 (the mesh's ne
    and np_ are then the refined ones)."""
    if mesh_type not in _MESH_TYPES:
        raise ValueError(f"mesh_type {mesh_type!r}: expected "
                         f"{' | '.join(_MESH_TYPES)}")
    dev = resolve_device(device)
    rot = None if rotate is None else (tuple(rotate[0]), float(rotate[1]))
    key = (ne, np_, basis_name, tq_order, rot, bool(nonuni), mesh_type,
           str(dev), dtype)
    if key not in _BUILD_CACHE:
        _BUILD_CACHE[key] = from_numpy(
            _build_tables(ne, np_, basis_name, tq_order, rot, bool(nonuni),
                          mesh_type), dev, dtype)
    return _BUILD_CACHE[key]


def _ring1(ne):
    """Each cell's corner-sharing neighbours (itself included), sorted,
    padded with the first: (ncell, 9) int64 and the (ncell, 9) mask."""
    ncell = 6 * ne * ne
    f_i, iy_i, ix_i = np.unravel_index(np.arange(ncell), (6, ne, ne))
    gcx = np.stack([ix_i, ix_i + 1, ix_i + 1, ix_i], -1).astype(np.int64)
    gcy = np.stack([iy_i, iy_i, iy_i + 1, iy_i + 1], -1).astype(np.int64)
    ckeys = np.empty((ncell, 4, 3), np.int64)
    for f in range(6):
        sel = f_i == f
        ckeys[sel] = _face_key(f, 2 * gcx[sel] - ne, 2 * gcy[sel] - ne, ne)
    _, vinv = np.unique(ckeys.reshape(-1, 3), axis=0, return_inverse=True)
    vinv = vinv.reshape(ncell, 4)
    v2c = {}
    for c in range(ncell):
        for k in range(4):
            v2c.setdefault(vinv[c, k], []).append(c)
    ring1 = np.zeros((ncell, 9), np.int64)
    mask = np.zeros((ncell, 9), bool)
    for c in range(ncell):
        nb = sorted({cc for k in range(4) for cc in v2c[vinv[c, k]]})
        assert len(nb) <= 9
        ring1[c, :len(nb)] = nb
        mask[c, :len(nb)] = True
        ring1[c, len(nb):] = nb[0]
    return ring1, mask


@functools.lru_cache(maxsize=None)
def _build_tables(ne, np_, basis_name, tq_order, rotate=None, nonuni=False,
                  mesh_type="geometric"):
    """The mesh tables as numpy arrays (the arithmetic of compose_tpu's
    _build), shared by every device and dtype."""
    subcell = mesh_type != "geometric"
    ne_geo, np_geo = ne, np_
    if subcell:
        if nonuni:
            raise NotImplementedError("subcell + nonuni is not supported")
        np_, basis_name = 2, "Gll"   # np=2 transport on the subcells
    ncell = 6 * ne * ne
    np2 = np_ * np_
    bas = basis_mod.create(basis_name, np_)
    gx, gw = basis_mod.gll_nodes_weights(np_)
    # Bases with nodes other than GLL's place the mesh nodes at their own
    # nodes, with their own weights.
    bx = bas.x.numpy()
    if bx.shape == gx.shape and not np.allclose(bx, gx, atol=1e-13):
        gx, gw = bx, bas.w.numpy()

    i = np.arange(ne)
    fx0 = -1.0 + 2.0 * i / ne
    Xe = np.tan(_QUARTER_PI * np.concatenate([fx0, [1.0]]))
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
    rot_R = warp_R = ring1 = ring1_mask = None
    if rotate is not None:
        rot_R = form_rotation(*rotate)
        corners = corners @ rot_R.T
        corners /= np.linalg.norm(corners, axis=-1, keepdims=True)
    if nonuni:
        warp_R = form_rotation((1.0, 1.0, 1.0), 0.2 * np.pi)
        corners = _warp_points(corners, warp_R)
        ring1, ring1_mask = _ring1(ne)
    sub_breaks = sub_parent_corners = None
    if subcell:
        # Subcell corners: bilinear-sphere images of the break grid; a
        # shared edge evaluates to the same floats from both parents.
        sub_parent_corners = corners.copy()
        if mesh_type == "gllsubcell":
            sub_breaks = np.asarray(basis_mod.gll_nodes_weights(np_geo)[0])
        else:
            sub_breaks = np.linspace(-1.0, 1.0, np_geo)
        ns = np_geo - 1
        AX0, AY0 = np.meshgrid(sub_breaks[:-1], sub_breaks[:-1],
                               indexing='xy')
        AX1, AY1 = np.meshgrid(sub_breaks[1:], sub_breaks[1:], indexing='xy')

        def bil(a, b):
            qtr = 0.25
            Nb = np.stack([qtr * (1 - a) * (1 - b), qtr * (1 + a) * (1 - b),
                           qtr * (1 + a) * (1 + b), qtr * (1 - a) * (1 + b)],
                          axis=-1)
            p = np.einsum('yxk,ckd->cyxd', Nb, corners)
            return p / np.linalg.norm(p, axis=-1, keepdims=True)

        pts = np.stack([bil(AX0, AY0), bil(AX1, AY0), bil(AX1, AY1),
                        bil(AX0, AY1)], axis=-2)
        # Global (face, IY, IX) lattice order with IY = iy * ns + sy.
        ne = ne_geo * ns
        pts = pts.reshape(6, ne_geo, ne_geo, ns, ns, 4, 3).transpose(
            0, 1, 3, 2, 4, 5, 6)
        corners = np.ascontiguousarray(pts.reshape(6 * ne * ne, 4, 3))
        ncell = 6 * ne * ne

    # Cell nodes: bilinear-sphere map of the GLL reference grid, [j, i].
    A, B = np.meshgrid(gx, gx, indexing='xy')
    qtr = 0.25
    N = np.stack([qtr * (1 - A) * (1 - B), qtr * (1 + A) * (1 - B),
                  qtr * (1 + A) * (1 + B), qtr * (1 - A) * (1 + B)], axis=-1)
    nodes = np.einsum('jik,ckd->cjid', N, corners)
    nodes /= np.linalg.norm(nodes, axis=-1, keepdims=True)

    # Combinatorial CGLL numbering via exact integer cube keys.
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
    flat_keys = keys.reshape(ncell * np2, 3)
    uniq, first_idx, inverse = np.unique(
        flat_keys, axis=0, return_index=True, return_inverse=True)
    inverse = inverse.reshape(-1)
    cnn = uniq.shape[0]
    dgll2cgll = inverse.reshape(ncell, np2)
    cgll_xyz = nodes.reshape(ncell * np2, 3)[first_idx]

    # Inverse map: the (<= 4) coincident slots of each continuous node, in
    # increasing slot order; padding repeats the first slot.
    order = np.argsort(inverse, kind="stable")
    counts = np.bincount(inverse, minlength=cnn)
    assert counts.max() <= 4
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    c2d_idx = np.zeros((cnn, 4), np.int64)
    c2d_mask = np.zeros((cnn, 4), bool)
    for k in range(4):
        sel = counts > k
        c2d_idx[sel, k] = order[starts[sel] + k]
        c2d_mask[sel, k] = True
    c2d_idx[~c2d_mask] = np.repeat(c2d_idx[:, 0], 4).reshape(cnn, 4)[
        ~c2d_mask]

    # Corner-bilinear Jacobians at the nodes, and the Homme mass weights.
    tc = torch.tensor(corners, dtype=F64)
    jac_node = sqr.bilinear_jacobian_norm(
        tc[:, None, :, :], torch.tensor(A.ravel(), dtype=F64)[None, :],
        torch.tensor(B.ravel(), dtype=F64)[None, :]).numpy()
    dgbfi_gll = jac_node * np.outer(gw, gw).ravel()[None, :]

    bary, qw = quadrature.get_coef(tq_order)
    dgbfi_sphere = _dgbfi_sphere(tc, torch.tensor(bary, dtype=F64),
                                 torch.tensor(qw, dtype=F64),
                                 np_).reshape(ncell, np2).numpy()
    return dict(ne=ne, np_=np_, basis_name=basis_name, corners=corners,
                cell_nodes_xyz=nodes,
                dgll2cgll=dgll2cgll, cgll_xyz=cgll_xyz, cgll_rep=first_idx,
                c2d_idx=c2d_idx, c2d_mask=c2d_mask, jac_node=jac_node,
                dgbfi_gll=dgbfi_gll, dgbfi_sphere=dgbfi_sphere,
                basis_x=bas.x.numpy(), basis_w=bas.w.numpy(), rot_R=rot_R,
                warp_R=warp_R, ring1=ring1, ring1_mask=ring1_mask,
                sub_parent_ne=ne_geo if subcell else 0, sub_breaks=sub_breaks,
                sub_parent_corners=sub_parent_corners)


def _dgbfi_sphere(corners, bary, qw, np_):
    """Spherical integrals of the GLL basis functions per cell, by triangle
    quadrature over the two triangles (0,1,2), (0,2,3) of each cell."""
    gll_bas = basis_mod.GLL(np_)
    v1 = torch.cat([corners[:, 0, :], corners[:, 0, :]])[:, None, :]
    v2 = torch.cat([corners[:, 1, :], corners[:, 2, :]])[:, None, :]
    v3 = torch.cat([corners[:, 2, :], corners[:, 3, :]])[:, None, :]
    cc = torch.cat([corners, corners])[:, None, :, :]
    jacq, pq = sphere.tri_jacobian(v1, v2, v3, bary[None, :, :])
    al, be = sqr.sphere_to_ref(cc, pq)
    al = torch.clamp(al, -2.0, 2.0)
    be = torch.clamp(be, -2.0, 2.0)
    gi = gll_bas.eval(al)
    gj = gll_bas.eval(be)
    out = torch.einsum('q,cq,cqj,cqi->cji', 0.5 * qw, jacq, gj, gi)
    n = corners.shape[0]
    return out[:n] + out[n:]


def get_cell_coords(ne: int, p, R=None):
    """Point location with local coordinates on the uniform mesh: returns
    (cell_idx int64, a0, b0), (a0, b0) being the closed-form equiangular
    estimate of the in-cell reference coordinates (a warm start for
    sqr.sphere_to_ref). `R` is the grid rotation of a rotated mesh (p R
    brings a point to the unrotated grid)."""
    if R is not None:
        p = p @ R.to(p.dtype)
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
         torch.where(face == 1, y / d,
         torch.where(face == 2, -x / d,
         torch.where(face == 3, -y / d,
         torch.where(face == 4, x / d, -x / d)))))
    fy = torch.where(face >= 4, y / d, z / d)
    fx = torch.atan(fx) / _QUARTER_PI
    fy = torch.atan(fy) / _QUARTER_PI
    gx = 0.5 * (1 + fx) * ne
    gy = 0.5 * (1 + fy) * ne
    ix = torch.clamp(torch.floor(gx).to(torch.int64), 0, ne - 1)
    iy = torch.clamp(torch.floor(gy).to(torch.int64), 0, ne - 1)
    ci = ne * ne * face + ne * iy + ix
    a0 = 2.0 * (gx - ix) - 1.0
    b0 = 2.0 * (gy - iy) - 1.0
    return ci, a0, b0


def get_cell_idx(ne: int, p, R=None):
    """O(1) point -> cell id (int64) on the uniform equiangular mesh."""
    return get_cell_coords(ne, p, R)[0]


def _locate_subcell(mesh, p):
    """Parent cell by the equiangular index and 6 Newton iterations on its
    corners, then the subcell by a sorted search over the breaks; (a, b)
    rescaled to the subcell are O(h^2) estimates."""
    pne = mesh.sub_parent_ne
    ci_p, a0, b0 = get_cell_coords(pne, p, mesh.rot_R)
    pc = mesh.sub_parent_corners[ci_p].to(p.dtype)
    a, b = sqr.sphere_to_ref(pc, p, a0=a0, b0=b0, max_its=6)
    br = mesh.sub_breaks.to(a.dtype)
    ns = br.shape[0] - 1

    def sub(u):
        k = torch.searchsorted(br, u.contiguous(), right=True) - 1
        k = torch.clamp(k, 0, ns - 1)
        lo, hi = br[k], br[k + 1]
        return k, 2.0 * (u - lo) / (hi - lo) - 1.0

    sx, a_s = sub(a)
    sy, b_s = sub(b)
    f = ci_p // (pne * pne)
    r = ci_p % (pne * pne)
    iy, ix = r // pne, r % pne
    NE = pne * ns
    ci = f * NE * NE + (iy * ns + sy) * NE + (ix * ns + sx)
    return ci, a_s, b_s


def locate(mesh: CubedSphereMesh, p, max_its: int = 10):
    """Point location with reference coordinates: (ci, a, b). On a uniform
    mesh the (a, b) are the O(h^2) equiangular estimate (callers polish
    with Newton). On a nonuniform mesh: invert the warp, take the
    equiangular candidate and select among its ring-1 neighbours by the
    Newton residual, penalizing solutions outside the cell; the (a, b) are
    then converged. On a subcell mesh: parent first (_locate_subcell)."""
    if mesh.is_subcell:
        return _locate_subcell(mesh, p)
    if not mesh.nonuni:
        return get_cell_coords(mesh.ne, p, mesh.rot_R)
    p0 = _warp_points(p, mesh.warp_R, inverse=True)
    c0 = get_cell_coords(mesh.ne, p0, mesh.rot_R)[0]
    cands = mesh.ring1[c0]                                # (..., 9)
    corners = mesh.corners[cands].to(p.dtype)             # (..., 9, 4, 3)
    p9 = p[..., None, :].expand(cands.shape + (3,))
    a, b = sqr.sphere_to_ref(corners, p9, max_its=max_its)
    rec = sqr.ref_to_sphere(corners, a, b)
    resid = torch.sqrt(sphere.norm2(rec - p9))
    outside = torch.maximum(torch.abs(a), torch.abs(b)) > 1.0 + 1e-10
    score = resid + torch.where(outside, 1e3, 0.0)
    score = torch.where(mesh.ring1_mask[c0], score, float("inf"))
    k = torch.argmin(score, dim=-1, keepdim=True)
    return (torch.gather(cands, -1, k)[..., 0],
            torch.gather(a, -1, k)[..., 0], torch.gather(b, -1, k)[..., 0])


def locate_cell(mesh: CubedSphereMesh, p):
    """Point -> containing cell id (int64)."""
    if not mesh.nonuni and not mesh.is_subcell:
        return get_cell_idx(mesh.ne, p, mesh.rot_R)
    return locate(mesh, p)[0]
