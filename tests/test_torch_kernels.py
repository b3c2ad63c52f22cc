"""The layouts behind the port's K1 and DSS-merge kernels, on the CPU
(no card needed; tests/test_torch_cuda.py runs the kernels themselves):

  - K1's launch geometry (cdr_fused.glbl_caas_geometry) cuts the padded
    row into aligned power-of-two pieces; summing them piece by piece, as
    the kernel does (chunk, lane's chunks, rounds, warps, cluster blocks),
    is bfb_sum bitwise;
  - the DSS kernel's slot table (dss.slot_table) is c2d_idx[dgll2cgll]
    with its mask, on the JAX package's numbering;
  - the merge written slot by slot, as the kernel computes it, equals
    dss_q_plain bitwise in f64 and f32, zero-density nodes included.
"""

import numpy as np
import pytest
import torch

from compose_tpu_torch.mesh import cubed_sphere
from compose_tpu_torch.ops.reduce import bfb_sum, next_pow2
from compose_tpu_torch.transport import cdr_fused, dss

from torch_parity import meshes

DTYPES = [torch.float64, torch.float32]


def _pow2(x):
    return x > 0 and x & (x - 1) == 0


@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
@pytest.mark.parametrize("ncell", [1, 96, 5400, 86400])
def test_glbl_caas_geometry_tree(ncell, dtype):
    cluster, warps, width, chunks, rounds = g = \
        cdr_fused.glbl_caas_geometry(ncell)
    assert all(_pow2(x) for x in g)
    assert cluster <= 8 and warps <= 8 and width <= 32 and chunks <= 4
    npad = next_pow2(ncell)
    assert cluster * warps * width * chunks * rounds == npad
    x = torch.tensor(np.random.default_rng(ncell).normal(size=(3, ncell))
                     * 1e3, dtype=dtype)
    # Pieces row-major as the kernel lays them out; fold the innermost
    # axis (a chunk's lanes) first, then chunks, rounds, warps, blocks.
    p = torch.nn.functional.pad(x, (0, npad - ncell)).reshape(
        3, cluster, warps, rounds, chunks, width)
    for _ in range(5):
        p = bfb_sum(p)
    assert torch.equal(p, bfb_sum(x))


@pytest.mark.parametrize("ncell", [5400, 8192, 8193])
def test_glbl_caas_geometry_registers(ncell):
    # Rows up to 8 blocks x 8 warps x 4 chunks x 32 lanes stay in
    # registers (one read of each input); the flagship's 5400 cells take a
    # full cluster of 8 blocks of 8 warps.
    g = cdr_fused.glbl_caas_geometry(ncell)
    assert (g[-1] == 1) == (ncell <= 8192)
    if ncell == 5400:
        assert g == (8, 8, 32, 4, 1)


@pytest.mark.parametrize("ne", [3, 4])
def test_slot_table(ne):
    mj, mt = meshes(ne)
    table = dss.slot_table(mt.c2d_idx, mt.c2d_mask, mt.dgll2cgll.reshape(-1))
    assert table.dtype == torch.int32 and table.is_contiguous()
    idx, mask = np.asarray(mj.c2d_idx), np.asarray(mj.c2d_mask)
    d2c = np.asarray(mj.dgll2cgll).reshape(-1)
    assert np.array_equal(table.numpy(), np.where(mask, idx, -1)[d2c])
    # Each slot is listed in its own row, and column 0 is always a slot.
    assert np.all((table.numpy() == np.arange(d2c.size)[:, None]).any(1))
    assert np.all(table.numpy()[:, 0] >= 0)


def _sum4(x):
    return ((x[..., 0] + x[..., 1]) + x[..., 2]) + x[..., 3]


def dss_q_slot_major(w, F, q, slots):
    """The merge as the kernel computes it: each slot merges its own node
    through its slot-table row and keeps the result for itself."""
    m = slots >= 0
    idx = torch.where(m, slots, 0).long()
    ws = torch.where(m, w[idx], 0.0)                       # (ndgll, 4)
    ok = _sum4(ws) > 0
    c = torch.where(ok[:, None], ws, torch.where(m, F[idx], 0.0))
    v = torch.where(m, q[:, idx], 0.0)                     # (nt, ndgll, 4)
    cg = _sum4(c * v) / _sum4(c)
    mn = torch.where(m, v, float("inf")).amin(-1)
    mx = torch.where(m, v, -float("inf")).amax(-1)
    return torch.minimum(torch.maximum(cg, mn), mx)


@pytest.mark.parametrize("nt", [1, 3])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
def test_dss_q_slot_major_bitwise(dtype, nt):
    mesh = cubed_sphere.build(4, 4, device="cpu", dtype=dtype)
    rng = np.random.default_rng(nt)
    ndg = mesh.ncell * mesh.np2
    idx, mask = mesh.c2d_idx.numpy(), mesh.c2d_mask.numpy()
    rho = rng.uniform(0.5, 1.5, ndg)
    # 20% of the nodes with every slot at zero density (the F fallback),
    # and some isolated zero slots.
    nodes = rng.choice(mesh.cnn, mesh.cnn // 5, replace=False)
    rho[idx[nodes][mask[nodes]]] = 0.0
    rho[rng.random(ndg) < 0.02] = 0.0
    F = mesh.dgbfi_gll.reshape(-1)
    w = F * torch.tensor(rho, dtype=dtype)
    q = torch.tensor(rng.uniform(0.0, 1.0, (nt, ndg)), dtype=dtype)
    d2c = mesh.dgll2cgll.reshape(-1)
    slots = dss.slot_table(mesh.c2d_idx, mesh.c2d_mask, d2c)
    ref = dss.dss_q_plain(w, F, q, mesh.c2d_idx, mesh.c2d_mask, d2c)
    assert ref.dtype == dtype
    assert torch.equal(dss_q_slot_major(w, F, q, slots), ref)
    # The density DSS (w = F) too.
    assert torch.equal(
        dss_q_slot_major(F, F, q, slots),
        dss.dss_q_plain(F, F, q, mesh.c2d_idx, mesh.c2d_mask, d2c))
