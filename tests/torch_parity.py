"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py):
the same mesh in both packages, and seeded inputs handed to both as numpy
arrays."""

import functools

import numpy as np
import torch

from compose_tpu.mesh import cubed_sphere as cs_jax
from compose_tpu.transport import gallery as gallery_jax
from compose_tpu.transport import ir as ir_jax
from compose_tpu_torch.mesh import cubed_sphere as cs_torch
from compose_tpu_torch.mesh import ir_data as ird_torch
from compose_tpu_torch.transport import gallery as gallery_torch
from compose_tpu_torch.transport import ir as ir_torch

# One intra-op thread per test process. The suite runs in several pytest
# workers at once, each of which imports this module while it collects;
# torch's default pool of one thread per core in every worker
# oversubscribes the cores, and the spinning pools made the port's IR
# tests many times slower than in a single process.
torch.set_num_threads(1)

TABLES = ("corners", "cell_nodes_xyz", "dgll2cgll", "cgll_xyz", "cgll_rep",
          "c2d_idx", "c2d_mask", "jac_node", "dgbfi_gll", "dgbfi_sphere",
          "basis_x", "basis_w")
# Rotated, nonuniform and subcell meshes' tables (None on the others).
OPTIONAL = ("rot_R", "warp_R", "ring1", "ring1_mask", "sub_breaks",
            "sub_parent_corners")
ICS4 = ("gaussianhills", "slottedcylinders", "cosinebells", "xyztrig")
DAY = 86400.0


def jax_tables(mesh):
    """A compose_tpu mesh's tables as numpy arrays (from_numpy's input)."""
    t = {k: np.asarray(getattr(mesh, k)) for k in TABLES}
    t.update({k: None if getattr(mesh, k) is None
              else np.asarray(getattr(mesh, k)) for k in OPTIONAL})
    t.update(ne=mesh.ne, np_=mesh.np_, basis_name=mesh.basis_name,
             sub_parent_ne=mesh.sub_parent_ne)
    return t


@functools.lru_cache(maxsize=None)
def meshes(ne, np_=4, basis="GllNodal", rotate=None, nonuni=False,
           mesh_type="geometric"):
    """(JAX mesh, port mesh loaded from the JAX mesh's tables on the CPU)."""
    mj = cs_jax.build(ne, np_, basis, rotate=rotate, nonuni=nonuni,
                      mesh_type=mesh_type)
    return mj, cs_torch.from_numpy(jax_tables(mj), "cpu")


def t64(x):
    return torch.tensor(np.asarray(x), dtype=torch.float64)


def np_(x):
    return np.asarray(x.detach().cpu().numpy() if torch.is_tensor(x) else x)


def ir_models(ne, n, mesh_type, cfg):
    """(JAX mesh, JAX IrTransport, port IrTransport on the CPU) of one
    IrConfig (nsub 2, divergent wind); the port's mesh and IR data are
    loaded from the JAX tables."""
    mj, mt = meshes(ne, n, mesh_type=mesh_type)
    kw = dict(ne=mj.ne, np_=mj.np_, nsub=2, **cfg)
    sj = ir_jax.IrTransport(mj, gallery_jax.create_wind("divergent"),
                            ir_jax.IrConfig(**kw))
    ird = ird_torch.from_numpy(
        {k: np.asarray(getattr(sj.ird, k)) for k in ird_torch.FIELDS}, "cpu")
    st = ir_torch.IrTransport(mt, gallery_torch.create_wind("divergent"),
                              ir_torch.IrConfig(**kw), ird=ird)
    return mj, sj, st


def err(a, b):
    """Max absolute difference of a JAX array and a tensor."""
    return float(np.abs(np.asarray(a) - np_(b)).max())
