"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py):
the same mesh in both packages, and seeded inputs handed to both as numpy
arrays."""

import functools

import numpy as np
import torch

from compose_tpu.mesh import cubed_sphere as cs_jax
from compose_tpu_torch.mesh import cubed_sphere as cs_torch

TABLES = ("corners", "cell_nodes_xyz", "dgll2cgll", "cgll_xyz", "cgll_rep",
          "c2d_idx", "c2d_mask", "jac_node", "dgbfi_gll", "dgbfi_sphere",
          "basis_x", "basis_w")
# Rotated and nonuniform meshes' tables (None on the others).
OPTIONAL = ("rot_R", "warp_R", "ring1", "ring1_mask")
ICS4 = ("gaussianhills", "slottedcylinders", "cosinebells", "xyztrig")


def jax_tables(mesh):
    """A compose_tpu mesh's tables as numpy arrays (from_numpy's input)."""
    t = {k: np.asarray(getattr(mesh, k)) for k in TABLES}
    t.update({k: None if getattr(mesh, k) is None
              else np.asarray(getattr(mesh, k)) for k in OPTIONAL})
    t.update(ne=mesh.ne, np_=mesh.np_, basis_name=mesh.basis_name)
    return t


@functools.lru_cache(maxsize=None)
def meshes(ne, np_=4, basis="GllNodal", rotate=None, nonuni=False):
    """(JAX mesh, port mesh loaded from the JAX mesh's tables on the CPU)."""
    mj = cs_jax.build(ne, np_, basis, rotate=rotate, nonuni=nonuni)
    return mj, cs_torch.from_numpy(jax_tables(mj), "cpu")


def t64(x):
    return torch.tensor(np.asarray(x), dtype=torch.float64)


def np_(x):
    return np.asarray(x.detach().cpu().numpy() if torch.is_tensor(x) else x)
