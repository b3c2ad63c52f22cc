"""Mesh, basis and geometry of the PyTorch port against compose_tpu.

Integer tables must be equal exactly. Float tables come from the same
numpy arithmetic except the Jacobians and sphere integrals (torch vs XLA
f64 kernels, a few ulp), so they are held to 1e-14 absolute on values of
order 1 or smaller.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from compose_tpu import basis as basis_jax
from compose_tpu.mesh import cubed_sphere as cs_jax
from compose_tpu.ops import sqr as sqr_jax
from compose_tpu_torch import basis as basis_torch
from compose_tpu_torch.mesh import cubed_sphere as cs_torch
from compose_tpu_torch.ops import sqr as sqr_torch

from torch_parity import jax_tables, meshes, np_, t64

INT_TABLES = ("dgll2cgll", "c2d_idx", "c2d_mask", "cgll_rep")
FLOAT_TABLES = ("corners", "cell_nodes_xyz", "cgll_xyz", "jac_node",
                "dgbfi_gll", "dgbfi_sphere", "basis_x", "basis_w")


@pytest.fixture(scope="module", params=[3, 4])
def built(request):
    ne = request.param
    return cs_jax.build(ne, 4), cs_torch.build(ne, 4, device="cpu")


def test_integer_tables_exact(built):
    mj, mt = built
    assert (mt.ncell, mt.cnn) == (mj.ncell, mj.cnn)
    for k in INT_TABLES:
        assert np.array_equal(np.asarray(getattr(mj, k)),
                              np_(getattr(mt, k))), k
    assert mt.dgll2cgll.dtype == torch.int64
    assert mt.c2d_mask.dtype == torch.bool


def test_float_tables(built):
    mj, mt = built
    for k in FLOAT_TABLES:
        a, b = np.asarray(getattr(mj, k)), np_(getattr(mt, k))
        assert a.shape == b.shape, k
        assert np.abs(a - b).max() <= 1e-14, k
        assert getattr(mt, k).dtype == torch.float64, k


def test_from_numpy_carries_the_tables():
    mj, mt = meshes(3)
    for k in INT_TABLES + FLOAT_TABLES:
        assert np.array_equal(np.asarray(getattr(mj, k)), np_(getattr(mt, k)))
    with pytest.raises(NotImplementedError):
        cs_torch.from_numpy(dict(jax_tables(mj), warp_R=np.eye(3)), "cpu")


@pytest.mark.parametrize("n", [2, 3, 4, 5, 8])
def test_gll_nodes_weights(n):
    # Same numpy Newton solve in both packages: 1e-14 stated, bitwise seen.
    xj, wj = basis_jax.gll_nodes_weights(n)
    xt, wt = basis_torch.gll_nodes_weights(n)
    assert np.abs(xj - xt).max() <= 1e-14 and np.abs(wj - wt).max() <= 1e-14


def test_basis_eval():
    rng = np.random.default_rng(11)
    x = np.concatenate([rng.uniform(-1.2, 1.2, 200),
                        np.asarray(basis_jax.gll_nodes_weights(4)[0])])
    for name in ("GllNodal", "Gll"):
        bj, bt = basis_jax.create(name, 4), basis_torch.create(name, 4)
        assert np.abs(np.asarray(bj.eval(jnp.asarray(x)))
                      - np_(bt.eval(t64(x)))).max() <= 1e-14, name
        assert np.abs(np.asarray(bj.w) - np_(bt.w)).max() == 0.0
    gj, gt = basis_jax.GLL(4), basis_torch.GLL(4)
    assert np.abs(np.asarray(gj.eval_deriv(gj.x))
                  - np_(gt.eval_deriv(gt.x))).max() <= 1e-13
    with pytest.raises(NotImplementedError):
        basis_torch.create("GllNodal", 6)


def _seeded_points(mesh_j, rng, n=300):
    ci = rng.integers(0, mesh_j.ncell, n)
    a = rng.uniform(-1.0, 1.0, n)
    b = rng.uniform(-1.0, 1.0, n)
    corners = np.asarray(mesh_j.corners)[ci]
    p = np.asarray(sqr_jax.ref_to_sphere(jnp.asarray(corners), jnp.asarray(a),
                                         jnp.asarray(b)))
    return ci, a, b, corners, p


def test_sphere_to_ref():
    # Newton converges to ~1e-16 in both; 1e-13 covers the last iterate.
    mj, _ = meshes(4)
    ci, a, b, corners, p = _seeded_points(mj, np.random.default_rng(5))
    aj, bj = sqr_jax.sphere_to_ref(jnp.asarray(corners), jnp.asarray(p))
    at, bt = sqr_torch.sphere_to_ref(t64(corners), t64(p))
    assert np.abs(np.asarray(aj) - np_(at)).max() <= 1e-13
    assert np.abs(np.asarray(bj) - np_(bt)).max() <= 1e-13
    assert np.abs(np_(at) - a).max() <= 1e-12
    # Newton stops once |residual| <= tol = 1e2 eps.
    rt = sqr_torch.ref_to_sphere(t64(corners), at, bt)
    assert np.abs(np_(rt) - p).max() <= 1e2 * np.finfo(np.float64).eps


def test_locate():
    # ci must agree exactly except where the equiangular coordinate sits
    # within 1e-12 of a cell edge (floor of a tie can round either way).
    mj, mt = meshes(4)
    rng = np.random.default_rng(9)
    p = rng.normal(size=(2000, 3))
    p /= np.linalg.norm(p, axis=-1, keepdims=True)
    cij, aj, bj = cs_jax.locate(mj, jnp.asarray(p))
    cit, at, bt = cs_torch.locate(mt, t64(p))
    aj, bj = np.asarray(aj), np.asarray(bj)
    tie = (np.abs(np.abs(aj) - 1) < 1e-12) | (np.abs(np.abs(bj) - 1) < 1e-12)
    assert np.array_equal(np.asarray(cij)[~tie], np_(cit)[~tie])
    assert np.abs(aj - np_(at))[~tie].max() <= 1e-13
    assert np.abs(bj - np_(bt))[~tie].max() <= 1e-13
    # The points of known cells are located in them.
    ci, a, b, _, ps = _seeded_points(mj, rng)
    inner = (np.abs(a) < 0.99) & (np.abs(b) < 0.99)
    assert np.array_equal(np_(cs_torch.locate(mt, t64(ps))[0])[inner],
                          ci[inner])
