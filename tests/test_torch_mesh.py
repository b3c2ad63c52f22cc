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

from torch_parity import OPTIONAL, jax_tables, meshes, np_, t64

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
    # Every table, the rotated and nonuniform meshes' too; subcell meshes
    # are refused.
    for kw in (dict(), dict(rotate=ROT, nonuni=True)):
        mj, mt = meshes(3, **kw)
        for k in INT_TABLES + FLOAT_TABLES + OPTIONAL:
            if getattr(mj, k) is None:
                assert getattr(mt, k) is None, k
                continue
            assert np.array_equal(np.asarray(getattr(mj, k)),
                                  np_(getattr(mt, k))), k
    with pytest.raises(NotImplementedError):
        cs_torch.from_numpy(dict(jax_tables(mj), sub_parent_ne=3), "cpu")


ROT = ((0.11111, -0.051515, 1.0), 0.142314 * np.pi)
# (ne, np, basis, rotate, nonuni): rotated, warped, both at np8, and bases
# whose nodes are not GLL's (the mesh nodes sit at the basis's nodes).
MESH_OPTIONS = [(3, 4, "GllNodal", ROT, False), (3, 4, "GllNodal", None, True),
                (2, 8, "GllNodal", ROT, True),
                (2, 6, "UniformOffsetNodal", None, False),
                (2, 5, "FreeNodal", None, False)]


@pytest.mark.parametrize("ne,n,basis,rotate,nonuni", MESH_OPTIONS)
def test_mesh_options_tables_and_locate(ne, n, basis, rotate, nonuni):
    # Built by each package: integer tables equal, floats to 1e-14; located
    # cells equal, reference coordinates to 1e-14 (uniform: closed form) or
    # 1e-13 (nonuniform: the last Newton iterate from (0, 0)).
    mj = cs_jax.build(ne, n, basis, rotate=rotate, nonuni=nonuni)
    mt = cs_torch.build(ne, n, basis, device="cpu", rotate=rotate,
                        nonuni=nonuni)
    assert (mt.ncell, mt.cnn, mt.nonuni) == (mj.ncell, mj.cnn, mj.nonuni)
    for k in INT_TABLES + FLOAT_TABLES + OPTIONAL:
        a, b = getattr(mj, k), getattr(mt, k)
        if a is None:
            assert b is None, k
            continue
        a, b = np.asarray(a), np_(b)
        if a.dtype.kind in "bi":
            assert np.array_equal(a, b), k
        else:
            assert np.abs(a - b).max() <= 1e-14, k
    rng = np.random.default_rng(ne * n)
    p = rng.normal(size=(2000, 3))
    p /= np.linalg.norm(p, axis=-1, keepdims=True)
    cij, aj, bj = cs_jax.locate(mj, jnp.asarray(p))
    cit, at, bt = cs_torch.locate(mt, t64(p))
    assert np.array_equal(np.asarray(cij), np_(cit))
    tol = 1e-13 if nonuni else 1e-14
    assert np.abs(np.asarray(aj) - np_(at)).max() <= tol
    assert np.abs(np.asarray(bj) - np_(bt)).max() <= tol


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
    # np 14 and 15 are not tabulated in either package.
    for n in (14, 15):
        with pytest.raises(NotImplementedError):
            basis_jax.create("GllNodal", n)
        with pytest.raises(NotImplementedError):
            basis_torch.create("GllNodal", n)


NP_ISLET = list(range(2, 14)) + [16]
FAMILIES = {"Gll": list(range(2, 17)), "GllNodal": NP_ISLET,
            "GllOffsetNodal": NP_ISLET,
            "UniformOffsetNodal": list(range(2, 14)),
            "FreeNodal": [4, 5, 6, 7, 8, 10],
            "UniformReduced": NP_ISLET, "ConstantCell": list(range(2, 9)),
            "4 1 | 0 3: 0 1 2 | 1 4: 0 1 2 3": [4],
            "4 1 | 0 3: 0 1 2 | 1 4: 0 1 2 3 x -1 -0.5 0.5 1": [4]}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_basis_family_vs_jax(family):
    # Every np compose_tpu.basis.create builds: nodes, weights and values
    # at seeded points and at the nodes to 1e-14 (the same arithmetic;
    # bitwise seen); derivatives to 1e-13 where the family has its own
    # nodes (the GLL-noded Islet bases inherit Gll's derivative).
    rng = np.random.default_rng(len(family))
    for n in FAMILIES[family]:
        bj, bt = basis_jax.create(family, n), basis_torch.create(family, n)
        x = np.concatenate([rng.uniform(-1, 1, 200), np.asarray(bj.x)])
        assert np.abs(np.asarray(bj.x) - np_(bt.x)).max() == 0.0
        assert np.abs(np.asarray(bj.w) - np_(bt.w)).max() <= 1e-14
        assert np.abs(np.asarray(bj.eval(jnp.asarray(x)))
                      - np_(bt.eval(t64(x)))).max() <= 1e-14, (family, n)
        if hasattr(bj, "eval_deriv") and family not in ("GllNodal",
                                                         "GllOffsetNodal"):
            assert np.abs(np.asarray(bj.eval_deriv(jnp.asarray(x)))
                          - np_(bt.eval_deriv(t64(x)))).max() <= 1e-13


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
