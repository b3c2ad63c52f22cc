"""The offline Islet tools on the port's bases against compose_tpu's
(tests/test_islet_tools.py's cases): the native spectral radius, the 1-D
ISL operator, the Courant-sweep and Bloch stability metrics (the GLL np4
basis unstable, the Islet one stable), the accuracy metrics and Lebesgue
constants, the weights of nodal-subset bases, the metrics tracker and the
two-stage search. Results agree with the JAX package's to 1e-12, or
exactly where they are integers or subset tuples."""

import os

import numpy as np
import pytest

from compose_tpu import basis as basis_jax
from compose_tpu import islet_tools as tools_jax
from compose_tpu_torch import basis as basis_torch
from compose_tpu_torch import islet_tools as tools_torch


def _bases(name, np_):
    if name == "Gll":
        return basis_jax.GLL(np_), basis_torch.GLL(np_)
    return basis_jax.create(name, np_), basis_torch.create(name, np_)


def test_native_library_is_built_and_matches_numpy():
    rng = np.random.default_rng(0)
    mats = rng.standard_normal((8, 12, 12))
    got = tools_torch.spectral_radius(mats)
    assert tools_torch._native is not None
    assert os.path.exists(tools_torch._LIB)
    ref = np.array([np.max(np.abs(np.linalg.eigvals(m))) for m in mats])
    assert np.allclose(got, ref, rtol=1e-10)
    assert np.array_equal(got, tools_jax.spectral_radius(mats))


def test_native_build_failure_raises(monkeypatch, tmp_path):
    # No fallback: a library that cannot be built is an error.
    monkeypatch.setattr(tools_torch, "_native", None)
    monkeypatch.setattr(tools_torch, "_SRC", str(tmp_path / "missing.cpp"))
    monkeypatch.setattr(tools_torch, "_LIB", str(tmp_path / "b" / "lib.so"))
    with pytest.raises(RuntimeError, match="native Islet library"):
        tools_torch.spectral_radius(np.eye(3))


@pytest.mark.parametrize("name", ["Gll", "GllNodal"])
def test_isl_op_vs_jax(name):
    bj, bt = _bases(name, 4)
    A = tools_torch.isl_op(bt, 5, 0.37)
    assert np.allclose(A.sum(axis=1), 1.0, atol=1e-12)
    assert np.abs(A - tools_jax.isl_op(bj, 5, 0.37)).max() <= 1e-12
    A1 = tools_torch.isl_op(bt, 5, 1.0)
    assert np.allclose((A1 > 0.5).sum(axis=1), 1)
    x = np.arange(6, dtype=np.float64)
    x[1:-1] += np.random.default_rng(2).uniform(-0.2, 0.2, 4)
    assert np.abs(tools_torch.isl_op(bt, 5, 0.61, mesh_x=x)
                  - tools_jax.isl_op(bj, 5, 0.61, mesh_x=x)).max() <= 1e-12


def test_gll_np4_unstable_islet_np4_stable():
    lam = {}
    for name in ("Gll", "GllNodal"):
        bj, bt = _bases(name, 4)
        lam[name] = tools_torch.MaxEigComputer(bt).max_eig_amp(7, ndx=48)
        ref = tools_jax.MaxEigComputer(bj).max_eig_amp(7, ndx=48)
        assert abs(lam[name] - ref) <= 1e-12
    assert lam["Gll"] > 1 + 1e-4
    assert lam["GllNodal"] <= 1 + 1e-10


def test_bloch_matches_full_mesh_and_jax():
    for name in ("Gll", "GllNodal"):
        bj, bt = _bases(name, 4)
        full = tools_torch.MaxEigComputer(bt).max_eig_amp(5, ndx=8)
        bloch = tools_torch.bloch_max_eig_amp(bt, ne=5, ndx=8)
        assert abs(full - bloch) < 1e-8
        assert abs(bloch - tools_jax.bloch_max_eig_amp(bj, ne=5, ndx=8)) \
            <= 1e-12
    assert tools_torch.bloch_max_eig_amp(basis_torch.GLL(4), ne=24,
                                         ndx=16) > 1 + 1e-4
    assert tools_torch.bloch_max_eig_amp(basis_torch.create("GllNodal", 4),
                                         ne=24, ndx=16) <= 1 + 1e-9


def test_pum_metric_vs_jax():
    bj, bt = _bases("GllNodal", 4)
    kw = dict(ne=4, n_mesh=2, ndx=6, seed=3)
    assert abs(tools_torch.pum_metric(bt, **kw)
               - tools_jax.pum_metric(bj, **kw)) <= 1e-12


def test_lebesgue_and_accuracy_metrics_vs_jax():
    for name in ("Gll", "GllNodal"):
        bj, bt = _bases(name, 4)
        for fn in ("lebesgue_constant", "interp_error_metric"):
            got = getattr(tools_torch, fn)(bt)
            assert abs(got - getattr(tools_jax, fn)(bj)) <= 1e-12
            assert np.isfinite(got)
    bj, bt = _bases("GllNodal", 6)
    got = tools_torch.calc_xnodes_metrics(np.asarray(bt.x), bt._subsets())
    assert abs(got[0] - 2.393393e-04) < 1e-9
    assert abs(got[1] - 2.104595e-04) < 1e-9
    assert abs(got[2] - 2.816403e-04) < 1e-9
    ref = tools_jax.calc_xnodes_metrics(np.asarray(bj.x), bj._subsets())
    assert np.allclose(got, ref, rtol=1e-12, atol=0)
    assert np.allclose(
        tools_torch.calc_lebesgue_consts(np.asarray(bt.x), bt._subsets()),
        tools_jax.calc_lebesgue_consts(np.asarray(bj.x), bj._subsets()),
        rtol=1e-12, atol=0)


def test_nodal_subset_weights_vs_jax():
    full = tools_torch.NodalSubsetBasis(4, [(0, 1, 2, 3), (0, 1, 2, 3)])
    assert np.abs(full.w - np.asarray(basis_torch.GLL(4).w)).max() < 1e-14
    subsets = [(0, 1, 2, 4), (1, 2, 3, 5), (0, 2, 3, 4, 5)]
    got = tools_torch.NodalSubsetBasis(6, subsets).w
    ref = tools_jax.NodalSubsetBasis(6, subsets).w
    assert np.abs(got - ref).max() <= 1e-12


def test_metrics_tracker_semantics():
    mt = tools_torch.MetricsTracker(6)
    assert np.array_equal(mt.pum_bins, tools_jax.MetricsTracker(6).pum_bins)
    m1 = [1e-3, 1e-3, 1e-3]
    assert mt.acceptable_metrics(m1)
    assert mt.would_update(m1, 1e-6)
    mt.update(m1, 1e-6)
    assert not mt.would_update([2e-3, 2e-3, 2e-3], 1e-6)
    assert mt.would_update([2e-3, 2e-3, 2e-3], 1e-12)
    assert mt.would_update([1e-4, 2e-3, 2e-3], 1e-6)
    mt.set_pum_max(1e-8)
    assert not mt.would_update([1e-5] * 3, 1e-6)


@pytest.mark.slow
def test_candidates_and_search_vs_jax():
    # ~12 s on a CPU core: both packages' two-stage search.
    sig = (3, 4)
    assert list(tools_torch.enumerate_nodal_candidates(4, sig)) \
        == list(tools_jax.enumerate_nodal_candidates(4, sig))
    osn, res = tools_torch.search_nodal_given_bestosn(
        4, ne=4, ndx=12, max_eval=50, verbose=False)
    osn_j, res_j = tools_jax.search_nodal_given_bestosn(
        4, ne=4, ndx=12, max_eval=50, verbose=False)
    assert [r[0] for r in osn] == [r[0] for r in osn_j]
    assert np.allclose([r[1:] for r in osn], [r[1:] for r in osn_j],
                       rtol=1e-12, atol=1e-12)
    assert res[0]["subsets"] == ((0, 1, 2), (0, 1, 2, 3))
    assert abs(res[0]["a1"] - 1.575830e-02) < 1e-7
    assert [r["subsets"] for r in res] == [r["subsets"] for r in res_j]
    for r, rj in zip(res, res_j):
        for k in ("meam1", "a1", "a2", "ainf", "pum"):
            assert abs(r[k] - rj[k]) <= 1e-12, k
    cand = tools_torch.evaluate_nodal_candidate(4, ((0, 1, 2), (0, 1, 2, 3)),
                                                stab_ne=8, stab_ndx=6)
    ref = tools_jax.evaluate_nodal_candidate(4, ((0, 1, 2), (0, 1, 2, 3)),
                                             stab_ne=8, stab_ndx=6)
    assert cand.keys() == ref.keys()
    for k in ("meam1", "a1", "a2", "ainf", "pum"):
        assert abs(cand[k] - ref[k]) <= 1e-12, k
