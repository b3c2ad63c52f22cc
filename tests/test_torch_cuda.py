"""The port's CUDA kernels, f64 and f32, against their plain PyTorch
versions on the card (bitwise; --fmad=false keeps the kernels' arithmetic
that of the eager ops). Marked `cuda`: they skip on a machine without a
GPU. On the GPU machine: python -m pytest tests/test_torch_cuda.py -q
(chip_smoke.py runs the same comparisons at the flagship shapes).
"""

import numpy as np
import pytest
import torch

from compose_tpu_torch import _native
from compose_tpu_torch.mesh import cubed_sphere
from compose_tpu_torch.transport import cdr_fused, dss

pytestmark = pytest.mark.cuda
F32 = torch.float32


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda", 0)


def _t(x, dev, dtype=torch.float64):
    return torch.tensor(x, dtype=dtype, device=dev)


def _glbl_caas_case(dev, nt, ncell, dtype):
    rng = np.random.default_rng(ncell)
    mn = rng.uniform(0, 1, (nt, ncell))
    mx = mn + rng.uniform(0, 1, (nt, ncell))
    ms = rng.uniform(-0.5, 2.5, (nt, ncell))
    ex = rng.uniform(-1, 1, nt)
    args = [_t(a, dev, dtype) for a in (mn, ms, mx, ex)]
    k = _native.kernel("glbl_caas", dtype)
    before = k.launches
    out = cdr_fused.glbl_caas(*args)
    assert k.launches == before + 1 and out.dtype == dtype
    assert torch.equal(out, cdr_fused.glbl_caas_plain(*args))


# ncell 1 (one lane), 96 (one warp), 5400 (a full cluster, all-padding
# blocks) and 86400 (more cells than the cluster's threads hold: rounds).
K1_CASES = [(1, 96), (3, 96), (40, 5400), (2, 1), (1, 1), (40, 1), (40, 96),
            (1, 5400), (1, 86400), (40, 86400)]


@pytest.mark.parametrize("nt,ncell", K1_CASES)
def test_glbl_caas_kernel(dev, nt, ncell):
    _glbl_caas_case(dev, nt, ncell, torch.float64)


@pytest.mark.parametrize("nt,ncell", K1_CASES)
def test_glbl_caas_kernel_f32(dev, nt, ncell):
    _glbl_caas_case(dev, nt, ncell, F32)


def test_glbl_caas_kernel_1d(dev):
    # The rho call: 1-D records and a 0-d extra mass.
    rng = np.random.default_rng(5)
    mn = rng.uniform(0, 1, 5400)
    args = [_t(a, dev) for a in (mn, rng.uniform(-0.5, 2.5, 5400),
                                 mn + rng.uniform(0, 1, 5400))]
    args.append(_t(0.25, dev))
    out = cdr_fused.glbl_caas(*args)
    assert out.shape == (5400,)
    assert torch.equal(out, cdr_fused.glbl_caas_plain(*args))


def test_glbl_caas_kernel_refuses_bad_geometry(dev):
    x = torch.zeros((1, 96), dtype=torch.float64, device=dev)
    ex = torch.zeros(1, dtype=torch.float64, device=dev)
    k = _native.kernel("glbl_caas", torch.float64)
    with pytest.raises(RuntimeError, match="cudaError"):
        k(x.data_ptr(), x.data_ptr(), x.data_ptr(), ex.data_ptr(),
          x.data_ptr(), 1, 96, 1, 1, 32, 4, 2,   # 256 pieces for npad 128
          stream=_native.stream_of(x))


def _limit_caas_case(dev, dtype):
    rng = np.random.default_rng(1)
    nt, ncell = 5, 216
    rho = rng.uniform(0.5, 1.5, (ncell, 16))
    rho[rng.random((ncell, 16)) < 0.05] = 0.0
    rhom = rng.uniform(0.5, 1.5, (ncell, 16)) * 1e-3 * rho
    qmin = rng.uniform(0, 0.5, (nt, ncell, 16))
    qmax = qmin + rng.uniform(0, 0.5, (nt, ncell, 16))
    Q = rng.uniform(-0.2, 1.2, (nt, ncell, 16)) * rho
    b = (rhom * rng.uniform(-0.1, 1.1, (nt, ncell, 16))).sum(-1)
    args = [_t(a, dev, dtype) for a in (rhom, rho, Q, qmin, qmax, b)]
    k = _native.kernel("limit_caas", dtype)
    before = k.launches
    out = cdr_fused.limit_caas(*args)
    assert k.launches == before + 1 and out.dtype == dtype
    assert torch.equal(out, cdr_fused.limit_caas_plain(*args))
    assert bool((out >= args[3]).all()) and bool((out <= args[4]).all())


def test_limit_caas_kernel(dev):
    _limit_caas_case(dev, torch.float64)


def test_limit_caas_kernel_f32(dev):
    _limit_caas_case(dev, F32)


def _dss_q_case(dev, ne, nt, dtype):
    mesh = cubed_sphere.build(ne, 4, device=dev, dtype=dtype)
    rng = np.random.default_rng(nt)
    ndg = mesh.ncell * mesh.np2
    # 20% of the nodes with every slot at zero density (the F fallback).
    idx, mask = mesh.c2d_idx.cpu().numpy(), mesh.c2d_mask.cpu().numpy()
    rho = rng.uniform(0.5, 1.5, ndg)
    nodes = rng.choice(mesh.cnn, mesh.cnn // 5, replace=False)
    rho[idx[nodes][mask[nodes]]] = 0.0
    rho[rng.random(ndg) < 0.02] = 0.0
    F = mesh.dgbfi_gll.reshape(-1).contiguous()
    d2c = mesh.dgll2cgll.reshape(-1)
    args = (F * _t(rho, dev, dtype), F,
            _t(rng.uniform(0, 1, (nt, ndg)), dev, dtype),
            mesh.c2d_idx, mesh.c2d_mask, d2c)
    ref = dss.dss_q_plain(*args)
    k = _native.kernel("dss_q", dtype)
    before = k.launches
    out = dss.dss_q(*args)
    assert k.launches == before + 1 and out.dtype == dtype
    assert torch.equal(out, ref)
    slots = dss.slot_table(mesh.c2d_idx, mesh.c2d_mask, d2c)
    assert torch.equal(dss.dss_q(*args, slots=slots), ref)
    # The density DSS (w = F).
    assert torch.equal(dss.dss_gather_t(args[2], d2c, mesh.c2d_idx,
                                        mesh.c2d_mask, F, slots),
                       dss.dss_q_plain(F, F, *args[2:]))


DSS_CASES = [(4, 1), (4, 4), (4, 40), (30, 1), (30, 40)]


@pytest.mark.parametrize("ne,nt", DSS_CASES)
def test_dss_q_kernel(dev, ne, nt):
    _dss_q_case(dev, ne, nt, torch.float64)


@pytest.mark.parametrize("ne,nt", DSS_CASES)
def test_dss_q_kernel_f32(dev, ne, nt):
    _dss_q_case(dev, ne, nt, F32)
