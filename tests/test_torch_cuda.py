"""The port's CUDA kernels against their plain PyTorch versions on the card
(bitwise; --fmad=false keeps the kernels' arithmetic that of the eager
ops). Marked `cuda`: they skip on a machine without a GPU. On the GPU
machine: python -m pytest tests/test_torch_cuda.py -q
(chip_smoke.py runs the same comparisons at the flagship shapes).
"""

import numpy as np
import pytest
import torch

from compose_tpu_torch.mesh import cubed_sphere
from compose_tpu_torch.transport import cdr_fused, dss

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda", 0)


def _t(x, dev):
    return torch.tensor(x, dtype=torch.float64, device=dev)


@pytest.mark.parametrize("nt,ncell", [(1, 96), (3, 96), (40, 5400), (2, 1)])
def test_glbl_caas_kernel(dev, nt, ncell):
    rng = np.random.default_rng(ncell)
    mn = rng.uniform(0, 1, (nt, ncell))
    mx = mn + rng.uniform(0, 1, (nt, ncell))
    ms = rng.uniform(-0.5, 2.5, (nt, ncell))
    ex = rng.uniform(-1, 1, nt)
    args = [_t(a, dev) for a in (mn, ms, mx, ex)]
    before = cdr_fused.glbl_caas.launches
    out = cdr_fused.glbl_caas(*args)
    assert cdr_fused.glbl_caas.launches == before + 1
    assert torch.equal(out, cdr_fused.glbl_caas_plain(*args))


def test_limit_caas_kernel(dev):
    rng = np.random.default_rng(1)
    nt, ncell = 5, 216
    rho = rng.uniform(0.5, 1.5, (ncell, 16))
    rho[rng.random((ncell, 16)) < 0.05] = 0.0
    rhom = rng.uniform(0.5, 1.5, (ncell, 16)) * 1e-3 * rho
    qmin = rng.uniform(0, 0.5, (nt, ncell, 16))
    qmax = qmin + rng.uniform(0, 0.5, (nt, ncell, 16))
    Q = rng.uniform(-0.2, 1.2, (nt, ncell, 16)) * rho
    b = (rhom * rng.uniform(-0.1, 1.1, (nt, ncell, 16))).sum(-1)
    args = [_t(a, dev) for a in (rhom, rho, Q, qmin, qmax, b)]
    out = cdr_fused.limit_caas(*args)
    assert torch.equal(out, cdr_fused.limit_caas_plain(*args))
    assert bool((out >= args[3]).all()) and bool((out <= args[4]).all())


@pytest.mark.parametrize("nt", [1, 4])
def test_dss_q_kernel(dev, nt):
    mesh = cubed_sphere.build(4, 4, device=dev)
    rng = np.random.default_rng(nt)
    ndg = mesh.ncell * mesh.np2
    rho = rng.uniform(0.5, 1.5, ndg)
    rho[rng.random(ndg) < 0.2] = 0.0
    F = mesh.dgbfi_gll.reshape(-1).contiguous()
    args = (F * _t(rho, dev), F, _t(rng.uniform(0, 1, (nt, ndg)), dev),
            mesh.c2d_idx, mesh.c2d_mask, mesh.dgll2cgll.reshape(-1))
    assert torch.equal(dss.dss_q(*args), dss.dss_q_plain(*args))
