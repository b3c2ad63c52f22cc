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
            (1, 5400), (1, 86400), (40, 86400),
            # The cell counts of ne3, ne6 and ne15 (np8 and np12 rows).
            (1, 54), (40, 54), (1, 216), (40, 216), (1, 1350), (40, 1350)]


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


def _limit_caas_case(dev, dtype, nt=5, ncell=216, np2=16):
    rng = np.random.default_rng(np2 * 1000 + nt)
    rho = rng.uniform(0.5, 1.5, (ncell, np2))
    rho[rng.random((ncell, np2)) < 0.05] = 0.0
    rhom = rng.uniform(0.5, 1.5, (ncell, np2)) * 1e-3 * rho
    qmin = rng.uniform(0, 0.5, (nt, ncell, np2))
    qmax = qmin + rng.uniform(0, 0.5, (nt, ncell, np2))
    Q = rng.uniform(-0.2, 1.2, (nt, ncell, np2)) * rho
    b = (rhom * rng.uniform(-0.1, 1.1, (nt, ncell, np2))).sum(-1)
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


# Every np2 the ISL options launch K2 at (np 2, 3, 4, 6, 8, 12, 16): one or
# several cells per warp (np2 <= 32), a cell over 2 or 8 warps (64, 144 in
# 256 lanes, 256), and odd np2 with idle padding lanes.
K2_NP2 = [4, 9, 16, 36, 64, 144, 256]


@pytest.mark.parametrize("nt", [1, 40])
@pytest.mark.parametrize("np2", K2_NP2)
@pytest.mark.parametrize("dtype", [torch.float64, F32], ids=["f64", "f32"])
def test_limit_caas_kernel_any_np(dev, dtype, np2, nt):
    _limit_caas_case(dev, dtype, nt=nt, ncell=54, np2=np2)


def test_limit_caas_kernel_refuses_np2_over_256(dev):
    x = torch.zeros((1, 1, 289), dtype=torch.float64, device=dev)
    with pytest.raises(RuntimeError, match="cudaError"):
        cdr_fused.limit_caas(x[0], x[0], x, x, x, x[..., 0])


def _dss_q_case(dev, ne, nt, dtype, n=4, measure="gll"):
    mesh = cubed_sphere.build(ne, n, device=dev, dtype=dtype)
    rng = np.random.default_rng(nt)
    ndg = mesh.ncell * mesh.np2
    # 20% of the nodes with every slot at zero density (the F fallback).
    idx, mask = mesh.c2d_idx.cpu().numpy(), mesh.c2d_mask.cpu().numpy()
    rho = rng.uniform(0.5, 1.5, ndg)
    nodes = rng.choice(mesh.cnn, mesh.cnn // 5, replace=False)
    rho[idx[nodes][mask[nodes]]] = 0.0
    rho[rng.random(ndg) < 0.02] = 0.0
    F = getattr(mesh, f"dgbfi_{measure}").reshape(-1).contiguous()
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


# np 6, 8 and 12 with the sphere measure (dmc es), as the new paths run.
DSS_NP_CASES = [(6, 6, 1), (6, 6, 40), (6, 8, 40), (15, 8, 40), (3, 12, 1),
                (3, 12, 40)]


@pytest.mark.parametrize("ne,n,nt", DSS_NP_CASES)
@pytest.mark.parametrize("dtype", [torch.float64, F32], ids=["f64", "f32"])
def test_dss_q_kernel_any_np_sphere(dev, dtype, ne, n, nt):
    _dss_q_case(dev, ne, nt, dtype, n=n, measure="sphere")


# The card (kernels) against the CPU (plain versions), f64, ne3, 4
# tracers, 2 steps: the caas-node filter and the np8 interp path.
STEP_CASES = {
    "caasnode_es": (4, dict(filter="caas-node", limiter="caas", dmc="es"),
                    {"limit_caas_f64": 1, "dss_q_f64": 2}),
    "np8_interp_eh": (8, dict(filter="caas", limiter="caas",
                              timeint="interp", dmc="eh"),
                      {"glbl_caas_f64": 2, "limit_caas_f64": 1,
                       "dss_q_f64": 2}),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_step_card_vs_cpu(dev, case):
    from compose_tpu_torch import driver
    from compose_tpu_torch.transport import gallery
    from compose_tpu_torch.transport.isl import IslConfig, IslTransport

    n, cfg, want = STEP_CASES[case]
    res = {}
    for d in ("cpu", dev):
        mesh = cubed_sphere.build(3, n, device=d)
        model = IslTransport(mesh, gallery.create_wind("divergent"),
                             IslConfig(ne=3, np_=n, nsub=2, **cfg))
        rho = torch.ones((mesh.ncell, mesh.np2), dtype=torch.float64,
                         device=d)
        q = driver.init_tracers(mesh, ["gaussianhills", "slottedcylinders",
                                       "cosinebells", "xyztrig"])
        for k in _native.KERNELS.values():
            k.launches = 0
        for s in range(2):
            rho, q = model.step(rho, q, s * 14400.0, (s + 1) * 14400.0)
        res[str(d)] = (rho.cpu(), q.cpu())
    launches = {k: v.launches for k, v in _native.KERNELS.items()}
    assert launches == {k: 2 * want.get(k, 0) for k in launches}
    (rc, qc), (rg, qg) = res["cpu"], res[str(dev)]
    assert float((rc - rg).abs().max()) <= 1e-12
    assert float((qc - qg).abs().max()) <= 1e-12


# The cell-integrated methods' call sites, card against CPU, f64, ne3, 4
# tracers, 2 steps of one day: K1 (MassRedistributor caas) and K2 (the caas
# limiter) in the IR CDR, K3 in the d2c DSS and the mixed isl method's DSS.
IR_CASES = {
    "ir_f_caas_caas_d2c": (dict(method="ir", dmc="f", filter="caas",
                                limiter="caas"),
                           {"glbl_caas_f64": 1, "limit_caas_f64": 1,
                            "dss_q_f64": 2}),
    "cdg_es_qlt_mn2_d2c": (dict(method="cdg", dmc="es", filter="qlt",
                                limiter="mn2"), {"dss_q_f64": 2}),
    "ir_eh_caas_caas": (dict(method="ir", dmc="eh", filter="caas",
                             limiter="caas", d2c=False),
                        {"glbl_caas_f64": 1, "limit_caas_f64": 1}),
    "mixed_isl": (dict(method="ir", dmc="eh", filter="none",
                       limiter="none"), {"dss_q_f64": 2}),
}


@pytest.mark.parametrize("case", list(IR_CASES))
def test_ir_step_card_vs_cpu(dev, case):
    from compose_tpu_torch import driver
    from compose_tpu_torch.transport import gallery
    from compose_tpu_torch.transport.ir import IrConfig, IrTransport
    from compose_tpu_torch.transport.isl import IslConfig, IslTransport

    cfg, want = IR_CASES[case]
    res = {}
    for d in ("cpu", dev):
        mesh = cubed_sphere.build(3, 4, device=d)
        wind = gallery.create_wind("divergent")
        ir = IrTransport(mesh, wind, IrConfig(ne=3, nsub=2, **cfg))
        step = ir.step
        if case == "mixed_isl":
            isl = IslTransport(mesh, wind, IslConfig(
                ne=3, filter="qlt", limiter="mn2", rho_isl=False, nsub=2))

            def step(rho, q, ts, tf):
                return isl.step(rho, q, ts, tf,
                                rho_tgt=ir.remap_rho(rho, ts, tf))
        rho = torch.ones((mesh.ncell, mesh.np2), dtype=torch.float64,
                         device=d)
        q = driver.init_tracers(mesh, ["gaussianhills", "slottedcylinders",
                                       "cosinebells", "xyztrig"])
        for k in _native.KERNELS.values():
            k.launches = 0
        for s in range(2):
            rho, q = step(rho, q, s * 86400.0, (s + 1) * 86400.0)
        res[str(d)] = (rho.cpu(), q.cpu())
    launches = {k: v.launches for k, v in _native.KERNELS.items()}
    assert launches == {k: 2 * want.get(k, 0) for k in launches}
    (rc, qc), (rg, qg) = res["cpu"], res[str(dev)]
    assert float((rc - rg).abs().max()) <= 1e-12
    assert float((qc - qg).abs().max()) <= 1e-12
