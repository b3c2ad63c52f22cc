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
                    {"limit_caas_f64": 1, "dss_q_f64": 2, "dopri5_f64": 1,
                     "locate_f64": 1}),
    "np8_interp_eh": (8, dict(filter="caas", limiter="caas",
                              timeint="interp", dmc="eh"),
                      {"glbl_caas_f64": 2, "limit_caas_f64": 1,
                       "dss_q_f64": 2, "dopri5_f64": 1, "locate_ab_f64": 1}),
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
                            "dss_q_f64": 2, "dopri5_f64": 1}),
    "cdg_es_qlt_mn2_d2c": (dict(method="cdg", dmc="es", filter="qlt",
                                limiter="mn2"),
                           {"dss_q_f64": 2, "dopri5_f64": 1,
                            "qlt_tree_f64": 1}),
    "ir_eh_caas_caas": (dict(method="ir", dmc="eh", filter="caas",
                             limiter="caas", d2c=False),
                        {"glbl_caas_f64": 1, "limit_caas_f64": 1,
                         "dopri5_f64": 1}),
    # The remap's cell vertices and the ISL step's nodes: two trajectories;
    # the ISL step's cell location and tracer QLT (its rho is the remap's,
    # unfiltered).
    "mixed_isl": (dict(method="ir", dmc="eh", filter="none",
                       limiter="none"), {"dss_q_f64": 2, "dopri5_f64": 2,
                                         "locate_f64": 1,
                                         "qlt_tree_f64": 1}),
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


# The p-refinement experiments, card against CPU, ne3 with a fine np6
# grid, 4 tracers, 2 steps of one day: K1 on the v-grid rho records and on
# the fine tracers, K3 on the v-grid rho DSS, K2 in the fine limiter (np2
# 36) and, under exp 5, in the t -> v transfer (np2 16) and the first
# step's v -> t transfer (np2 36); cell location on the np4 v grid (the
# weights) and on the np6 fine grid (a, b) once per step each.
PREFINE_CASES = {
    5: {"glbl_caas_f64": 4, "limit_caas_f64": 5, "dss_q_f64": 2,
        "dopri5_f64": 2, "locate_f64": 2, "locate_ab_f64": 2},
    1: {"glbl_caas_f64": 4, "limit_caas_f64": 2, "dss_q_f64": 2,
        "dopri5_f64": 2, "locate_f64": 2, "locate_ab_f64": 2},
}


@pytest.mark.parametrize("exp", list(PREFINE_CASES))
def test_prefine_step_card_vs_cpu(dev, exp):
    from compose_tpu_torch import driver
    from compose_tpu_torch.transport import gallery
    from compose_tpu_torch.transport.prefine import (PRefineConfig,
                                                     PRefineTransport)

    res = {}
    for d in ("cpu", dev):
        mesh_f = cubed_sphere.build(3, 6, device=d)
        model = PRefineTransport(mesh_f, gallery.create_wind("divergent"),
                                 PRefineConfig(ne=3, np_=6, nsub=2,
                                               experiment=exp, dmc="eh"))
        mesh = model.mesh_v if exp == 5 else mesh_f
        rho = torch.ones((mesh.ncell, mesh.np2), dtype=torch.float64,
                         device=d)
        q = driver.init_tracers(mesh, ["gaussianhills", "slottedcylinders",
                                       "cosinebells", "xyztrig"])
        state = None
        for k in _native.KERNELS.values():
            k.launches = 0
        for s in range(2):
            rho, q, state = model.step(rho, q, s * 86400.0,
                                       (s + 1) * 86400.0, state)
        res[str(d)] = (rho.cpu(), q.cpu())
    launches = {k: v.launches for k, v in _native.KERNELS.items()}
    want = PREFINE_CASES[exp]
    assert launches == {k: want.get(k, 0) for k in launches}
    (rc, qc), (rg, qg) = res["cpu"], res[str(dev)]
    assert float((rc - rg).abs().max()) <= 1e-12
    assert float((qc - qg).abs().max()) <= 1e-12


def test_physgrid_toychem_card_vs_cpu(dev):
    from compose_tpu_torch import driver

    kw = dict(ne=4, np_=4, nsteps=2, ics=("toychem1", "toychem2",
                                          "gaussianhills"),
              filter_="caas", limiter="caas", nsub=2, pg=2, verbose=False)
    for k in _native.KERNELS.values():
        k.launches = 0
    card = driver.run(device=dev, **kw)
    launches = {k: v.launches for k, v in _native.KERNELS.items()}
    cpu = driver.run(device="cpu", **kw)
    assert launches["glbl_caas_f64"] == 4 and launches["dss_q_f64"] == 4
    assert launches["limit_caas_f64"] == 2
    assert card.min_e >= 0.0 and card.max_e <= 4.0000001e-06
    assert abs(card.l2_err - cpu.l2_err) <= 1e-12
    assert abs(card.mass_e - cpu.mass_e) <= 1e-12 * abs(cpu.mass_e)


def test_moving_vortices_analytic(dev):
    # tests/test_moving_vortices.py on the card: ne10 np4, 12 steps, the
    # vortex tracer against its analytic field at T, l2 < 5e-2.
    from compose_tpu_torch import driver
    from compose_tpu_torch.ops import sphere
    from compose_tpu_torch.transport import gallery
    from compose_tpu_torch.transport.isl import IslConfig, IslTransport

    mesh = cubed_sphere.build(10, 4, device=dev)
    model = IslTransport(mesh, gallery.create_wind("movingvortices"),
                         IslConfig(ne=10, filter="none", limiter="none",
                                   nsub=8))
    rho = torch.ones((mesh.ncell, mesh.np2), dtype=torch.float64, device=dev)
    q = driver.init_tracers(mesh, ("vortextracer",))
    T = 12 * 86400.0
    for s in range(12):
        rho, q = model.step(rho, q, s * T / 12, (s + 1) * T / 12)
    lat, lon = sphere.xyz2ll(mesh.cell_nodes_xyz.reshape(-1, 3))
    q_exact = gallery.MovingVortices.calc_tracer(T, lat, lon)
    w = mesh.dgbfi_sphere.reshape(-1)
    e = q[0].reshape(-1) - q_exact
    l2 = float(torch.sqrt(torch.sum(w * e * e) / torch.sum(w * q_exact ** 2)))
    assert l2 < 5e-2, l2


# ---------------------------------------------------------------------------
# The sharded paths (compose_tpu_torch/parallel) on the card.

def _sharded_isl(d, ne=4, ns=8):
    from compose_tpu_torch import driver
    from compose_tpu_torch.parallel import ShardedIsl, tile_owner
    from compose_tpu_torch.transport import gallery
    from compose_tpu_torch.transport.isl import IslConfig, IslTransport

    mesh = cubed_sphere.build(ne, 4, device=d)
    model = IslTransport(mesh, gallery.create_wind("divergent"),
                         IslConfig(ne=ne, nsub=2, filter="caas",
                                   limiter="caas"))
    rho = torch.ones((mesh.ncell, 16), dtype=torch.float64, device=d)
    q = driver.init_tracers(mesh, ("gaussianhills", "slottedcylinders",
                                   "cosinebells"))
    return model, ShardedIsl(model, ns, owner=tile_owner(mesh, ns)), rho, q


@pytest.mark.parametrize("dtype", [torch.float64, F32], ids=["f64", "f32"])
def test_dss_q_slots_kernel(dev, dtype):
    # K3/K4 on each shard's slot table: the rows of w, F and q (its slots
    # and the received halo slots) longer than the output, pad rows (all
    # -1) written 0, zero-density nodes on the F fallback.
    _, sh, _, _ = _sharded_isl(dev, ne=5)
    rng = np.random.default_rng(3)
    for t in sh.shards:
        nin = t.F_ext.shape[0]
        assert nin > t.slots.shape[0]
        F = t.F_ext.to(dtype)
        r = _t(rng.uniform(0.5, 1.5, nin), dev, dtype)
        r[torch.tensor(rng.random(nin) < 0.05, device=dev)] = 0.0
        q = _t(rng.uniform(0, 1, (5, nin)), dev, dtype)
        k = _native.kernel("dss_q", dtype)
        before = k.launches
        out = dss.dss_q_slots(F * r, F, q, t.slots)
        assert k.launches == before + 1
        assert torch.equal(out, dss.dss_q_slots_plain(F * r, F, q, t.slots))
        if t.padmask is not None:
            assert bool((out.reshape(5, -1, 16)[:, t.padmask] == 0).all())


def test_sharded_step_card_vs_cpu(dev):
    # The sharded step (8 tiles of ne4, LocalComm) on the card against
    # the CPU, and bitwise against the single-device step on the card;
    # K1 does not launch, K2 once and K3 twice per shard; cell location
    # once per shard and once for the first step's coverage check.
    res = {}
    for d in ("cpu", dev):
        model, sh, rho, q = _sharded_isl(d)
        before = {n: k.launches for n, k in _native.KERNELS.items()}
        out = sh.step(rho, q, 0.0, 8640.0)
        if d != "cpu":
            got = {n: k.launches - before[n]
                   for n, k in _native.KERNELS.items()}
            assert got["glbl_caas_f64"] == 0
            assert got["limit_caas_f64"] == 8 and got["dss_q_f64"] == 16
            assert got["locate_f64"] == 9
            ref = model.step(rho, q, 0.0, 8640.0)
            assert all(torch.equal(a, b) for a, b in zip(out, ref))
        res[str(d)] = [x.cpu() for x in out]
    for a, b in zip(res["cpu"], res[str(dev)]):
        assert float((a - b).abs().max()) <= 1e-12


@pytest.fixture
def one_rank(dev, tmp_path):
    """A one-rank NCCL process group and its ("cells",) mesh on the card."""
    import torch.distributed as dist
    from compose_tpu_torch.parallel import cell_mesh

    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        yield cell_mesh(1, "cuda")
    finally:
        dist.destroy_process_group()


def test_kernels_on_dtensors(dev, one_rank):
    # CUDA DTensors reach K1, K2 and K3 through local_map (K2 cell-sharded
    # when Q is sharded on its cell axis), never their plain versions.
    from torch.distributed.tensor import Shard, distribute_tensor

    rng = np.random.default_rng(5)
    mn = rng.uniform(0, 1, (3, 96))
    k1 = [_t(a, dev) for a in (mn, rng.uniform(-.5, 2.5, (3, 96)),
                               mn + rng.uniform(0, 1, (3, 96)),
                               rng.uniform(-1, 1, 3))]
    rho = rng.uniform(0.5, 1.5, (96, 16))
    qmin = rng.uniform(0, 0.5, (3, 96, 16))
    k2 = [_t(a, dev) for a in (
        rng.uniform(0.5, 1.5, (96, 16)) * 1e-3 * rho, rho,
        rng.uniform(-0.2, 1.2, (3, 96, 16)) * rho, qmin,
        qmin + rng.uniform(0, 0.5, (3, 96, 16)),
        rng.uniform(0, 1e-2, (3, 96)))]
    mesh = cubed_sphere.build(4, 4, device=dev)
    F = mesh.dgbfi_gll.reshape(-1)
    q = _t(rng.uniform(0, 1, (2, F.numel())), dev)
    k3 = (F * 2.0, F, q, mesh.c2d_idx, mesh.c2d_mask,
          mesh.dgll2cgll.reshape(-1))
    k2_pl = [Shard(0)] * 2 + [Shard(1)] * 4
    for name, fn, plain, args, pl in (
            ("glbl_caas_f64", cdr_fused.glbl_caas, cdr_fused.glbl_caas_plain,
             k1, [Shard(0)] * 4),
            ("limit_caas_f64", cdr_fused.limit_caas,
             cdr_fused.limit_caas_plain, k2, k2_pl),
            ("dss_q_f64", dss.dss_q, dss.dss_q_plain, k3, [Shard(0)] * 6)):
        dargs = [distribute_tensor(a, one_rank, [p])
                 if a.is_floating_point() else a for a, p in zip(args, pl)]
        k = _native.KERNELS[name]
        before = k.launches
        out = fn(*dargs)
        assert k.launches == before + 1, name
        assert torch.equal(out.full_tensor(), plain(*args)), name


def test_dtensor_step_card(dev, one_rank):
    # The DTensor step at world size 1 on the card (ne4, caas/caas, 2
    # tracers): the single-device step's bits, through K1, K2, K3 and cell
    # location.
    from compose_tpu_torch import driver
    from compose_tpu_torch.parallel import shard_state, sharded_step
    from compose_tpu_torch.transport import gallery
    from compose_tpu_torch.transport.isl import IslConfig, IslTransport

    mesh = cubed_sphere.build(4, 4, device=dev)
    model = IslTransport(mesh, gallery.create_wind("divergent"),
                         IslConfig(ne=4, filter="caas", limiter="caas",
                                   nsub=2))
    rho = torch.ones((mesh.ncell, 16), dtype=torch.float64, device=dev)
    q = driver.init_tracers(mesh, ["gaussianhills", "slottedcylinders"])
    ref = model.step(rho, q, 0.0, 86400.0)
    before = {n: k.launches for n, k in _native.KERNELS.items()}
    out = sharded_step(model, one_rank)(*shard_state(one_rank, rho, q), 0.0,
                                        86400.0)
    got = {n: k.launches - before[n] for n, k in _native.KERNELS.items()}
    assert (got["glbl_caas_f64"], got["limit_caas_f64"],
            got["dss_q_f64"], got["locate_f64"]) == (2, 1, 2, 1)
    for a, b in zip(out, ref):
        assert float((a.full_tensor() - b).abs().max()) < 1e-13


# ---------------------------------------------------------------------------
# The entry step and the multi-device dry run (tools/dryrun.py) on the card.

def test_entry_step_card(dev):
    # entry()'s step on the card (its default device) against the same
    # step on the CPU; K2 once, K3 twice, the trajectory and cell location
    # kernels once and the QLT kernel twice (rho, tracers) per call, K1
    # never.
    from compose_tpu_torch.tools import dryrun

    fn, (rho, q) = dryrun.entry()
    assert rho.device == dev
    before = {n: k.launches for n, k in _native.KERNELS.items()}
    out = fn(rho, q)
    got = {n: k.launches - before[n] for n, k in _native.KERNELS.items()}
    assert got == {n: {"limit_caas_f64": 1, "dss_q_f64": 2, "dopri5_f64": 1,
                       "locate_f64": 1, "qlt_tree_f64": 2}.get(n, 0)
                   for n in _native.KERNELS}
    fn_cpu, _ = dryrun.entry(device="cpu")
    ref = fn_cpu(rho.cpu(), q.cpu())
    for a, b in zip(out, ref):
        assert float((a.cpu() - b).abs().max()) <= 1e-12


def test_dryrun_multichip_card(dev):
    # dryrun_multichip(8) over LocalComm on the card: bitwise in strips and
    # tiles (it raises otherwise), and every byte of the accounting, the
    # measured leg included, equal to the JAX package's committed output.
    import json
    import pathlib

    from compose_tpu_torch.tools import dryrun

    acct = dryrun.dryrun_multichip(8)
    root = pathlib.Path(__file__).resolve().parents[1]
    want = json.loads((root / "MULTICHIP_comm.json").read_text())
    assert set(acct) == set(want)
    for k, row in want.items():
        for name, v in row.items():
            if name.endswith("_bytes"):
                assert acct[k][name] == v, (k, name)


# ---------------------------------------------------------------------------
# The trajectory kernel (csrc/dopri5.cu) against the eager chain, bitwise.

DT = 86400.0 * 12 / 120          # the benchmark's step: T / 120
CELL_OPTIONS = {"isl_caas": dict(filter="caas", limiter="caas",
                                 geom_dtype="f32", interp_dtype="f32"),
                "isl_qlt": dict(filter="qlt", limiter="mn2")}


def _dopri5_case(p, wind_name, ts, tf, nsub):
    from compose_tpu_torch.transport import gallery, timeint

    wind = gallery.create_wind(wind_name)
    k = _native.kernel("dopri5", p.dtype)
    before = k.launches
    got = timeint.integrate(wind.velocity, ts, tf, p, nsub)
    assert k.launches == before + (nsub + 7) // 8
    want = timeint.integrate_plain(wind.velocity, ts, tf, p, nsub)
    assert torch.equal(got, want), (wind_name, ts, tf, nsub, int(
        (got != want).any(-1).sum()))


@pytest.mark.parametrize("dtype", [torch.float64, F32], ids=["f64", "f32"])
def test_dopri5_kernel_ne30_every_step_time(dev, dtype):
    # The ne30 np4 CGLL nodes, backward over each of the 240 steps of the
    # benchmark's period (two of the wind's), 8 substeps.
    p = cubed_sphere.build(30, 4, device=dev).cgll_xyz.to(dtype)
    for k in range(240):
        _dopri5_case(p, "divergent", (k + 1) * DT, k * DT, 8)


@pytest.mark.parametrize("nsub", [1, 3, 8, 20])
@pytest.mark.parametrize("wind_name", ["divergent", "nondivergent"])
@pytest.mark.parametrize("dtype", [torch.float64, F32], ids=["f64", "f32"])
def test_dopri5_kernel_cloud_and_poles(dev, dtype, wind_name, nsub):
    # Seeded points off the unit sphere and points on the polar axis (the
    # frames' polar branches); nsub 20 chains three launches.
    rng = np.random.default_rng(nsub)
    p = rng.normal(size=(5000, 3)) * rng.uniform(0.5, 1.5, (5000, 1))
    p = np.concatenate([p, [[0, 0, 1.0], [0, 0, -1.0], [0, 0, 0.9],
                            [0, 0, -1.1], [1e-200, 0, 1.0]]])
    p = _t(p, dev, dtype)
    for ts, tf in ((37 * DT, 36 * DT), (0.0, DT), (5000.0, 9000.0)):
        _dopri5_case(p, wind_name, ts, tf, nsub)


def test_dopri5_kernel_shard_nodes(dev):
    # The four-card cell's per-rank points: each strip shard's nodes of
    # ShardedIsl(model, 4) at ne30, in f32, through _departure_points.
    from compose_tpu_torch.parallel import ShardedIsl
    from compose_tpu_torch.transport import gallery, timeint
    from compose_tpu_torch.transport.isl import IslConfig, IslTransport

    mesh = cubed_sphere.build(30, 4, device=dev)
    model = IslTransport(mesh, gallery.create_wind("divergent"),
                         IslConfig(ne=30, nsub=8, **CELL_OPTIONS["isl_caas"]))
    k = _native.kernel("dopri5", F32)
    for t in ShardedIsl(model, 4).shards:
        before = k.launches
        got = model._departure_points(36 * DT, 37 * DT, t.nodes)
        assert k.launches == before + 1
        want = timeint.integrate_plain(model.wind.velocity, 37 * DT, 36 * DT,
                                       mesh.cgll_xyz[t.nodes].to(F32), 8)
        assert torch.equal(got, want)


@pytest.mark.parametrize("cell", list(CELL_OPTIONS))
def test_dopri5_step_bitwise_vs_eager(dev, cell, monkeypatch):
    # One ne30 step of each one-card cell's options (4 tracers) with the
    # kernel, then with it turned off (no wind of native form): bitwise,
    # and the tracer counts one kernel call, then one eager call.
    from compose_tpu_torch import driver, trace
    from compose_tpu_torch.transport import gallery, timeint
    from compose_tpu_torch.transport.isl import IslConfig, IslTransport

    mesh = cubed_sphere.build(30, 4, device=dev)
    model = IslTransport(mesh, gallery.create_wind("divergent"),
                         IslConfig(ne=30, nsub=8, **CELL_OPTIONS[cell]))
    rho = torch.ones((mesh.ncell, 16), dtype=torch.float64, device=dev)
    q = driver.init_tracers(mesh, ["gaussianhills", "slottedcylinders",
                                   "cosinebells", "xyztrig"])
    trace.reset()
    trace.enable()
    try:
        out = model.step(rho, q, 36 * DT, 37 * DT)
        on = dict(trace.summary()["counters"])
        trace.reset()
        monkeypatch.setattr(gallery.DivergentWindField, "native", None)
        ref = model.step(rho, q, 36 * DT, 37 * DT)
        off = dict(trace.summary()["counters"])
    finally:
        trace.disable()
        trace.reset()
    assert on.get("trajectory.kernel") == 1 and "trajectory.eager" not in on
    assert off.get("trajectory.eager") == 1 and "trajectory.kernel" not in off
    assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])


def test_dopri5_kernel_refuses_bad_points(dev):
    # The wrapper refuses what the kernel cannot read; `integrate` gives it
    # a contiguous (N, 3) copy of strided points and of other shapes, and
    # equals the eager chain on that copy (the chain's norm sums a strided
    # row in another order than a contiguous one).
    from compose_tpu_torch.transport import gallery, timeint

    wind = gallery.create_wind("divergent")
    rng = np.random.default_rng(2)
    strided = _t(rng.normal(size=(3, 64)), dev).t()
    assert strided.shape == (64, 3) and not strided.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        timeint.dopri5(wind, DT, 0.0, strided)
    with pytest.raises(TypeError, match="no kernel"):
        timeint.dopri5(wind, DT, 0.0, strided.contiguous().half())
    with pytest.raises(ValueError, match=r"\(N, 3\)"):
        timeint.dopri5(wind, DT, 0.0, _t(rng.normal(size=(64, 4)), dev))
    k = _native.kernel("dopri5", torch.float64)
    for p in (strided, strided.reshape(8, 8, 3), strided.contiguous()):
        before = k.launches
        got = timeint.integrate(wind.velocity, DT, 0.0, p, 8)
        assert k.launches == before + 1 and got.shape == p.shape
        want = timeint.integrate_plain(wind.velocity, DT, 0.0,
                                       p.reshape(-1, 3).contiguous(), 8)
        assert torch.equal(got, want.reshape(p.shape))


@pytest.mark.parametrize("dtype", [torch.float64, F32], ids=["f64", "f32"])
def test_dopri5_kernel_on_dtensors(dev, one_rank, dtype):
    # CUDA DTensor points reach the kernel through local_map, in their own
    # placements, never the eager chain.
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from compose_tpu_torch.transport import gallery, timeint

    wind = gallery.create_wind("divergent")
    rng = np.random.default_rng(7)
    p = _t(rng.normal(size=(96, 3)), dev, dtype)
    want = timeint.integrate_plain(wind.velocity, 37 * DT, 36 * DT, p, 8)
    k = _native.kernel("dopri5", dtype)
    for pl in (Shard(0), Replicate()):
        before = k.launches
        got = timeint.integrate(wind.velocity, 37 * DT, 36 * DT,
                                distribute_tensor(p, one_rank, [pl]), 8)
        assert k.launches == before + 1
        assert got.placements == (pl,)
        assert torch.equal(got.full_tensor(), want)


# ---------------------------------------------------------------------------
# The QLT tree kernel (csrc/qlt_tree.cu) against the eager level loop,
# bitwise: the sign of zero included, NaN where both are.

def _qlt_args(dev, ncell, nt, dtype, kind, seed=0):
    from qlt_cases import qlt_case

    return [x.to(dev) for x in qlt_case(ncell, nt, dtype, kind, seed)]


def _qlt_same(a, b):
    from qlt_cases import same_bits

    return same_bits(a.cpu(), b.cpu())


def _qlt_kernel_case(solver, rhom, Qm, lo, hi, extra):
    k = _native.kernel("qlt_tree", Qm.dtype)
    before = k.launches
    got = solver.run(rhom, Qm, lo, hi, root_extra=extra)
    assert k.launches == before + 1
    want = solver.run_plain(rhom, Qm, lo, hi, root_extra=extra)
    assert got.dtype == Qm.dtype and _qlt_same(got, want), (
        solver.ncells, tuple(Qm.shape), int((got != want).sum()))


QLT_KINDS = ["perturbed", "feasible", "infeasible", "ties"]


@pytest.mark.parametrize("kind", QLT_KINDS)
@pytest.mark.parametrize("ncell", [1, 2, 3, 7, 96, 1350, 5400])
@pytest.mark.parametrize("nt", [1, 40])
@pytest.mark.parametrize("dtype", [torch.float64, F32], ids=["f64", "f32"])
def test_qlt_tree_kernel(dev, dtype, nt, ncell, kind):
    # Odd counts make single-kid nodes; "feasible" passes every node's
    # masses through (no_change), "infeasible" takes the corners, "ties"
    # ties the wall crossings and makes signed zeros. A zero, a per-row
    # and a shared root extra, and none.
    from compose_tpu_torch.cdr import qlt

    rhom, Qm, lo, hi, extra = _qlt_args(dev, ncell, nt, dtype, kind,
                                        seed=ncell + nt)
    solver = qlt.QLT(ncell)
    for ex in (extra, torch.zeros_like(extra), extra[:1], None):
        _qlt_kernel_case(solver, rhom, Qm, lo, hi, ex)


@pytest.mark.parametrize("dtype", [torch.float64, F32], ids=["f64", "f32"])
def test_qlt_tree_kernel_many_seeds(dev, dtype):
    # The benchmark's shape, 40 tracers of 5400 cells, over 30 draws.
    from compose_tpu_torch.cdr import qlt

    solver = qlt.QLT(5400)
    for seed in range(30):
        kind = QLT_KINDS[seed % len(QLT_KINDS)]
        _qlt_kernel_case(solver, *_qlt_args(dev, 5400, 40, dtype, kind,
                                            seed=1000 + seed))


def test_qlt_tree_kernel_strided_inputs(dev):
    # Transposed masses and bounds, a strided density, an expanded extra:
    # the kernel reads contiguous copies.
    from compose_tpu_torch.cdr import qlt

    rhom, Qm, lo, hi, extra = _qlt_args(dev, 1350, 40, torch.float64,
                                        "perturbed")
    args = [x.t().contiguous().t() for x in (Qm, lo, hi)]
    assert not args[0].is_contiguous()
    r2 = torch.stack([rhom, rhom]).t().reshape(-1)[::2]
    assert not r2.is_contiguous()
    solver = qlt.QLT(1350)
    for ex in (extra, extra[3].expand(40), extra[::1]):
        _qlt_kernel_case(solver, r2, *args, ex)


def test_qlt_tree_kernel_imbalanced_tree(dev):
    from compose_tpu_torch.cdr import qlt

    solver = qlt.QLT(1000, imbalanced_tree=True)
    for dtype in (torch.float64, F32):
        _qlt_kernel_case(solver, *_qlt_args(dev, 1000, 7, dtype,
                                            "perturbed"))


@pytest.mark.parametrize("dtype", [torch.float64, F32], ids=["f64", "f32"])
def test_qlt_tree_kernel_on_dtensors(dev, one_rank, dtype):
    # CUDA DTensors reach the kernel through local_map, never the eager
    # loop; the result is replicated.
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from compose_tpu_torch.cdr import qlt

    rhom, Qm, lo, hi, extra = _qlt_args(dev, 96, 4, dtype, "perturbed")
    solver = qlt.QLT(96)
    want = solver.run_plain(rhom, Qm, lo, hi, root_extra=extra)
    k = _native.kernel("qlt_tree", dtype)
    for pl in (Shard(1), Replicate()):
        d = [distribute_tensor(x, one_rank, [p]) for x, p in (
            (rhom, Shard(0) if pl != Replicate() else pl), (Qm, pl),
            (lo, pl), (hi, pl), (extra, Replicate()))]
        before = k.launches
        got = solver.run(*d[:4], root_extra=d[4])
        assert k.launches == before + 1
        assert _qlt_same(got.full_tensor(), want)


@pytest.mark.parametrize("ncell,nshards", [(5400, 8), (5400, 4), (1350, 16),
                                           (96, 3)])
def test_sharded_qlt_equals_the_kernel(dev, ncell, nshards):
    # ShardedQLT keeps its own schedule (eager levels per shard and the
    # frontier gather); its result is the kernel's, bitwise.
    from compose_tpu_torch.cdr import qlt
    from compose_tpu_torch.cdr.qlt_sharded import ShardedQLT
    from compose_tpu_torch.parallel.comm import LocalComm

    rhom, Qm, lo, hi, extra = _qlt_args(dev, ncell, 40, torch.float64,
                                        "perturbed")
    single = qlt.QLT(ncell).run(rhom, Qm, lo, hi, root_extra=extra)
    sq = ShardedQLT(ncell, nshards)
    comm = LocalComm(nshards, dev)
    blk = [sq.scatter_leaves(x).reshape(40, nshards, -1) for x in
           (Qm, lo, hi)]
    rb = sq.scatter_leaves(rhom, fill=1.0).reshape(nshards, -1)
    out = comm.run(lambda c: sq.run(c, rb[c.rank],
                                    *(b[:, c.rank] for b in blk),
                                    root_extra=extra))
    assert _qlt_same(sq.gather_leaves(torch.cat(out, -1)), single)


def test_qlt_step_bitwise_vs_eager(dev, monkeypatch):
    # One ne30 step of the QLT cell's options (4 tracers) with the kernel,
    # then with the eager loop: bitwise; the tracer counts two kernel runs
    # (rho, tracers), then two eager runs.
    from compose_tpu_torch import driver, trace
    from compose_tpu_torch.cdr import qlt
    from compose_tpu_torch.transport import gallery
    from compose_tpu_torch.transport.isl import IslConfig, IslTransport

    mesh = cubed_sphere.build(30, 4, device=dev)
    model = IslTransport(mesh, gallery.create_wind("divergent"),
                         IslConfig(ne=30, nsub=8, **CELL_OPTIONS["isl_qlt"]))
    rho = torch.ones((mesh.ncell, 16), dtype=torch.float64, device=dev)
    q = driver.init_tracers(mesh, ["gaussianhills", "slottedcylinders",
                                   "cosinebells", "xyztrig"])
    trace.reset()
    trace.enable()
    try:
        out = model.step(rho, q, 36 * DT, 37 * DT)
        on = dict(trace.summary()["counters"])
        trace.reset()
        monkeypatch.setattr(qlt.QLT, "takes_kernel", lambda *a: False)
        ref = model.step(rho, q, 36 * DT, 37 * DT)
        off = dict(trace.summary()["counters"])
    finally:
        trace.disable()
        trace.reset()
    assert on.get("qlt.kernel") == 2 and "qlt.eager" not in on
    assert off.get("qlt.eager") == 2 and "qlt.kernel" not in off
    assert _qlt_same(out[0], ref[0]) and _qlt_same(out[1], ref[1])


def test_qlt_tree_kernel_takes_or_refuses(dev):
    # On the card the spf type always takes the kernel: a number for the
    # extra is taken (bitwise to the loop), an operand of another dtype or
    # device raises; nothing falls back to the eager loop.
    from compose_tpu_torch.cdr import qlt

    rhom, Qm, lo, hi, extra = _qlt_args(dev, 96, 4, torch.float64,
                                        "perturbed")
    solver = qlt.QLT(96)
    _qlt_kernel_case(solver, rhom, Qm, lo, hi, 0.5)
    k = _native.kernel("qlt_tree", torch.float64)
    before = k.launches
    for args, err in (((rhom, Qm, lo, hi, extra.float()), TypeError),
                      ((rhom, Qm, lo, hi, extra.cpu()), ValueError),
                      ((rhom.cpu(), Qm, lo, hi, extra), ValueError),
                      ((rhom, Qm.half(), lo, hi, extra), TypeError)):
        with pytest.raises(err):
            solver.run(*args[:4], root_extra=args[4])
    assert k.launches == before


def test_qlt_tree_kernel_refuses_bad_table(dev):
    from compose_tpu_torch.cdr import qlt

    rhom, Qm, lo, hi, extra = _qlt_args(dev, 96, 2, torch.float64,
                                        "perturbed")
    k = _native.kernel("qlt_tree", torch.float64)
    table = qlt.QLT(96)._kernel_table(dev)
    with pytest.raises(RuntimeError, match="cudaError"):
        k(rhom.data_ptr(), lo.data_ptr(), Qm.data_ptr(), hi.data_ptr(),
          None, 0, Qm.data_ptr(), Qm.data_ptr(), table.data_ptr(), 7, 2, 0,
          stream=_native.stream_of(Qm))


# ---------------------------------------------------------------------------
# Cell location (csrc/locate.cu) against the eager chain, bitwise: the
# mesh's dtype and the geometry's, i.e. f32 points with f64 weights (the
# CAAS cell), f64 with f64 (the QLT cell), f32 with f32 (x64 off).

LOCATE_ROUTES = {"f32-f64": (torch.float64, "f32"),
                 "f64-f64": (torch.float64, "f64"),
                 "f32-f32": (F32, "f64")}


def _same_bits(a, b):
    """Equal dtype, shape and bits (-0.0 is not +0.0; NaN equals itself)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        ity = {torch.float64: torch.int64, F32: torch.int32}[a.dtype]
        a, b = a.view(ity), b.view(ity)
    return torch.equal(a, b)


def _locate_model(dev, ne, route, np_=4, basis="GllNodal", rotate=None,
                  **cfg):
    from compose_tpu_torch.transport import gallery
    from compose_tpu_torch.transport.isl import IslConfig, IslTransport

    dtype, geom = LOCATE_ROUTES[route]
    mesh = cubed_sphere.build(ne, np_, basis, device=dev, dtype=dtype,
                              rotate=rotate)
    return IslTransport(mesh, gallery.create_wind("divergent"),
                        IslConfig(ne=ne, np_=np_, basis=basis, nsub=8,
                                  geom_dtype=geom, rotate=rotate, **cfg))


def _locate_case(model, dep, what=""):
    """model._locate(dep) takes one launch of its kernel entry and equals
    model._locate_plain(dep) bit for bit."""
    base = "locate" if model.locator.nodes is not None else "locate_ab"
    k = _native.kernel(base, dep.dtype)
    before = k.launches
    ci, w = model._locate(dep)
    assert k.launches == before + 1, what
    ci0, w0 = model._locate_plain(dep)
    assert torch.equal(ci, ci0), (what, int((ci != ci0).sum()))
    assert _same_bits(w, w0), (what, int((w != w0).any(-1).sum()))
    assert w.dtype == model.real


@pytest.mark.parametrize("route", list(LOCATE_ROUTES))
def test_locate_kernel_ne30_step_times(dev, route):
    # ne30's 48,602 CGLL departure points at step times spread over the
    # benchmark's period.
    model = _locate_model(dev, 30, route)
    for k in (0, 1, 37, 60, 100, 119, 120, 181, 239):
        dep = model._departure_points(k * DT, (k + 1) * DT, None)
        _locate_case(model, dep, f"step {k}")


def _edge_points(mesh):
    """Points on the cube's faces' edges and corners (|x| == |y| == |z|
    ties), on cell edges (the cell corners, edge midpoints, and points
    whose equiangular coordinate is a whole number of cells), with +-0
    components and at the poles, plus a seeded cloud off the sphere."""
    ne = mesh.ne
    s = (-1.0, 1.0)
    pts = [[x, y, z] for x in s for y in s for z in s]
    t = np.linspace(-1, 1, 9)
    for a in t:
        for sx in s:
            for sy in s:
                pts += [[sx, sy, a], [sx, a, sy], [a, sx, sy]]
    for v in ([1, 0, 0], [0, 1, 0], [0, 0, 1]):
        for sg in s:
            for z in (0.0, -0.0):
                p = [sg * c if c else z for c in v]
                pts.append(p)
    pts += [[1, 1, 0], [1, -1, -0.0], [-0.0, 1, 1], [0.5, 0.5, 0.3],
            [0.5, -0.5, 0.5], [-0.3, 0.3, -0.3]]
    g = np.tan(0.25 * np.pi * (2 * np.arange(ne + 1) / ne - 1))
    for u in g:
        for v in g[::3]:
            pts += [[1, u, v], [-1, u, v], [u, 1, v], [u, v, -1]]
    pts = np.array(pts, dtype=np.float64)
    pts = np.concatenate([pts, pts / np.linalg.norm(pts, axis=1,
                                                    keepdims=True)])
    c = mesh.corners.double().cpu().numpy()
    mid = 0.5 * (c + np.roll(c, 1, axis=1))
    rng = np.random.default_rng(17)
    cloud = rng.normal(size=(4000, 3)) * rng.uniform(0.5, 1.5, (4000, 1))
    return np.concatenate([pts, c.reshape(-1, 3), mid.reshape(-1, 3),
                           cloud])


@pytest.mark.parametrize("ne", [4, 30])
@pytest.mark.parametrize("route", list(LOCATE_ROUTES))
def test_locate_kernel_edges_ties_and_poles(dev, route, ne):
    model = _locate_model(dev, ne, route)
    geom = F32 if model.config.geom_dtype == "f32" else model.real
    p = _edge_points(model.mesh)
    _locate_case(model, _t(p, dev, geom), "edge points")
    nodes = model.mesh.cgll_xyz.to(geom).contiguous()
    _locate_case(model, nodes, "CGLL nodes")


@pytest.mark.parametrize("route", ["f32-f64", "f64-f64"])
def test_locate_kernel_rotated_mesh(dev, route):
    model = _locate_model(dev, 12, route, rotate=((0.3, -0.7, 0.2), 0.9))
    assert model.mesh.rot_R is not None
    for k in (0, 50):
        dep = model._departure_points(k * DT, (k + 1) * DT, None)
        _locate_case(model, dep, f"step {k}")
    geom = dep.dtype
    _locate_case(model, _t(_edge_points(model.mesh), dev, geom), "edges")


def test_locate_kernel_shard_nodes(dev):
    # The four-card cell's per-rank points: each strip shard's nodes of
    # ShardedIsl(model, 4) at ne30 through _departure_data.
    from compose_tpu_torch.parallel import ShardedIsl

    model = _locate_model(dev, 30, "f32-f64", filter="caas", limiter="caas",
                          interp_dtype="f32")
    k = _native.kernel("locate", F32)
    for t in ShardedIsl(model, 4).shards:
        before = k.launches
        dep, ci, w = model._departure_data(36 * DT, 37 * DT, t.nodes)
        assert k.launches == before + 1
        ci0, w0 = model._locate_plain(dep)
        assert torch.equal(ci, ci0) and _same_bits(w, w0)


@pytest.mark.parametrize("np_,basis", [(3, "GllNodal"), (8, "GllNodal"),
                                       (6, "GllOffsetNodal"), (4, "Gll")])
@pytest.mark.parametrize("route", list(LOCATE_ROUTES))
def test_locate_ab_kernel_other_bases(dev, route, np_, basis):
    # Any other basis or np: the kernel's (ci, a, b) entry, the basis's
    # eager weights.
    model = _locate_model(dev, 6, route, np_=np_, basis=basis)
    assert model.locator.nodes is None
    for k in (0, 77):
        dep = model._departure_points(k * DT, (k + 1) * DT, None)
        _locate_case(model, dep, f"np{np_} {basis} step {k}")
    _locate_case(model, _t(_edge_points(model.mesh), dev, dep.dtype),
                 "edges")


def test_locate_other_meshes_stay_eager(dev):
    # The nonuniform and subcell meshes run their own locate on the card,
    # counted as eager; the kernel does not launch.
    from compose_tpu_torch import trace
    from compose_tpu_torch.transport import gallery
    from compose_tpu_torch.transport.isl import IslConfig, IslTransport

    wind = gallery.create_wind("divergent")
    models = [IslTransport(cubed_sphere.build(4, 4, device=dev, nonuni=True),
                           wind, IslConfig(ne=4, nsub=2))]
    sub = cubed_sphere.build(2, 4, device=dev, mesh_type="gllsubcell")
    models.append(IslTransport(sub, wind, IslConfig(
        ne=sub.ne, np_=sub.np_, basis="Gll", nsub=2)))
    before = {n: k.launches for n, k in _native.KERNELS.items()
              if n.startswith("locate")}
    trace.reset()
    trace.enable()
    try:
        for m in models:
            m._departure_data(0.0, DT)
        ctr = dict(trace.summary()["counters"])
    finally:
        trace.disable()
        trace.reset()
    assert ctr.get("locate.eager") == 2 and "locate.kernel" not in ctr
    assert before == {n: k.launches for n, k in _native.KERNELS.items()
                      if n.startswith("locate")}


def test_locate_kernel_refuses_bad_operands(dev):
    # On the card the wrapper launches or raises: another dtype, shape or
    # stride, a corner table of another size or type, weights of another
    # type. Nothing falls back to the eager chain.
    from compose_tpu_torch.transport import locate

    model = _locate_model(dev, 4, "f64-f64")
    dep = model._departure_points(0.0, DT, None)
    corners, _, table = model.locator.constants(dev)
    strided = dep.t().contiguous().t()
    assert not strided.is_contiguous()
    ks = [_native.kernel(b, t) for b in ("locate", "locate_ab")
          for t in (torch.float64, F32)]
    before = [k.launches for k in ks]
    for args, kw, err in (
            ((strided, corners, 4, 4, table), {}, ValueError),
            ((dep.half(), corners, 4, 4, table), {}, TypeError),
            ((dep.float(), corners, 4, 4, table), {}, TypeError),
            ((dep[:, :2].contiguous(), corners, 4, 4, table), {}, ValueError),
            ((dep, corners[:-1], 4, 4, table), {}, ValueError),
            ((dep, corners, 5, 4, table), {}, ValueError),
            ((dep, corners, 4, 4, table[:-1]), {}, ValueError),
            ((dep, corners, 4, 4, table), dict(wdtype=F32), TypeError),
            ((dep, corners, 4, 4, table), dict(p_idx=strided), ValueError),
            ((dep, corners.cpu(), 4, 4, table), {}, ValueError)):
        with pytest.raises(err):
            locate.locate_cells(*args, **kw)
    with pytest.raises(TypeError):
        model._locate(dep.half())
    with pytest.raises(TypeError):
        model._locate(dep.float())
    assert [k.launches for k in ks] == before
    # `_locate` hands the kernel a contiguous copy: a strided input gives
    # the bits of the eager chain on it.
    _locate_case(model, strided, "strided")


def test_locate_kernel_on_dtensors(dev, one_rank):
    # CUDA DTensor points reach the kernel through local_map.
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    model = _locate_model(dev, 6, "f32-f64")
    dep = model._departure_points(0.0, DT, None)
    ci0, w0 = model._locate_plain(dep)
    k = _native.kernel("locate", F32)
    for pl in (Shard(0), Replicate()):
        before = k.launches
        ci, w = model._locate(distribute_tensor(dep, one_rank, [pl]))
        assert k.launches == before + 1
        assert torch.equal(ci.full_tensor(), ci0)
        assert _same_bits(w.full_tensor(), w0)


@pytest.mark.parametrize("cell", list(CELL_OPTIONS))
def test_locate_step_bitwise_vs_eager(dev, cell, monkeypatch):
    # One ne30 step of each one-card cell's options (4 tracers) with the
    # kernel, then with the eager chain: bitwise; the tracer counts one
    # kernel call per step.
    from compose_tpu_torch import driver, trace
    from compose_tpu_torch.transport import gallery
    from compose_tpu_torch.transport.isl import IslConfig, IslTransport

    mesh = cubed_sphere.build(30, 4, device=dev)
    model = IslTransport(mesh, gallery.create_wind("divergent"),
                         IslConfig(ne=30, nsub=8, **CELL_OPTIONS[cell]))
    rho = torch.ones((mesh.ncell, 16), dtype=torch.float64, device=dev)
    q = driver.init_tracers(mesh, ["gaussianhills", "slottedcylinders",
                                   "cosinebells", "xyztrig"])
    trace.reset()
    trace.enable()
    try:
        out = model.step(rho, q, 36 * DT, 37 * DT)
        on = dict(trace.summary()["counters"])
        trace.reset()
        monkeypatch.setattr(model, "_locate", model._locate_plain)
        ref = model.step(rho, q, 36 * DT, 37 * DT)
        off = dict(trace.summary()["counters"])
    finally:
        trace.disable()
        trace.reset()
    assert on.get("locate.kernel") == 1 and "locate.eager" not in on
    assert "locate.kernel" not in off
    assert _same_bits(out[0], ref[0]) and _same_bits(out[1], ref[1])
