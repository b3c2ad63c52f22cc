"""The port's sharded ISL and IR steps (compose_tpu_torch.parallel.sharded,
sharded_ir) under LocalComm on the CPU: bitwise equal to the port's
single-device step for every filter, in strips (2 and 8 shards), ragged
blocks (ne5 over 8) and 2-D tiles, with the measured halo, every
trajectory option and np8; the IR projection and full step bitwise; and
within 1e-12 of the JAX package's own sharded steps on its 8 virtual CPU
devices. The card's side is in test_torch_cuda.py (this file imports
jax, which the GPU machine lacks)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compose_tpu import driver as driver_jax
from compose_tpu.parallel.sharded import ShardedIsl as ShardedIslJax
from compose_tpu.parallel.sharded_ir import ShardedIr as ShardedIrJax
from compose_tpu.transport import gallery as gallery_jax
from compose_tpu.transport import isl as isl_jax
from compose_tpu_torch import driver
from compose_tpu_torch.mesh import cubed_sphere
from compose_tpu_torch.parallel.halo import HaloMaps, tile_owner
from compose_tpu_torch.parallel.sharded import ShardedIsl
from compose_tpu_torch.parallel.sharded_ir import ShardedIr
from compose_tpu_torch.transport import gallery
from compose_tpu_torch.transport.ir import IrConfig, IrTransport
from compose_tpu_torch.transport.isl import IslConfig, IslTransport

from torch_parity import ir_models, meshes

DT = 86400.0 * 12 / 120
ICS = ("gaussianhills", "slottedcylinders", "cosinebells")
# (layout, ne, n_shards): strips, ragged strips (150 cells over 8) and the
# 2-D tiles of tile_owner.
LAYOUTS = [("strips", 4, 2), ("strips", 4, 8), ("ragged", 5, 8),
           ("tiles", 4, 8)]
FILTERS = [("caas", "caas"), ("qlt", "mn2"), ("mn2", "caas"),
           ("caas-node", "caas"), ("none", "none")]


@functools.lru_cache(maxsize=None)
def _isl(ne, np_=4, dtype=torch.float64, **cfg):
    mesh = cubed_sphere.build(ne, np_, device="cpu", dtype=dtype)
    model = IslTransport(mesh, gallery.create_wind("divergent"),
                         IslConfig(ne=ne, np_=np_, nsub=2, **cfg))
    rho = torch.ones((mesh.ncell, mesh.np2), dtype=dtype)
    return model, rho, driver.init_tracers(mesh, ICS)


def _sharded(model, layout, ns, **kw):
    owner = tile_owner(model.mesh, ns) if layout == "tiles" else None
    return ShardedIsl(model, ns, owner=owner, **kw)


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("filt,lim", FILTERS)
@pytest.mark.parametrize("layout,ne,ns", LAYOUTS)
def test_sharded_isl_bitwise(layout, ne, ns, filt, lim):
    model, rho, q = _isl(ne, filter=filt, limiter=lim)
    sh = _sharded(model, layout, ns)
    assert sh.coverage_ok(0.0, DT)
    assert (sh.pad > 0) == (layout == "ragged")
    ref = model.step(rho, q, 0.0, DT)
    out = sh.step(rho, q, 0.0, DT)
    assert _same(out, ref)
    # A second step from the sharded state.
    assert _same(sh.step(*out, DT, 2 * DT), model.step(*ref, DT, 2 * DT))


@pytest.mark.parametrize("kw", [
    dict(filter="qlt", limiter="caas", positive_only=True),
    dict(filter="caas", limiter="caas", geom_dtype="f32",
         interp_dtype="f32"),
    dict(filter="caas", limiter="caas", interp_dtype="f32"),
    dict(filter="qlt", limiter="mn2", rho_isl=False),
    dict(filter="caas", limiter="caas", timeint="interp", v_np=2),
    dict(filter="caas", limiter="caags", timeint="line"),
    dict(filter="caas-node", limiter="caas", dmc="es"),
    dict(filter="qlt", limiter="qlt", timeint="interpline", v_np=2),
], ids=["qlt-pve", "f32-geom-interp", "f32-interp", "rho-held",
        "interp-v2", "line-caags", "caas-node-es", "interpline-lqlt"])
def test_sharded_isl_options_bitwise(kw):
    model, rho, q = _isl(4, **kw)
    sh = _sharded(model, "tiles", 8)
    assert _same(sh.step(rho, q, 0.0, DT), model.step(rho, q, 0.0, DT))


def test_sharded_isl_single_precision_route():
    model, rho, q = _isl(4, dtype=torch.float32, filter="qlt",
                         limiter="mn2")
    out = ShardedIsl(model, 8).step(rho, q, 0.0, DT)
    assert out[1].dtype == torch.float32
    assert _same(out, model.step(rho, q, 0.0, DT))


def test_sharded_isl_np8_bitwise():
    # JAX pins its np8 sharded step at 4 ulp (test_sharding.py:606); the
    # port's is bitwise: every contraction is an explicit chain and the
    # departure data are computed per node whatever the batch.
    model, rho, q = _isl(4, np_=8, filter="caas", limiter="caas")
    dt = 86400.0 * 12 / 130
    out = ShardedIsl(model, 8).step(rho, q, 0.0, dt)
    ref = model.step(rho, q, 0.0, dt)
    ulps = max(float(((a - b).abs() / torch.finfo(a.dtype).eps).max())
               for a, b in zip(out, ref))
    assert ulps == 0.0


def test_sharded_isl_measured_halo():
    model, rho, q = _isl(6, filter="caas", limiter="caas")
    ow = tile_owner(model.mesh, 8)
    times = [(s * DT, (s + 1) * DT) for s in range(3)]
    sh = ShardedIsl.with_measured_halo(model, 8, times, owner=ow)
    ring2 = HaloMaps(model.mesh, 8, depth=2, owner=ow)
    assert sh.maps.halo_size <= ring2.halo_size
    st, ref = (rho, q), (rho, q)
    for t0, t1 in times:
        assert sh.coverage_ok(t0, t1)
        st, ref = sh.step(*st, t0, t1), model.step(*ref, t0, t1)
        assert _same(st, ref)
    assert sh.bytes_per_step(3) == (sh.maps.halo_size * 16 * 4
                                    + sh.halo_slots * 5) * 8


def test_sharded_isl_rejects():
    model, _, _ = _isl(4, filter="caas", limiter="caas", fitext=True)
    with pytest.raises(ValueError):
        ShardedIsl(model, 2)
    model, rho, q = _isl(4, filter="caas", limiter="caas")
    sh = ShardedIsl(model, 8, depth=1)
    with pytest.raises(ValueError):      # the halo misses a 6-day step
        sh.step(rho, q, 0.0, 86400.0 * 6)


# ---------------------------------------------------------------------------
# IR / CDG.

@functools.lru_cache(maxsize=None)
def _ir(ne, **cfg):
    mesh = cubed_sphere.build(ne, 4, device="cpu")
    model = IrTransport(mesh, gallery.create_wind("divergent"),
                        IrConfig(ne=ne, nsub=2, **cfg))
    rho = torch.ones((mesh.ncell, 16), dtype=torch.float64)
    return model, rho, driver.init_tracers(mesh, ICS[:2])


_PROJ = dict(filter="none", limiter="none", d2c=False)


@pytest.mark.parametrize("ne,ns,layout,cfg", [
    (5, 8, "strips", dict(method="ir", dmc="ef", **_PROJ)),
    (4, 8, "tiles", dict(method="cdg", dmc="ef", **_PROJ)),
    (4, 8, "tiles", dict(method="ir", dmc="f", **_PROJ)),
    (5, 8, "strips", dict(method="ir", dmc="f", filter="caas",
                          limiter="caas")),
    (4, 8, "tiles", dict(method="ir", dmc="f", filter="qlt",
                         limiter="caas")),
    (4, 3, "tiles", dict(method="cdg", dmc="f", filter="caas",
                         limiter="caags", d2c=False)),
], ids=["proj-ir-ef-ragged", "proj-cdg-ef-tiles", "proj-ir-f-tiles",
        "A-ragged", "ir-f-qlt-tiles", "cdg-f-caags-tiles"])
def test_sharded_ir_bitwise(ne, ns, layout, cfg):
    # The projection (T assembly, shares, the density factor, the per-cell
    # solves) and the full step with CDR and DSS, bitwise (JAX's dryrun_ir
    # holds its full step to 2 ulp).
    model, rho, q = _ir(ne, **cfg)
    owner = tile_owner(model.mesh, ns) if layout == "tiles" else None
    sh = ShardedIr(model, ns, owner=owner)
    dt = 86400.0 / 10
    assert sh.coverage_ok(0.0, dt)
    assert _same(sh.step(rho, q, 0.0, dt), model.step(rho, q, 0.0, dt))


def test_dryrun_ir():
    # The sphere geometry (dmc es): the projection and the full step.
    from compose_tpu_torch.parallel.sharded_ir import dryrun_ir

    assert dryrun_ir(3, device="cpu", ne=3) == [0.0, 0.0]


def test_sharded_ir_rejects():
    model, _, _ = _ir(3, method="ir", dmc="geh", filter="none",
                      limiter="none")
    with pytest.raises(ValueError):
        ShardedIr(model, 2)


# ---------------------------------------------------------------------------
# Against the JAX package's sharded steps (8 virtual CPU devices).

def _jax_isl_models(filt):
    mj, mt = meshes(3)
    kw = dict(ne=3, np_=4, filter=filt, limiter="caas", nsub=2)
    sj = isl_jax.IslTransport(mj, gallery_jax.create_wind("divergent"),
                              isl_jax.IslConfig(**kw))
    st = IslTransport(mt, gallery.create_wind("divergent"), IslConfig(**kw))
    q = np.asarray(driver_jax.init_tracers(mj, ICS[:2]))
    return mj, sj, st, q


@pytest.mark.parametrize("filt", ["caas", "qlt"])
def test_sharded_isl_vs_jax(filt):
    assert len(jax.devices()) >= 8
    mj, sj, st, q = _jax_isl_models(filt)
    rho = np.ones((mj.ncell, mj.np2))
    rj, qj = ShardedIslJax(sj, 8).step(jnp.asarray(rho), jnp.asarray(q),
                                       0.0, DT)
    rt, qt = ShardedIsl(st, 8).step(torch.tensor(rho), torch.tensor(q),
                                    0.0, DT)
    assert np.abs(np.asarray(rj) - rt.numpy()).max() <= 1e-12
    assert np.abs(np.asarray(qj) - qt.numpy()).max() <= 1e-12


def test_sharded_ir_vs_jax():
    assert len(jax.devices()) >= 8
    mj, sj, st = ir_models(3, 4, "geometric", dict(
        method="ir", dmc="f", filter="caas", limiter="caas"))
    q = np.asarray(driver_jax.init_tracers(mj, ICS[:2]))
    rho = np.ones((mj.ncell, mj.np2))
    dt = 86400.0 / 10
    rj, qj = ShardedIrJax(sj, 8).step(jnp.asarray(rho), jnp.asarray(q),
                                      0.0, dt)
    rt, qt = ShardedIr(st, 8).step(torch.tensor(rho), torch.tensor(q),
                                   0.0, dt)
    assert np.abs(np.asarray(rj) - rt.numpy()).max() <= 1e-12
    assert np.abs(np.asarray(qj) - qt.numpy()).max() <= 1e-12
