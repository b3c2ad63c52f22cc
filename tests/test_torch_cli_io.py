"""The diagnostics, outputs and command line of `driver` against compose_tpu,
on the CPU: the Lauritzen diagnostics (1e-12), Observer.dump (the same
keys, masses to 1e-13), the NetCDF writer (tests/test_io.py's round trip,
and the same variables and values as compose_tpu's file), the raster
sampler (tests/test_vis.py's cases, and sample_field against compose_tpu's
on the same mesh to 1e-12), the checkpoint (tests/test_checkpoint.py's
round trip and bitwise resume), and driver.main (JAX's <OL> numbers to
1e-12, and one run with every diagnostic and output flag)."""

import json
import os
import re

import numpy as np
import pytest
import torch
from scipy.io import netcdf_file

import jax.numpy as jnp

from compose_tpu import diagnostics as diag_jax
from compose_tpu import driver as driver_jax
from compose_tpu import io as io_jax
from compose_tpu import vis as vis_jax
from compose_tpu_torch import checkpoint
from compose_tpu_torch import diagnostics as diag_torch
from compose_tpu_torch import driver as driver_torch
from compose_tpu_torch import io as io_torch
from compose_tpu_torch import vis as vis_torch
from compose_tpu_torch.mesh import cubed_sphere as cs_torch
from compose_tpu_torch.ops import sphere as sphere_torch
from compose_tpu_torch.transport import gallery as gallery_torch
from compose_tpu_torch.transport.isl import IslConfig, IslTransport

from torch_parity import meshes, np_, t64

DAY = 86400.0


def _fields(mj, mt, ics, seed):
    """The ICs on both meshes, slightly perturbed by seeded noise."""
    rng = np.random.default_rng(seed)
    q = np.asarray(driver_jax.init_tracers(mj, ics))
    q = np.clip(q + rng.uniform(-0.02, 0.02, q.shape), 0.0, 1.0)
    return jnp.asarray(q), t64(q)


def test_lauritzen_diagnostics_vs_jax():
    mj, mt = meshes(4)
    ics = ("gaussianhills", "cosinebells", "correlatedcosinebells")
    q0j, q0t = _fields(mj, mt, ics, 1)
    qj, qt = _fields(mj, mt, ics, 2)
    dA = mj.dgbfi_sphere
    thr_j, a_j = diag_jax.filament_diag(q0j[1], dA)
    thr_t, a_t = diag_torch.filament_diag(q0t[1], mt.dgbfi_sphere)
    assert np.array_equal(thr_j, thr_t)
    assert np.abs(a_j - a_t).max() <= 1e-12 * np.abs(a_j).max()
    cj = diag_jax.correlation_diag(qj[1], qj[2], dA)
    ct = diag_torch.correlation_diag(qt[1], qt[2], mt.dgbfi_sphere)
    assert max(ct) > 0
    assert np.allclose(ct, cj, rtol=1e-12, atol=0)
    lj = diag_jax.LauritzenDiag(4, ics, q0j, dA)
    lt = diag_torch.LauritzenDiag(4, ics, q0t, mt.dgbfi_sphere)
    assert not lt.run(0, qt) and not lj.run(0, qj)
    assert lt.run(1, qt) and lj.run(1, qj)
    assert sorted(lt.results) == sorted(lj.results)
    for k, v in lj.results.items():
        assert np.allclose(lt.results[k], v, rtol=1e-12, atol=1e-12)


def test_observer_dump_vs_jax(tmp_path):
    mj, mt = meshes(3)
    ics = ("gaussianhills", "cosinebells")
    names = ["rho"] + [f"{n}{i}" for i, n in enumerate(ics)]
    oj = diag_jax.Observer(mj.dgbfi_gll, mj.dgbfi_sphere, names)
    ot = diag_torch.Observer(mt.dgbfi_gll, mt.dgbfi_sphere, names)
    rng = np.random.default_rng(3)
    for t in (0.0, 3600.0):
        qj, qt = _fields(mj, mt, ics, int(t) + 5)
        rho = rng.uniform(0.5, 1.5, (mj.ncell, mj.np2))
        oj.add_obs(t, jnp.asarray(rho), list(qj))
        ot.add_obs(t, t64(rho), list(qt))
    pj, pt = tmp_path / "j.json", tmp_path / "t.json"
    oj.dump(str(pj))
    ot.dump(str(pt))
    dj, dt = json.loads(pj.read_text()), json.loads(pt.read_text())
    assert dj.keys() == dt.keys() and dj["times"] == dt["times"]
    assert list(dj["fields"]) == list(dt["fields"]) == names
    for name in names:
        fj, ft = dj["fields"][name], dt["fields"][name]
        assert fj.keys() == ft.keys()
        for k in ("mass_gll", "mass_sphere"):
            assert np.allclose(ft[k], fj[k], rtol=1e-13, atol=0)
        for k in ("min", "max"):
            assert ft[k] == fj[k]


def _read_nc(path):
    r = netcdf_file(path, "r", mmap=False)
    out = {k: np.array(v[:]) for k, v in r.variables.items()}
    dims = {k: v.dimensions for k, v in r.variables.items()}
    r.close()
    return out, dims


def test_netcdf_roundtrip(tmp_path):
    _, mesh = meshes(3)
    path = str(tmp_path / "out.nc")
    w = io_torch.NetcdfWriter(mesh, path)
    w.add_nodal_field("q")
    w.end_definition()
    f = torch.full((mesh.ncell, mesh.np2), 0.42, dtype=torch.float64)
    w.advance_time_to(0.0)
    w.write_field("q", f, mesh.dgbfi_gll)
    w.advance_time_to(1.0)
    w.write_field("q", 2 * f, mesh.dgbfi_gll)
    w.close()
    v, _ = _read_nc(path)
    assert v["q"].shape == (2, mesh.cnn)
    assert np.allclose(v["q"][0], 0.42) and np.allclose(v["q"][1], 0.84)
    assert v["time"].tolist() == [0.0, 1.0]


def test_netcdf_matches_jax_file(tmp_path):
    mj, mt = meshes(3)
    qj, qt = _fields(mj, mt, ("xyztrig",), 7)
    files = []
    for pkg, mesh, q in ((io_jax, mj, qj[0]), (io_torch, mt, qt[0])):
        path = str(tmp_path / f"{pkg.__name__}.nc")
        w = pkg.NetcdfWriter(mesh, path)
        w.add_nodal_field("density")
        w.add_nodal_field("tracer_xyztrig0")
        w.end_definition()
        w.advance_time_to(0.5)
        w.write_field("density", q * 0 + 1, mesh.dgbfi_sphere)
        w.write_field("tracer_xyztrig0", q, mesh.dgbfi_sphere)
        w.close()
        files.append(_read_nc(path))
    (vj, dj), (vt, dt) = files
    assert dj == dt
    for k in vj:
        assert vt[k].dtype == vj[k].dtype and vt[k].shape == vj[k].shape
        assert np.abs(vt[k] - vj[k]).max() <= 1e-12, k


def test_sample_constant_field():
    _, mesh = meshes(4)
    f = torch.full((mesh.ncell, mesh.np2), 0.42, dtype=torch.float64)
    LA, LO = vis_torch.latlon_grid(17, 32)
    out = vis_torch.sample_field(mesh, f, LA, LO)
    assert out.shape == (17, 32)
    assert np.abs(out - 0.42).max() < 1e-12


def test_sample_smooth_field_accuracy():
    _, mesh = meshes(6)
    p = mesh.cell_nodes_xyz.reshape(-1, 3)
    f = (p[:, 0] * p[:, 2]).reshape(mesh.ncell, mesh.np2)
    LA, LO = vis_torch.latlon_grid(15, 30)
    out = vis_torch.sample_field(mesh, f, LA, LO)
    pr = np_(sphere_torch.ll2xyz(t64(LA), t64(LO)))
    assert np.abs(out - pr[..., 0] * pr[..., 2]).max() < 5e-4


def test_write_raster(tmp_path):
    path = str(tmp_path / "r.bin")
    a = np.arange(12, dtype=np.float64).reshape(3, 4)
    vis_torch.write_raster(path, [a, 2 * a])
    with open(path, "rb") as fh:
        hdr = np.fromfile(fh, np.int32, 3)
        frames = np.fromfile(fh, np.float32).reshape(2, 3, 4)
    assert list(hdr) == [2, 3, 4]
    assert np.allclose(frames[1], 2 * a)


def test_ortho_projection():
    _, mesh = meshes(4)
    q = driver_torch.init_tracers(mesh, ("xyztrig",))[0]
    lat, lon, mask = vis_torch.ortho_grid(33, center_lat=0.4, center_lon=1.0)
    img = vis_torch.sample_field(mesh, q, lat, lon, mask=mask)
    assert img.shape == (33, 33)
    assert np.all(img[~mask] == 0.0)
    ref = np_(gallery_torch.initial_condition(
        "xyztrig", t64(lat[mask].ravel()), t64(lon[mask].ravel())))
    assert np.abs(img[mask].ravel() - ref).max() < 5e-3


@pytest.mark.parametrize("kind", ["geometric", "rotated", "nonuni"])
def test_sample_field_vs_jax(kind):
    kw = dict(rotated=dict(rotate=((0.11111, -0.051515, 1.0), 0.45)),
              nonuni=dict(nonuni=True)).get(kind, {})
    mj, mt = meshes(4, **kw)
    qj, qt = _fields(mj, mt, ("xyztrig", "cosinebells"), 11)
    lat, lon, mask = vis_jax.ortho_grid(21, center_lat=-0.3, center_lon=2.0)
    ref = vis_jax.sample_field(mj, qj, lat, lon, mask=mask)
    out = vis_torch.sample_field(mt, qt, lat, lon, mask=mask)
    assert out.shape == ref.shape == (2, 21, 21)
    assert np.abs(out - ref).max() <= 1e-12


def test_checkpoint_roundtrip(tmp_path):
    _, mesh = meshes(3)
    rho = torch.ones((mesh.ncell, mesh.np2), dtype=torch.float64)
    q = driver_torch.init_tracers(mesh, ("gaussianhills",))
    path = str(tmp_path / "ck")
    checkpoint.save(path, 3, 123.0, rho, q, meta={"ne": 3})
    step, t, rho2, q2, meta = checkpoint.restore(path, device="cpu")
    assert (step, t) == (3, 123.0)
    assert meta["ne"] == 3
    assert torch.equal(rho, rho2) and torch.equal(q, q2)
    assert os.path.exists(os.path.join(path, "compose_meta.json"))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_resume_bitwise(tmp_path, dtype):
    mesh = cs_torch.build(3, 4, device="cpu", dtype=dtype)
    model = IslTransport(mesh, gallery_torch.create_wind("divergent"),
                         IslConfig(ne=3, np_=4, filter="caas",
                                   limiter="caas", nsub=2))
    rho = torch.ones((mesh.ncell, mesh.np2), dtype=dtype)
    q = driver_torch.init_tracers(mesh, ("cosinebells",))
    r1, q1 = model.step(rho, q, 0.0, DAY)
    r2, q2 = model.step(r1, q1, DAY, 2 * DAY)
    path = str(tmp_path / "ck")
    checkpoint.save(path, 1, DAY, r1, q1)
    _, t, rr, qq, _ = checkpoint.restore(path, device="cpu")
    assert rr.dtype == qq.dtype == dtype
    r2b, q2b = model.step(rr, qq, t, 2 * DAY)
    assert torch.equal(r2, r2b) and torch.equal(q2, q2b)


def _ol_numbers(line):
    """The <OL> line's numbers but its last (the time per step)."""
    body = line[line.index("re l2"):line.index("et ts")]
    return [float(x) for x in re.findall(r"-?\d\.\d+e[-+]\d+", body)]


CLI = ["-ne", "3", "-nsteps", "2", "-nsub", "2", "-mono", "caas", "-lim",
       "caas", "-ic", "gaussianhills", "-ic", "cosinebells"]


def test_cli_matches_jax_ol(capsys):
    out = driver_torch.main(CLI + ["-device", "cpu"])
    line = [s for s in capsys.readouterr().out.splitlines()
            if s.startswith("<OL>")][-1]
    driver_jax.main(CLI)
    ref_line = [s for s in capsys.readouterr().out.splitlines()
                if s.startswith("<OL>")][-1]
    assert line[:line.index("re l2")] == ref_line[:ref_line.index("re l2")]
    assert np.allclose(_ol_numbers(line), _ol_numbers(ref_line), rtol=0,
                       atol=1e-12)
    ref = driver_jax.run(ne=3, nsteps=2, nsub=2, filter_="caas",
                         limiter="caas", verbose=False,
                         ics=("gaussianhills", "cosinebells"))
    for k in ("l2_err", "max_err", "l1_err", "cv", "cv_gll", "min_e",
              "max_e"):
        assert abs(getattr(out, k) - getattr(ref, k)) <= 1e-12, k


def test_cli_every_diagnostic_and_output(tmp_path, capsys):
    prefix = str(tmp_path / "run")
    rit = str(tmp_path / "rit.json")
    out = driver_torch.main(
        ["-ne", "3", "-nsteps", "2", "-nsub", "2", "-mono", "caas", "-lim",
         "caas", "-ic", "gaussianhills", "-ic", "cosinebells", "-ic",
         "correlatedcosinebells", "-rit", rit, "-lauritzen",
         "-midpoint-check", "-footprint", "-timers", "-io-type", "netcdf",
         "-o", prefix, "-device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert len([s for s in lines if s.startswith("footprint> ")]) == 2
    assert len([s for s in lines if s.startswith("> mp tracer ")]) == 3
    assert [s for s in lines if s.startswith("T full step")]
    assert [s for s in lines if s.startswith("L    l_r ")]
    assert [s for s in lines if s.startswith("L    fil ")]
    assert lines[-1].startswith("<OL> method pisl")
    assert np.isfinite(out.l2_err)
    series = json.loads(open(rit).read())
    assert len(series["times"]) == 3
    assert list(series["fields"]) == ["rho", "gaussianhills0",
                                      "cosinebells1",
                                      "correlatedcosinebells2"]
    v, _ = _read_nc(prefix + ".nc")
    assert v["density"].shape == v["tracer_cosinebells1"].shape == (3, 488)
    assert v["time"][-1] == 12 * DAY
    assert np.all(np.isfinite(v["tracer_gaussianhills0"]))


def test_cli_raster_and_single_precision(tmp_path, capsys, monkeypatch):
    prefix = str(tmp_path / "ras")
    argv = ["-ne", "2", "-nsteps", "1", "-nsub", "1", "-io-type",
            "internal", "-res", "8", "-o", prefix, "-device", "cpu"]
    out64 = driver_torch.main(argv)
    with open(prefix + ".bin", "rb") as fh:
        hdr = np.fromfile(fh, np.int32, 3)
        frames = np.fromfile(fh, np.float32)
    # Two output times, density and one tracer each.
    assert list(hdr) == [4, 8, 16] and frames.shape == (4 * 8 * 16,)
    assert np.all(np.isfinite(frames))
    monkeypatch.setenv("COMPOSE_TPU_X64", "0")
    out32 = driver_torch.main(argv)
    ref32 = driver_torch.run(ne=2, nsteps=1, nsub=1, verbose=False,
                             x64=False, device="cpu")
    assert out32.l2_err == ref32.l2_err != out64.l2_err
