"""The port stands alone: it imports neither jax nor compose_tpu (its
multi-device modules, the DTensor step and the entry points included), builds its CUDA kernels only when one is
launched, runs on the card unless the CPU is asked for, and never moves
to another device than the one asked for."""

import pathlib
import re
import subprocess
import sys

import pytest
import torch

from compose_tpu_torch import _native, config, driver
from compose_tpu_torch.mesh import cubed_sphere
from compose_tpu_torch.tools import dryrun

PKG = pathlib.Path(__file__).resolve().parents[1] / "compose_tpu_torch"

_STANDALONE = r"""
import sys
import torch
import compose_tpu_torch
from compose_tpu_torch import _native, driver
from compose_tpu_torch.mesh import cubed_sphere
from compose_tpu_torch.transport import gallery
from compose_tpu_torch.transport.isl import IslConfig, IslTransport
for dtype in (torch.float64, torch.float32):
    mesh = cubed_sphere.build(2, 4, device="cpu", dtype=dtype)
    model = IslTransport(mesh, gallery.create_wind("divergent"),
                         IslConfig(ne=2, nsub=1))
    rho = torch.ones((mesh.ncell, mesh.np2), dtype=dtype)
    q = driver.init_tracers(mesh, ["gaussianhills"])
    rho, q = model.step(rho, q, 0.0, 86400.0)
    assert bool(torch.isfinite(q).all()) and q.shape == (1, mesh.ncell, 16)
    assert q.dtype == rho.dtype == dtype
from compose_tpu_torch import checkpoint, io, islet_tools, vis
from compose_tpu_torch.cdr import bfb, qlt_sharded
from compose_tpu_torch.parallel import comm, halo, sharded, sharded_ir
mesh = cubed_sphere.build(2, 4, device="cpu")
model = IslTransport(mesh, gallery.create_wind("divergent"),
                     IslConfig(ne=2, nsub=1, filter="qlt", limiter="caas"))
rho = torch.ones((mesh.ncell, mesh.np2), dtype=torch.float64)
q = driver.init_tracers(mesh, ["gaussianhills"])
out = sharded.ShardedIsl(model, 3).step(rho, q, 0.0, 3600.0)
assert all(torch.equal(a, b) for a, b in
           zip(out, model.step(rho, q, 0.0, 3600.0)))
from compose_tpu_torch.driver import main
out = main(["-ne", "2", "-nsteps", "1", "-nsub", "1", "-device", "cpu"])
assert out.l2_err == out.l2_err
from compose_tpu_torch import battery, bench
from compose_tpu_torch.parallel import cell_mesh, shard_state, sharded_step
from compose_tpu_torch.tools import profile_step, qlt_perftest, run_battery
assert len(battery.ROWS) == 53
res = qlt_perftest.run(24, 1, 1, 2, "cpu")
assert res["bitwise"]
from compose_tpu_torch.tools import dryrun
fn, (rho, q) = dryrun.entry(device="cpu")
rho, q = fn(rho, q)
assert bool(torch.isfinite(q).all()) and q.shape == (4, 216, 16)
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "compose_tpu",
                               "__graft_entry__")]
assert not bad, bad
assert _native.lib.cache_info().currsize == 0, "kernels were built"
assert all(k.launches == 0 for k in _native.KERNELS.values())
print("STANDALONE_OK")
"""


def test_standalone_step_without_jax():
    # A fresh interpreter: import the port and its output, checkpoint and
    # Islet-tool modules, run one ne2 step on the CPU and the command line,
    # import the DTensor step and the entry points, run the QLT perf test
    # and the entry step.
    res = subprocess.run([sys.executable, "-c", _STANDALONE],
                         capture_output=True, text=True, timeout=300,
                         cwd=PKG.parent)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "STANDALONE_OK" in res.stdout


def test_sources_import_no_jax():
    # The package and chip_smoke.py import neither JAX, the JAX package nor
    # the repo root's entry module (by statement or by importlib).
    mods = r"(jax|jaxlib|compose_tpu|__graft_entry__)\b"
    pat = re.compile(rf"^\s*(import|from)\s+{mods}", re.M)
    dyn = re.compile(rf"(import_module|__import__)\(\s*[\"']{mods}")
    files = list(PKG.rglob("*.py")) + [PKG.parent / "chip_smoke.py"]
    offenders = [str(p) for p in files
                 if pat.search(p.read_text()) or dyn.search(p.read_text())]
    assert not offenders
    cu = sorted(p.name for p in (PKG / "csrc").glob("*.cu"))
    assert cu == ["dopri5.cu", "dss_q.cu", "glbl_caas.cu", "limit_caas.cu",
                  "locate.cu", "qlt_tree.cu"]


def test_cuda_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        config.resolve_device("cuda")
    with pytest.raises(RuntimeError):
        cubed_sphere.build(2, 4, device="cuda")
    with pytest.raises(RuntimeError):
        driver.run(ne=2, nsteps=1, device="cuda", verbose=False)
    # Entry points default to the card.
    with pytest.raises(RuntimeError):
        config.resolve_device(None)
    with pytest.raises(RuntimeError):
        cubed_sphere.build(2, 4)
    with pytest.raises(RuntimeError):
        driver.run(ne=2, nsteps=1, verbose=False)
    with pytest.raises(RuntimeError):
        dryrun.entry()
    with pytest.raises(RuntimeError):
        dryrun.dryrun_multichip(2)
    assert config.resolve_device("cpu") == torch.device("cpu")


def test_kernel_build_is_keyed_by_sources():
    # The library name hashes the sources and flags, under the git-ignored
    # build directory; the flags pin sm_90a and no FMA contraction.
    path = _native.library_path()
    assert path.parent == _native.BUILD_DIR
    assert re.fullmatch(r"libcompose_kernels-[0-9a-f]{16}\.so", path.name)
    assert "arch=compute_90a,code=sm_90a" in _native.NVCC_FLAGS
    assert "--fmad=false" in _native.NVCC_FLAGS
    ignored = (PKG.parent / ".gitignore").read_text().split()
    assert "build/" in ignored
