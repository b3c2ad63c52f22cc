"""The port's entry step, multi-device dry run and comm-volume accounting
(compose_tpu_torch.tools.dryrun) against the repo root's entry module
(`__graft_entry__`, the JAX side) and its committed output,
MULTICHIP_comm.json (the JAX accounting at 8 devices). No test here calls
the JAX dryrun_multichip: it writes MULTICHIP_comm.json into the working
directory. The card's side is in test_torch_cuda.py."""

import importlib
import json
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compose_tpu.parallel.sharded import ShardedIsl as ShardedIslJax
from compose_tpu.transport import gallery as gallery_jax
from compose_tpu.transport import isl as isl_jax
from compose_tpu_torch.parallel.sharded import ShardedIsl
from compose_tpu_torch.tools import dryrun
from compose_tpu_torch.transport import gallery
from compose_tpu_torch.transport.isl import IslConfig, IslTransport

from torch_parity import meshes

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARTIFACT = json.loads((ROOT / "MULTICHIP_comm.json").read_text())
MODELLED = ("dryrun", "flagship_ne30_nt40_strip",
            "flagship_ne30_nt40_tile_ring2")


def _graft():
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    return importlib.import_module("__graft_entry__")


def test_entry_step_vs_jax():
    fn_j, (rho_j, q_j) = _graft().entry()
    rho, q = np.asarray(rho_j), np.asarray(q_j)
    rj, qj = jax.jit(fn_j)(jnp.asarray(rho), jnp.asarray(q))
    fn, (rho_t, q_t) = dryrun.entry(device="cpu")
    assert rho_t.device.type == "cpu" and rho_t.shape == rho.shape
    assert np.abs(q_t.numpy() - q).max() <= 1e-12
    args = (torch.tensor(rho), torch.tensor(q))
    rt, qt = fn(*args)
    assert np.abs(np.asarray(rj) - rt.numpy()).max() <= 1e-12
    assert np.abs(np.asarray(qj) - qt.numpy()).max() <= 1e-12
    # The arguments are unchanged, and a second call is bitwise the first.
    assert torch.equal(args[0], torch.tensor(rho))
    assert torch.equal(args[1], torch.tensor(q))
    again = fn(*args)
    assert torch.equal(again[0], rt) and torch.equal(again[1], qt)


@pytest.mark.parametrize("n", [2, 8])
def test_dryrun_multichip_cpu(n, tmp_path, monkeypatch):
    cwd = tmp_path / "cwd"
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    out = tmp_path / "acct.json"
    acct = dryrun.dryrun_multichip(n, device="cpu", out=out,
                                   measured_halo=False)
    assert list(cwd.iterdir()) == []
    assert json.loads(out.read_text()) == acct
    assert set(acct) == set(ARTIFACT) - {"flagship_ne30_nt40"}
    for k, row in acct.items():
        assert set(row) == set(ARTIFACT[k])
        assert row["total_bytes"] == sum(
            row[p] for p in ("halo_state_bytes", "dss_rho_bytes",
                             "dss_q_bytes", "gsum_bytes",
                             "qlt_frontier_bytes"))
    if n == 8:
        assert acct["dryrun"] == ARTIFACT["dryrun"]


def _sharded_dryrun_model(n):
    model, _, _, q = dryrun.make_model(4, 3, torch.device("cpu"))
    return ShardedIsl(model, n), q.shape[0]


def test_comm_accounting_flagship_equals_artifact():
    sh, nt = _sharded_dryrun_model(8)
    acct = dryrun.comm_accounting(sh, nt, 8, measured_halo=False)
    assert set(acct) == set(MODELLED)
    for k in MODELLED:
        for name, v in ARTIFACT[k].items():
            if name.endswith("_bytes"):
                assert acct[k][name] == v, (k, name)
        want = ARTIFACT[k]["comm_fraction_of_state"]
        assert abs(acct[k]["comm_fraction_of_state"] - want) <= 1e-15 * want


@pytest.mark.parametrize("ne_flagship", [5, 6])
def test_comm_accounting_measured_leg_vs_jax(ne_flagship):
    assert len(jax.devices()) >= 8
    mj, mt = meshes(3)
    kw = dict(ne=3, np_=4, filter="qlt", limiter="caas", nsub=2)
    sj = isl_jax.IslTransport(mj, gallery_jax.create_wind("divergent"),
                              isl_jax.IslConfig(**kw))
    st = IslTransport(mt, gallery.create_wind("divergent"), IslConfig(**kw))
    want = _graft().comm_accounting(ShardedIslJax(sj, 8), 2, 8,
                                    ne_flagship=ne_flagship)
    report = {}
    got = dryrun.comm_accounting(ShardedIsl(st, 8), 2, 8,
                                 ne_flagship=ne_flagship, report=report)
    assert got == want
    assert set(report) == {"measured_leg_s"} and report["measured_leg_s"] > 0
    assert got["flagship_ne30_nt40"]["halo"] == "tile + measured footprint"
    assert all(isinstance(v, int) for row in got.values()
               for k, v in row.items() if k.endswith("_bytes"))


@pytest.mark.parametrize("bad_call", [0, 1], ids=["strips", "tiles"])
def test_dryrun_raises_on_a_perturbed_step(bad_call, monkeypatch):
    step = ShardedIsl.step
    calls = []

    def perturbed(self, rho, q, ts, tf):
        r, qq = step(self, rho, q, ts, tf)
        calls.append(1)
        if len(calls) - 1 == bad_call:
            qq = qq.clone()
            up = torch.tensor(np.inf, dtype=qq.dtype)
            qq[1, 7, 3] = torch.nextafter(qq[1, 7, 3], up)
        return r, qq

    monkeypatch.setattr(ShardedIsl, "step", perturbed)
    with pytest.raises(AssertionError, match="differs from the single"):
        dryrun.dryrun_multichip(2, device="cpu", measured_halo=False)
    assert len(calls) == bad_call + 1


def test_cli(tmp_path):
    out = tmp_path / "acct.json"
    res = subprocess.run(
        [sys.executable, "-m", "compose_tpu_torch.tools.dryrun", "--ndev",
         "2", "--device", "cpu", "--no-measured-halo", "--out", str(out),
         "--entry"], capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-2000:]
    lines = res.stdout.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["accounting"] == json.loads(out.read_text())
    assert line["max_diff"] == {"strips": 0.0, "tiles": 0.0,
                                "ir": [0.0, 0.0]}
    assert line["entry_mass_change"] <= 1e-13


_RANK = r"""
import sys
import torch
import torch.distributed as dist
from compose_tpu_torch.parallel.comm import DistComm
from compose_tpu_torch.tools import dryrun

torch.set_num_threads(1)
rank, init, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method="file://" + init, rank=rank,
                        world_size=2)
try:
    report = {}
    acct = dryrun.dryrun_multichip(2, comm=DistComm(), measured_halo=False,
                                   report=report)
    torch.save((acct, report), out)
finally:
    dist.destroy_process_group()
"""


def test_dryrun_multichip_gloo_two_ranks(tmp_path):
    # Every rank of a DistComm runs the dry run's checks on the global
    # state and gets the accounting of the LocalComm run.
    init = tmp_path / "pg_init"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(r), str(init),
         str(tmp_path / f"rank{r}.pt")], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], logs
    sh, nt = _sharded_dryrun_model(2)
    want = dryrun.comm_accounting(sh, nt, 2, measured_halo=False)
    for r in range(2):
        acct, report = torch.load(tmp_path / f"rank{r}.pt")
        assert acct == want
        assert report == {"max_diff": {"strips": 0.0, "tiles": 0.0,
                                       "ir": [0.0, 0.0]}}
