"""The comparison that decides `correct`, shown to fail: the control (the
port's single-precision route in place of the configured float64) and the
planted faults each come out not correct under every cell's limits, and
the port itself correct. The harness's look for a card is skipped; the
rest of a run is driven at ne4 on the CPU (two gloo ranks for the
four-card cell)."""

import math
import time

import pytest
import torch

from benchmark import harness, spec
from benchmark.tests import faults

ONE = ["isl_caas.ne30.t40", "isl_qlt.ne30.t40"]


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _small(name, nt=4):
    cell = spec.Cell(name)
    cell.config = dict(cell.config, ne=4, ntracer=nt)
    cell.traffic = dict(cell.traffic, sample_within=4)
    return cell


def _run(cell, variant="program", hook=None, seed=2 ** 32 + 9):
    return harness.rank_run(cell, seed, 0.3, False, torch.device("cpu"),
                            time.time(), variant, hooks=hook)


@pytest.mark.parametrize("name", ONE)
def test_program_correct_control_not(name):
    cell = _small(name)
    good = _run(cell)
    assert good["correct"], good["table"]
    bad = _run(cell, "control")
    assert not bad["correct"], bad["table"]


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered",
                                   "nan"])
@pytest.mark.parametrize("name", ONE)
def test_faults_not_correct(name, fault):
    res = _run(_small(name), hook=getattr(faults, fault))
    assert not res["correct"], res["table"]
    if fault == "nan":
        # A NaN stays a NaN in every folded number, and is counted.
        assert math.isnan(res["nums"]["state_gap"])
        assert res["nums"]["nonfinite"] > 0


@pytest.mark.parametrize("name", ONE)
def test_control_precision_from_config(name):
    """The control runs in the precision its configuration's file gives."""
    cell = _small(name)
    assert not harness.Program(cell, torch.device("cpu"), "control").x64
    cell.config = dict(cell.config, control=dict(cell.config["control"],
                                                 x64=True))
    assert harness.Program(cell, torch.device("cpu"), "control").x64
    assert _run(cell, "control")["correct"]


def _ranks(variant="program", hook=None):
    over = {"config": {"ne": 4, "ntracer": 4},
            "traffic": {"sample_within": 4}}
    args = dict(workload="isl_caas.ne30.t40.x4", seed=2 ** 32 + 3,
                seconds=0.5, trace=False, t_start=time.time(),
                variant=variant, smi_dir=None, backend="gloo", override=over,
                hook=hook)
    return harness.run_ranks(2, args)


def test_sharded_control_and_faults():
    good = _ranks()
    assert good["correct"] and good["forbidden"] == []
    assert not _ranks("control")["correct"]
    for fault in ("no_exchange", "unchanged", "altered"):
        res = _ranks(hook=f"benchmark.tests.faults:{fault}")
        assert not res["correct"], (fault, res["table"])


def test_sharded_ranks_report_jax():
    """A module named jax on a rank other than 0 reaches the result."""
    res = _ranks(hook="benchmark.tests.faults:jax_loaded")
    assert res["forbidden"] == ["jax"]
