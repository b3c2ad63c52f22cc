"""The reference's golden rows of the cell-integrated methods (ir, cdg),
the subcell meshes and the mixed `isl` method through the port's
driver.run on the CPU, each held to the bars that
tests/test_regression_battery.py or tests/test_transport_e2e.py hold the
JAX package to: the battery's rows of these methods through
compose_tpu_torch.battery.run_row, and the e2e tests' IR and isl runs of
chip_smoke.E2E_GOLDEN, as chip_smoke.py phase 4 runs them on the card.

A row whose run takes more than ~20 s on the CPU is marked slow: an IR
step at ne10 np4 in the sphere geometry takes seconds here (two Newton
inverses at every quadrature point of every overlap), and most rows run 12
such steps, or 96 at ne5. The facet rows (Newton only at the overlaps'
vertices) and the 12-step subcell rows run in 4-10 s.
"""

import pathlib
import sys

import pytest

from compose_tpu_torch import battery, driver

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from chip_smoke import E2E_GOLDEN, row_ok  # noqa: E402

BATTERY = tuple(r[0] for r in battery.ROWS
                if r[2].get("method") in ("isl", "ir", "cdg"))
E2E = ("test_golden_ir_ne10", "test_golden_ir_qlt_slotted",
       "test_golden_isl_qlt_ne10", "test_golden_tracer_consistency")
# Rows that run in about 10 s or less on the CPU (facet dmc f/ef at ne10,
# the 12-step subcell rows).
FAST = ("ir_dmc_f", "ir_qlt_2ics", "sub12_gll", "sub12_runi",
        "sub_np10_ne2", "cmbc_f", "perturb_nondiv", "perturb_div")


@pytest.mark.parametrize("row", [
    r if r in FAST else pytest.param(r, marks=pytest.mark.slow)
    for r in BATTERY + E2E])
def test_golden_row(row):
    if row in E2E:
        kw, bars = E2E_GOLDEN[row]
        out = driver.run(verbose=False, device="cpu",
                         **dict(dict(np_=4, nsteps=12), **kw))
        assert row_ok(out, bars), (row, out)
    else:
        _, checks, ok = battery.run_row(row, "cpu")
        assert ok, (row, checks)
