"""The reference's golden rows of the cell-integrated methods (ir, cdg),
the subcell meshes and the mixed `isl` method through the port's
driver.run on the CPU, each held to the bars that
tests/test_regression_battery.py or tests/test_transport_e2e.py hold the
JAX package to. The rows and their bars are chip_smoke.IR_GOLDEN, which
chip_smoke.py phase 4 runs on the card.

A row whose run takes more than ~20 s on the CPU is marked slow: an IR
step at ne10 np4 in the sphere geometry takes seconds here (two Newton
inverses at every quadrature point of every overlap), and most rows run 12
such steps, or 96 at ne5. The facet rows (Newton only at the overlaps'
vertices) and the 12-step subcell rows run in 4-10 s.
"""

import pathlib
import sys

import pytest

from compose_tpu_torch import driver

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from chip_smoke import IR_GOLDEN, row_ok  # noqa: E402

# Rows that run in about 10 s or less on the CPU (facet dmc f/ef at ne10,
# the 12-step subcell rows).
FAST = ("ir_dmc_f", "ir_qlt_2ics", "sub12_gll", "sub12_runi",
        "sub_np10_ne2", "cmbc_f", "perturb_nondiv", "perturb_div")


@pytest.mark.parametrize("row", [
    r if r in FAST else pytest.param(r, marks=pytest.mark.slow)
    for r in IR_GOLDEN])
def test_golden_row(row):
    kw, bars = IR_GOLDEN[row]
    out = driver.run(verbose=False, device="cpu",
                     **dict(dict(np_=4, nsteps=12), **kw))
    assert row_ok(out, bars), (row, out)
