"""The plain reference against the port at ne4 with 3 tracers on the CPU,
for both configurations: the mesh tables, and the state after each of a
few steps from the benchmark's inputs."""

import pytest
import torch

from benchmark import check, harness, reference, spec

CELLS = ["isl_caas.ne30.t40", "isl_qlt.ne30.t40"]


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_mesh_tables_match():
    from compose_tpu_torch.mesh import cubed_sphere

    pm = cubed_sphere.build(4, 4, device="cpu")
    rm = reference.build_mesh(4, 4)
    for name, ref_name in (("corners", "corners"), ("dgll2cgll", "dgll2cgll"),
                           ("cgll_xyz", "cgll_xyz"), ("c2d_idx", "c2d_idx"),
                           ("c2d_mask", "c2d_mask"), ("jac_node", "jac_node"),
                           ("dgbfi_gll", "F")):
        assert torch.equal(getattr(pm, name), getattr(rm, ref_name)), name


@pytest.mark.parametrize("name", CELLS)
def test_reference_steps_match_the_port(name):
    cell = spec.Cell(name)
    cfg = dict(cell.config, ne=4, ntracer=3)
    dev = torch.device("cpu")
    model = harness.build_model(cfg, dev, True)
    ref = check.reference_for(cfg, dev)
    plan = reference.tracer_plan(2 ** 31 + 11, cell.traffic["families"], 3)
    rho, q = reference.initial_state(ref.mesh, plan, torch.float64)
    for k in range(4):
        ts, tf = harness.step_times(k, cfg)
        r_rho, r_q, _ = ref.step(rho, q, ts, tf)
        rho, q = model.step(rho, q, ts, tf)
        scale = float(torch.max(torch.abs(r_q)))
        assert float(torch.max(torch.abs(rho - r_rho))) <= 1e-13
        assert float(torch.max(torch.abs(q - r_q))) <= 1e-13 * scale


def test_tracer_plan_same_work_every_seed():
    fam = spec.Cell(CELLS[0]).traffic["families"]
    for seed in (0, 2 ** 31 + 5, 2 ** 40):
        plan = reference.tracer_plan(seed, fam, 40)
        names = sorted(n for n, _ in plan)
        assert names == sorted(fam * 10)
        for _, R in plan:
            assert abs(abs(float(torch.tensor(R).det())) - 1) < 1e-12
    a = reference.tracer_plan(3, fam, 40)
    b = reference.tracer_plan(3, fam, 40)
    assert [n for n, _ in a] == [n for n, _ in b]
