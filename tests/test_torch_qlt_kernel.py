"""The QLT tree kernel's host side on the CPU (cdr/qlt.py): `QLT.run`
sends CPU tensors, the problem types other than SHAPEPRESERVE and the
mass-conservation preference to the eager level loop `run_plain`,
unchanged, and counts each run as `qlt.eager`; CUDA tensors of the spf
filter's contract go to the kernel, which takes the filter's operands and
raises on any other; the kernel's level table describes the tree. The
kernel itself is held to the eager loop on the card by
tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from compose_tpu_torch import trace
from compose_tpu_torch.cdr import qlt, tree as tree_mod
from compose_tpu_torch.transport import spf
from qlt_cases import qlt_case, same_bits

torch.set_num_threads(1)

F32, F64 = torch.float32, torch.float64


@pytest.fixture(autouse=True)
def tracer_on():
    trace.reset()
    trace.enable()
    yield
    trace.disable()
    trace.reset()


# ---------------------------------------------------------------------------
# The dispatch: what the kernel does not take runs the eager loop.

@pytest.mark.parametrize("dtype", [F64, F32], ids=["f64", "f32"])
@pytest.mark.parametrize("ncell,nt", [(96, 1), (96, 40), (7, 3)])
def test_cpu_tensors_run_the_eager_loop(dtype, ncell, nt):
    rhom, Qm, lo, hi, extra = qlt_case(ncell, nt, dtype, "perturbed")
    solver = qlt.QLT(ncell)
    got = solver.run(rhom, Qm, lo, hi, root_extra=extra)
    assert torch.equal(got, solver.run_plain(rhom, Qm, lo, hi,
                                             root_extra=extra))
    assert got.dtype == dtype and got.shape == (nt, ncell)
    assert not solver.takes_kernel(Qm)
    assert trace.summary()["counters"] == {"qlt.eager": 1}


PROBLEM_TYPES = {
    "conserve_shapepreserve": qlt.CONSERVE | qlt.SHAPEPRESERVE,
    "consistent": qlt.CONSISTENT,
    "conserve_consistent": qlt.CONSERVE | qlt.CONSISTENT,
    "nonnegative": qlt.NONNEGATIVE,
    "conserve_nonnegative": qlt.CONSERVE | qlt.NONNEGATIVE,
}


@pytest.mark.parametrize("name", list(PROBLEM_TYPES))
def test_other_problem_types_run_the_eager_loop(name, monkeypatch):
    # The CEDR battery's types: eager whatever the device, so here even
    # with the device test answering "CUDA".
    rhom, Qm, lo, hi, _ = qlt_case(54, 3, F64, "perturbed")
    solver = qlt.QLT(54, problem_type=PROBLEM_TYPES[name])
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    assert not solver.takes_kernel(Qm)
    monkeypatch.undo()
    got = solver.run(rhom, Qm, lo, hi, Qm_prev=Qm * 1.01)
    ctr = trace.summary()["counters"]
    assert torch.equal(got, solver.run_plain(rhom, Qm, lo, hi,
                                             Qm_prev=Qm * 1.01))
    assert ctr["qlt.eager"] == 1 and "qlt.kernel" not in ctr


@pytest.fixture
def on_cuda(monkeypatch):
    """The device test answers "CUDA" for every tensor; the operands stay
    on the CPU."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))


def test_cuda_spf_calls_take_the_kernel(on_cuda, monkeypatch):
    # The dispatch reads the problem type, the preference and the device
    # alone: every spf-type call on CUDA goes to run_kernel.
    rhom, Qm, lo, hi, extra = qlt_case(96, 4, F64, "perturbed")
    calls = []
    monkeypatch.setattr(qlt.QLT, "run_kernel",
                        lambda self, *a: calls.append(a) or a[1])
    sp = qlt.QLT(96)
    for ex in (extra, None, 0.5):
        assert sp.run(rhom, Qm, lo, hi, root_extra=ex) is Qm
    assert len(calls) == 3
    assert trace.summary()["counters"] == {"qlt.kernel": 3}
    assert not qlt.QLT(96, prefer_mass_con_to_bounds=True).takes_kernel(Qm)
    assert not qlt.QLT(96, problem_type=qlt.CONSISTENT).takes_kernel(Qm)


EXTRAS = {"per_row": lambda e: e, "none": lambda e: None,
          "shared": lambda e: e[:1], "scalar_tensor": lambda e: e[0],
          "number": lambda e: 0.5, "int": lambda e: 1,
          "expanded": lambda e: e[2].expand(4)}


@pytest.mark.parametrize("dtype", [F64, F32], ids=["f64", "f32"])
@pytest.mark.parametrize("name", list(EXTRAS))
def test_kernel_operands(on_cuda, name, dtype):
    # What the kernel takes: contiguous copies of the four arrays, and the
    # extra flattened in Qm's dtype, one value or one per row.
    rhom, Qm, lo, hi, extra = qlt_case(96, 4, dtype, "perturbed")
    ex = EXTRAS[name](extra)
    ins, flat = qlt.QLT(96).kernel_operands(rhom, Qm.t().contiguous().t(),
                                            lo, hi, ex)
    assert [tuple(x.shape) for x in ins] == [(96,)] + [(4, 96)] * 3
    assert all(x.is_contiguous() for x in ins)
    assert torch.equal(ins[2], Qm)
    if ex is None:
        assert flat is None
    else:
        want = torch.atleast_1d(torch.as_tensor(ex, dtype=dtype))
        if name == "expanded":
            want = extra[2:3]
        assert flat.dtype == dtype and torch.equal(flat, want)
        assert flat.is_contiguous()


REFUSED = {
    "extra_dtype": (TypeError, lambda r, q, lo, hi, e, n: (
        r, q, lo, hi, e.float(), n)),
    "extra_length": (ValueError, lambda r, q, lo, hi, e, n: (
        r, q, lo, hi, e[:2], n)),
    "extra_2d": (ValueError, lambda r, q, lo, hi, e, n: (
        r, q, lo, hi, e[:, None], n)),
    "qm_dtype": (TypeError, lambda r, q, lo, hi, e, n: (
        r, q.half(), lo, hi, e, n)),
    "rhom_2d": (ValueError, lambda r, q, lo, hi, e, n: (
        r[None], q, lo, hi, e, n)),
    "qm_1d": (ValueError, lambda r, q, lo, hi, e, n: (
        r, q[0], lo[0], hi[0], e, n)),
    "bound_rows": (ValueError, lambda r, q, lo, hi, e, n: (
        r, q, lo[:2], hi, e, n)),
    "bound_missing": (TypeError, lambda r, q, lo, hi, e, n: (
        r, q, None, hi, e, n)),
    "ncells": (ValueError, lambda r, q, lo, hi, e, n: (
        r, q, lo, hi, e, n - 1)),
}


@pytest.mark.parametrize("name", list(REFUSED))
def test_kernel_refuses_other_operands(on_cuda, name):
    # On CUDA the spf type always takes the kernel, which raises on an
    # operand of another dtype, device or shape; nothing falls back.
    err, make = REFUSED[name]
    *ops, ncell = make(*qlt_case(96, 4, F64, "perturbed"), 96)
    with pytest.raises(err):
        qlt.QLT(ncell).run(*ops[:4], root_extra=ops[4])
    assert trace.summary()["counters"] == {"qlt.kernel": 1}


def test_kernel_refuses_another_device():
    rhom, Qm, lo, hi, extra = qlt_case(96, 4, F64, "perturbed")
    with pytest.raises(ValueError, match="CUDA"):
        qlt.QLT(96).run_kernel(rhom, Qm, lo, hi, extra)
    with pytest.raises(ValueError, match="meta"):
        qlt.QLT(96).kernel_operands(rhom.to("meta"), Qm, lo, hi, extra)


def test_prefer_runs_the_eager_loop():
    rhom, Qm, lo, hi, extra = qlt_case(54, 3, F64, "infeasible")
    solver = qlt.QLT(54, prefer_mass_con_to_bounds=True)
    got = solver.run(rhom, Qm, lo, hi, root_extra=extra)
    assert torch.equal(got, solver.run_plain(rhom, Qm, lo, hi,
                                             root_extra=extra))
    assert trace.summary()["counters"] == {"qlt.eager": 1}


@pytest.mark.parametrize("squeeze", [False, True], ids=["tracers", "rho"])
def test_spf_qlt_counts_one_run_per_call(squeeze):
    rhom, Qm, lo, hi, extra = qlt_case(150, 5, F64, "perturbed")
    if squeeze:
        Qm, lo, hi, extra = Qm[0], lo[0], hi[0], extra[0]
    mrd = spf.MassRedistributor(150, "qlt")
    got = mrd.redistribute(rhom, lo, Qm, hi, extra)
    ref = mrd._qlt.run_plain(rhom, *(torch.atleast_2d(x)
                                     for x in (Qm, lo, hi)),
                             root_extra=torch.atleast_1d(extra))
    assert torch.equal(got, ref[0] if squeeze else ref)
    summ = trace.summary()
    assert summ["counters"] == {"qlt.eager": 1}
    assert summ["spans"]["cdr.qlt"]["count"] == 1


# ---------------------------------------------------------------------------
# The level table.

@pytest.mark.parametrize("imbalanced", [False, True])
@pytest.mark.parametrize("ncell", [1, 2, 3, 7, 96, 1350, 5400])
def test_kernel_table_describes_the_tree(ncell, imbalanced):
    t = tree_mod.build(ncell, imbalanced)
    tb = qlt.kernel_table(t)
    nlev, ni = len(t.levels), t.nnodes - t.nleaf
    assert tb.dtype == np.int32 and tb.shape == (nlev + 1 + 3 * ni,)
    off = tb[:nlev + 1]
    assert off[0] == 0 and off[-1] == ni and np.all(np.diff(off) >= 1)
    ids, k0, k1 = (tb[nlev + 1 + c * ni:nlev + 1 + (c + 1) * ni]
                   for c in range(3))
    for lvl, (lids, lk0, lk1) in enumerate(t.levels):
        sl = slice(off[lvl], off[lvl + 1])
        assert np.array_equal(ids[sl], lids)
        assert np.array_equal(k0[sl], lk0) and np.array_equal(k1[sl], lk1)
    # Every internal node once, every node but the root a kid once, kids
    # on earlier levels (or leaves): the sweeps' barriers suffice.
    assert sorted(ids) == list(range(t.nleaf, t.nnodes))
    kids = np.concatenate([k0, k1[k1 >= 0]])
    assert sorted(kids) == list(range(t.nnodes - 1))
    level_of = np.zeros(t.nnodes, np.int64)
    for lvl in range(nlev):
        level_of[ids[off[lvl]:off[lvl + 1]]] = lvl + 1
    for i in range(ni):
        assert level_of[k0[i]] < level_of[ids[i]]
        assert k1[i] < 0 or level_of[k1[i]] < level_of[ids[i]]
