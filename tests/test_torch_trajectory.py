"""The trajectory kernel's host side on the CPU (transport/timeint.py,
csrc/dopri5.cu): the time scalars it is given are the ones the eager chain
uses, and every call the kernel does not take (CPU tensors, winds with no
native form, the line integrator) goes through the eager chain unchanged
and is counted as `trajectory.eager`. The kernel itself is held to the
eager chain on the card by tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from compose_tpu_torch import driver, trace
from compose_tpu_torch.config import np_scalar
from compose_tpu_torch.mesh import cubed_sphere
from compose_tpu_torch.transport import gallery, timeint
from compose_tpu_torch.transport.isl import IslConfig, IslTransport

torch.set_num_threads(1)

T = 86400.0 * 12
DT = T / 120
F32, F64 = torch.float32, torch.float64


@pytest.fixture(autouse=True)
def tracer_on():
    trace.reset()
    trace.enable()
    yield
    trace.disable()
    trace.reset()


def _old_time_scalars(t, T, dtype):
    """The time part of gallery._trig_frame as it was written inline."""
    s = np_scalar(dtype)
    tt, Ts = s(t), s(T)
    c = s(s(s(2 * np.pi) * tt) / Ts)
    cc, sc = float(np.cos(c)), float(np.sin(c))
    cost = float(np.cos(s(s(s(np.pi) * tt) / Ts)))
    return cc, sc, cost


def _stage_times(ts, tf, nsub):
    """The times integrate_plain evaluates the wind at, in its order."""
    dt = (tf - ts) / nsub
    return [ts + i * dt + c * dt for i in range(nsub) for c in timeint._C]


def _points(dtype, n=40, seed=3):
    rng = np.random.default_rng(seed)
    p = rng.normal(size=(n, 3)) * rng.uniform(0.5, 1.5, (n, 1))
    p[:2] = [[0.0, 0.0, 1.0], [0.0, 0.0, -1.0]]          # the poles
    return torch.tensor(p, dtype=dtype)


@pytest.mark.parametrize("dtype", [F64, F32], ids=["f64", "f32"])
@pytest.mark.parametrize("step", [0, 1, 59, 119, 120, 239])
def test_time_trig_is_the_old_inline_scalars(dtype, step):
    # One backward ISL step of the benchmark's period: 8 substeps x 7
    # stages, through time_trig and through the kernel's table.
    ts, tf = (step + 1) * DT, step * DT
    wind = gallery.create_wind("divergent")
    head, trig = timeint.dopri5_table(wind, ts, tf, dtype, 8)
    times = _stage_times(ts, tf, 8)
    assert trig.shape == (8, 7, 3) and len(times) == 56
    for t, row in zip(times, trig.reshape(-1, 3)):
        want = _old_time_scalars(t, T, dtype)
        assert gallery.time_trig(t, T, dtype) == want
        assert tuple(row) == want


@pytest.mark.parametrize("dtype", [F64, F32], ids=["f64", "f32"])
@pytest.mark.parametrize("wind_name,vfac", [("divergent", 2.5),
                                            ("nondivergent", 10.0)])
def test_dopri5_table_head_is_the_eager_rounding(dtype, wind_name, vfac):
    # The scalar factors as PyTorch rounds them for a `dtype` tensor, and
    # dt a_ij, dt b_j as _dopri5_step rounds them.
    s = np_scalar(dtype)
    wind = gallery.create_wind(wind_name)
    ts, tf, nsub = 37 * DT, 36 * DT, 3
    head, trig = timeint.dopri5_table(wind, ts, tf, dtype, nsub)
    dtl = s((tf - ts) / nsub)
    want = [float(s(vfac / T)), float(s(1 / T)), float(s(2 * np.pi)),
            float(s(1.0) / s(6.37122e6))]
    want += [float(s(dtl * s(a))) for row in timeint._A for a in row]
    want += [float(s(dtl * s(b))) for b in timeint._B5]
    assert head.tolist() == want and len(want) == 4 + 21 + 7
    assert trig.shape == (nsub, 7, 3)


@pytest.mark.parametrize("dtype", [F64, F32], ids=["f64", "f32"])
@pytest.mark.parametrize("wind_name", ["divergent", "nondivergent", "rotate",
                                       "movingvortices"])
def test_eager_path_taken_and_counted(dtype, wind_name):
    # CPU tensors (any wind) and winds with no native form run the eager
    # chain, whose result `integrate` returns unchanged.
    wind = gallery.create_wind(wind_name)
    p = _points(dtype)
    got = timeint.integrate(wind.velocity, 3 * DT, 2 * DT, p, 3)
    assert torch.equal(got, timeint.integrate_plain(wind.velocity, 3 * DT,
                                                    2 * DT, p, 3))
    assert got.dtype == dtype and got.shape == p.shape
    assert trace.summary()["counters"] == {"trajectory.eager": 1}


def test_line_integrator_counted_eager():
    wind = gallery.create_wind("divergent")
    p = _points(F64)
    got = timeint.integrate_line(wind.velocity, DT, 0.0, p)
    th, dt = 0.5 * DT, -DT
    uh = p
    for _ in range(2):
        f = wind.velocity(th, uh)
        uh = p + (0.5 * dt) * f
    want = p + dt * f
    assert torch.equal(got, want / torch.sqrt(torch.sum(want * want, -1,
                                                        keepdim=True)))
    assert trace.summary()["counters"] == {"trajectory.eager": 1}


@pytest.mark.parametrize("timeint_name,n", [("exact", 4), ("interp", 6),
                                            ("line", 4), ("interpline", 6)])
def test_step_counts_one_trajectory_per_step(timeint_name, n):
    # One trajectory call per step, on the CGLL nodes or on the np4
    # velocity grid; on the CPU always the eager chain.
    mesh = cubed_sphere.build(3, n, device="cpu")
    cfg = dict(ne=3, np_=n, nsub=2, filter="caas", limiter="caas",
               timeint=timeint_name)
    model = IslTransport(mesh, gallery.create_wind("divergent"),
                         IslConfig(**cfg))
    rho = torch.ones((mesh.ncell, mesh.np2), dtype=F64)
    q = driver.init_tracers(mesh, ("gaussianhills", "cosinebells"))
    state = (rho, q)
    for k in range(2):
        state = model.step(*state, k * DT, (k + 1) * DT)
    assert trace.summary()["counters"]["trajectory.eager"] == 2
    assert "trajectory.kernel" not in trace.summary()["counters"]


def test_dopri5_refuses_what_it_cannot_take():
    # The wrapper's checks that need no card: a wind with no native form,
    # a dtype with no kernel, points not (N, 3), points on the CPU.
    div = gallery.create_wind("divergent")
    with pytest.raises(ValueError, match="native form"):
        timeint.dopri5(gallery.create_wind("rotate"), DT, 0.0, _points(F64))
    with pytest.raises(TypeError, match="no kernel"):
        timeint.dopri5(div, DT, 0.0, _points(F64).to(torch.float16))
    with pytest.raises(ValueError, match=r"\(N, 3\)"):
        timeint.dopri5(div, DT, 0.0, torch.zeros(5, 4, dtype=F64))
    with pytest.raises(ValueError, match="CUDA"):
        timeint.dopri5(div, DT, 0.0, _points(F64))
