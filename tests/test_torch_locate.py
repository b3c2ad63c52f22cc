"""Cell location's dispatch and host side (transport/locate.py, the kernel
csrc/locate.cu) on the CPU: the eager chain `_locate_plain` is the code
`_locate` ran before the kernel, CPU points and the nonuniform and subcell
meshes take it (counted as `locate.eager`) without reaching the kernel
library, the kernel's operands are built once, and its host scalars are
rounded as the eager chain rounds them. The kernel itself is held to the
eager chain on the card by tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from compose_tpu_torch import _native, basis as basis_mod, trace
from compose_tpu_torch.config import np_scalar
from compose_tpu_torch.mesh import cubed_sphere
from compose_tpu_torch.ops import sqr
from compose_tpu_torch.transport import gallery, locate
from compose_tpu_torch.transport.isl import IslConfig, IslTransport

F64, F32 = torch.float64, torch.float32
DT = 86400.0 * 12 / 120
WIND = gallery.create_wind("divergent")
ROUTES = {"f32-f64": (F64, "f32"), "f64-f64": (F64, "f64"),
          "f32-f32": (F32, "f64")}


def _locate_before(model, dep):
    """IslTransport._locate as it was before the kernel, verbatim."""
    m, cfg = model.mesh, model.config
    if m.nonuni:
        ci, a, b = cubed_sphere.locate(m, dep)
    else:
        ci, a0, b0 = cubed_sphere.locate(m, dep)
        corners = m.corners[ci]
        if cfg.geom_dtype == "f32":
            corners = corners.to(F32)
            tol = 1e1 * float(torch.finfo(F32).eps)
            a, b = sqr.sphere_to_ref(corners, dep, max_its=3, tol=tol,
                                     a0=a0, b0=b0)
        else:
            a, b = sqr.sphere_to_ref(corners, dep, max_its=4, a0=a0, b0=b0)
    va = model.basis.eval(a)
    vb = model.basis.eval(b)
    w = (vb[:, :, None] * va[:, None, :]).reshape(-1, m.np2)
    return ci, w.to(model.real)


def _same_bits(a, b):
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        ity = {F64: torch.int64, F32: torch.int32}[a.dtype]
        a, b = a.view(ity), b.view(ity)
    return torch.equal(a, b)


def _model(route="f64-f64", ne=4, np_=4, basis="GllNodal", **mesh_kw):
    dtype, geom = ROUTES[route]
    mesh = cubed_sphere.build(ne, np_, basis, device="cpu", dtype=dtype,
                              **mesh_kw)
    return IslTransport(mesh, WIND, IslConfig(
        ne=mesh.ne, np_=mesh.np_, basis=basis, nsub=2, geom_dtype=geom,
        rotate=mesh_kw.get("rotate")))


def _counted(fn, *args):
    trace.reset()
    trace.enable()
    try:
        out = fn(*args)
        return out, dict(trace.summary()["counters"])
    finally:
        trace.disable()
        trace.reset()


@pytest.fixture
def no_kernel(monkeypatch):
    """Any reach for the kernel library or a kernel entry fails."""
    def refuse(*a, **k):
        raise AssertionError("the eager path reached the kernels")
    monkeypatch.setattr(_native, "lib", refuse)
    monkeypatch.setattr(_native, "kernel", refuse)
    monkeypatch.setattr(locate, "locate_cells", refuse)


MESHES = {
    "uniform": dict(),
    "rotated": dict(rotate=((0.3, -0.7, 0.2), 0.9)),
    "nonuni": dict(nonuni=True),
    "np3": dict(np_=3),
    "np6-offset": dict(np_=6, basis="GllOffsetNodal"),
    "np8": dict(np_=8),
    "gll": dict(basis="Gll"),
}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("route", list(ROUTES))
def test_plain_is_the_chain_before_the_kernel(route, mesh, no_kernel):
    # On the CPU `_locate` runs `_locate_plain`, bit for bit the code it
    # ran before the kernel, and counts one eager call.
    model = _model(route, **MESHES[mesh])
    for k in (0, 37):
        dep = model._departure_points(k * DT, (k + 1) * DT, None)
        (ci, w), ctr = _counted(model._locate, dep)
        ci0, w0 = _locate_before(model, dep)
        assert ctr == {"locate.eager": 1}
        assert torch.equal(ci, ci0) and _same_bits(w, w0)


def test_subcell_mesh_stays_eager(no_kernel):
    sub = cubed_sphere.build(2, 4, device="cpu", mesh_type="gllsubcell")
    model = IslTransport(sub, WIND, IslConfig(ne=sub.ne, np_=sub.np_,
                                              basis="Gll", nsub=2))
    dep = model._departure_points(0.0, DT, None)
    (ci, w), ctr = _counted(model._locate, dep)
    assert ctr == {"locate.eager": 1}
    ci0, w0 = _locate_before(model, dep)
    assert torch.equal(ci, ci0) and _same_bits(w, w0)


@pytest.mark.parametrize("exp", [1, 5])
def test_prefine_locates_eagerly_on_the_cpu(exp, no_kernel):
    # Both grids' cell location per step, eager on the CPU, equal to the
    # chain the p-refinement step ran before the kernel.
    from compose_tpu_torch.transport.prefine import (PRefineConfig,
                                                     PRefineTransport)

    mf = cubed_sphere.build(3, 6, device="cpu")
    model = PRefineTransport(mf, WIND, PRefineConfig(
        ne=3, np_=6, nsub=2, experiment=exp, filter="caas",
        limiter="caas"))
    ((vdep, ci_v, w_v), (ci_f, w_f)), ctr = _counted(model._departure, 0.0,
                                                     DT)
    assert ctr.get("locate.eager") == 2 and "locate.kernel" not in ctr
    m = model.mesh_v
    c0, a0, b0 = cubed_sphere.get_cell_coords(m.ne, vdep, m.rot_R)
    a, b = sqr.sphere_to_ref(m.corners[c0], vdep, max_its=4, a0=a0, b0=b0)
    ea, eb = model.basis_v.eval(a), model.basis_v.eval(b)
    assert torch.equal(ci_v, c0)
    assert _same_bits(w_v, (eb[:, :, None] * ea[:, None, :]).reshape(
        m.cnn, m.np2))
    assert w_f.shape == (model.mesh_f.cnn, 36) and ci_f.dtype == torch.int64
    assert model.loc_v.nodes is not None and model.loc_f.nodes is None


@pytest.mark.parametrize("route", list(ROUTES))
def test_kernel_operands_are_built_once(route, monkeypatch):
    # The kernel path's host side makes no tensor and no copy after the
    # first call: the corner table, the rotation and the scalars are kept.
    model = _model(route, rotate=((0.0, 0.0, 1.0), 0.4))
    loc = model.locator
    dep = model._departure_points(0.0, DT, None).contiguous()
    calls = []
    out = (torch.zeros(len(dep), dtype=torch.int64),
           torch.zeros(len(dep), 16, dtype=model.real))

    def fake(p, corners, ne, max_its, table, p_idx=None, wdtype=None):
        calls.append((corners, p_idx, table, max_its, wdtype))
        return out
    monkeypatch.setattr(locate, "locate_cells", fake)
    loc(dep)
    made = []
    for name in ("tensor", "as_tensor", "empty", "zeros"):
        real = getattr(torch, name)
        monkeypatch.setattr(torch, name, lambda *a, _r=real, **k: (
            made.append(_r), _r(*a, **k))[1])
    real_to = torch.Tensor.to
    monkeypatch.setattr(torch.Tensor, "to", lambda self, *a, **k: (
        made.append("to"), real_to(self, *a, **k))[1])
    loc(dep)
    monkeypatch.undo()
    assert made == []
    (c1, p1, t1, its, wd), (c2, p2, t2, _, _) = calls
    assert c1 is c2 and t1 is t2 and wd == model.real
    assert its == (3 if model.config.geom_dtype == "f32" else 4)
    assert c1.dtype == dep.dtype and c1.is_contiguous()
    R = model.mesh.rot_R.to(dep.dtype)
    assert torch.equal(p1, dep @ R)


def test_table_rounds_as_the_eager_chain():
    # The host scalars against the eager ops that form them, in f32 and
    # f64: the reciprocal PyTorch multiplies by for a division by a Python
    # float, the blend's constants, 1 - x[2] and the Lagrange denominators
    # as basis._lagrange_eval forms them.
    xn64 = basis_mod.create("GllNodal", 4).x
    for dtype in (F32, F64):
        s = np_scalar(dtype)
        t = locate.locate_table(dtype, 1e-6, xn64)
        assert t.shape == (locate.TABLE_LEN,) and t.dtype == np.float64
        assert all(float(s(v)) == v for v in t)
        assert t[0] == float(s(1.0) / s(0.25 * np.pi))
        assert t[1] == float(s(1e-12))
        assert (t[2], t[3]) == (float(s(0.306)), float(s(0.5 - 0.306)))
        xn = xn64.to(dtype)
        assert t[4] == float(1 - xn[2])
        assert np.array_equal(t[5:9], xn.double().numpy())

        def den(nodes):
            m = nodes.shape[0]
            return [float(basis_mod._prod_chain(torch.stack(
                [nodes[i] - nodes[j] for j in range(m) if j != i])))
                for i in range(m)]
        assert list(t[9:13]) == den(xn)
        assert list(t[13:16]) == den(xn[0:3])
        assert list(t[16:19]) == den(xn[1:4])
    bare = locate.locate_table(F32, 1e-6)
    assert bare.shape == (locate.TABLE_LEN,) and not bare[4:].any()


@pytest.mark.parametrize("name,np_,want", [
    ("GllNodal", 4, True), ("GllOffsetNodal", 4, True),
    ("GllNodal", 3, False), ("GllNodal", 6, False), ("Gll", 4, False),
    ("UniformOffsetNodal", 4, False), ("FreeNodal", 4, False)])
def test_which_bases_the_kernel_evaluates(name, np_, want):
    bas = basis_mod.create(name, np_)
    nodes = basis_mod.np4_subgrid_nodes(bas)
    assert (nodes is not None) == want
    if want:
        x = torch.linspace(-1, 1, 41, dtype=F64)
        assert torch.equal(bas.eval(x), basis_mod._np4_subgrid_eval(nodes,
                                                                    x))


def test_wrapper_refuses_before_launching(monkeypatch):
    # The wrapper's checks run before any launch: CPU operands, another
    # dtype or shape, a short table, weights of another type.
    monkeypatch.setattr(_native, "lib", lambda: pytest.fail("launched"))
    model = _model("f64-f64")
    dep = model._departure_points(0.0, DT, None)
    corners, _, table = model.locator.constants(torch.device("cpu"))
    for args, kw, err in (
            ((dep, corners, 4, 4, table), {}, ValueError),
            ((dep.half(), corners, 4, 4, table), {}, TypeError),
            ((dep[:, :2], corners, 4, 4, table), {}, ValueError),
            ((dep, corners, 4, 4, table), dict(wdtype=F32), ValueError)):
        with pytest.raises(err):
            locate.locate_cells(*args, **kw)
    with pytest.raises(TypeError):
        model.locator(dep.float())
