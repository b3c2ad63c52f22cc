"""QLT phase timers, the analogue of the reference's `cedr_test -pt` perf
test (compose_tpu's tools/qlt_perftest.py) on the port.

Times the single-device QLT: tree construction and schedule analysis
(once each, host clock), the full run (`QLT.run`: on a card the kernel
csrc/qlt_tree.cu, one launch), the eager level loop (`QLT.run_plain`), its
l2r combine sweep alone, and the r2l residual; and with -ndev the sharded
QLT (cdr/qlt_sharded.py) over a LocalComm of that many shards on the
device: its analysis, the full run and the frontier-gather size. Device
times come from CUDA events around `-nr` synchronized repetitions (the
host clock on the CPU). The inputs are those of the JAX tool, drawn from
the same numpy seed. The run must equal the eager loop bitwise, and the
sharded result the single QLT's; the exit code is 1 if either does not.

    python -m compose_tpu_torch.tools.qlt_perftest [-nc 5400] [-nt 40]
        [-nr 20] [-ndev 8] [--device cuda]
"""

import argparse
import sys
import time

import numpy as np
import torch

from ..cdr import qlt as qlt_mod
from ..cdr import tree as tree_mod
from ..cdr.qlt_sharded import ShardedQLT
from ..config import F64, resolve_device
from ..parallel.comm import LocalComm


def inputs(nc, nt, device):
    """rhom (nc,), Qm, Qm_min, Qm_max (nt, nc): the JAX tool's draws."""
    rng = np.random.default_rng(0)
    r = rng.uniform(0.5, 1.0, nc)
    qmin = rng.uniform(0, .3, (nt, nc))
    qmax = qmin + rng.uniform(.2, .5, (nt, nc))
    Qm = ((qmin + (qmax - qmin) * rng.uniform(0, 1, (nt, nc))) * r
          + 0.2 * rng.standard_normal((nt, nc)) * r)
    return [torch.tensor(x, dtype=F64, device=device)
            for x in (r, Qm, qmin * r, qmax * r)]


def rep_ms(fn, nr, device):
    """ms per call of fn over nr calls after one warm-up, synchronized:
    CUDA events on a card, the host clock on the CPU. Returns (ms, the
    last output)."""
    out = fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(nr):
            out = fn()
        return (time.perf_counter() - t0) / nr * 1e3, out
    torch.cuda.synchronize(device)
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(nr):
        out = fn()
    b.record()
    torch.cuda.synchronize(device)
    return a.elapsed_time(b) / nr, out


def l2r_only(solver, Qm):
    """The leaf-to-root combine sweep alone (QLT.run's summed channels
    for Qm)."""
    t = solver.tree
    V = torch.zeros(Qm.shape[:-1] + (t.nnodes,), dtype=Qm.dtype,
                    device=Qm.device)
    V[:, :t.nleaf] = Qm
    for lv in solver._levels_on(Qm.device):
        v1 = torch.where(lv.single, 0.0, V[..., lv.k1s])
        V.index_copy_(-1, lv.ids, V[..., lv.k0] + v1)
    return V


def run(nc=5400, nt=40, nr=20, ndev=0, device="cuda"):
    """Print the timers; returns {name: ms}, whether the run equals the
    eager loop bitwise (key "kernel_bitwise") and, with ndev, whether the
    sharded QLT equals the single one bitwise (key "bitwise")."""
    dev = resolve_device(device)
    rhom, Qm, Qm_min, Qm_max = inputs(nc, nt, dev)
    t0 = time.perf_counter()
    tree_mod.build(nc)
    res = {"tree": (time.perf_counter() - t0) * 1e3}
    t0 = time.perf_counter()
    solver = qlt_mod.QLT(nc, problem_type=qlt_mod.SHAPEPRESERVE)
    solver._levels_on(dev)
    res["analyze"] = (time.perf_counter() - t0) * 1e3
    kernel = solver.takes_kernel(Qm)
    res["qltrun"], single = rep_ms(
        lambda: solver.run(rhom, Qm, Qm_min, Qm_max), nr, dev)
    res["qltrun_plain"], plain = rep_ms(
        lambda: solver.run_plain(rhom, Qm, Qm_min, Qm_max), nr, dev)
    res["kernel_bitwise"] = torch.equal(single, plain)
    res["l2r"], _ = rep_ms(lambda: l2r_only(solver, Qm), nr, dev)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"QLT perftest nc={nc} nt={nt} nr={nr} device={name}")
    print(f"  tree     {res['tree']:9.3f} ms (one-time, host)")
    print(f"  analyze  {res['analyze']:9.3f} ms (one-time, host)")
    print(f"  qltrun   {res['qltrun']:9.3f} ms/rep ("
          + ("the kernel, one launch" if kernel else "the eager loop")
          + ")")
    print(f"  eager    {res['qltrun_plain']:9.3f} ms/rep (the level loop; "
          f"run == eager: "
          f"{'bitwise' if res['kernel_bitwise'] else 'DIFFERENT'})")
    print(f"  ~l2r     {res['l2r']:9.3f} ms/rep (the loop's combine sweep "
          f"alone)")
    print(f"  ~r2l     {res['qltrun_plain'] - res['l2r']:9.3f} ms/rep "
          f"(the loop's residual: node QPs)")
    if ndev:
        t0 = time.perf_counter()
        sq = ShardedQLT(nc, ndev)
        res["sharded_analyze"] = (time.perf_counter() - t0) * 1e3
        comm = LocalComm(ndev, dev)
        blk = [sq.scatter_leaves(x).reshape(x.shape[:-1] + (ndev, -1))
               for x in (Qm, Qm_min, Qm_max)]
        rb = sq.scatter_leaves(rhom, fill=1.0).reshape(ndev, -1)

        def sharded():
            return comm.run(lambda c: sq.run(
                c, rb[c.rank], *(b[:, c.rank] for b in blk)))

        res["sharded_qltrun"], out = rep_ms(sharded, nr, dev)
        res["frontier"] = sq.n_shards * sq.max_nf
        res["bitwise"] = torch.equal(sq.gather_leaves(torch.cat(out, -1)),
                                     single)
        print(f"  sharded analyze ({ndev} shards) "
              f"{res['sharded_analyze']:9.3f} ms (host)")
        print(f"  sharded qltrun  ({ndev} shards) "
              f"{res['sharded_qltrun']:9.3f} ms/rep (frontier gather = "
              f"{res['frontier']} scalars/ch)")
        print(f"  sharded == single: "
              f"{'bitwise' if res['bitwise'] else 'DIFFERENT'}")
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-nc", type=int, default=5400)
    ap.add_argument("-nt", type=int, default=40)
    ap.add_argument("-nr", type=int, default=20)
    ap.add_argument("-ndev", type=int, default=0,
                    help="also run the sharded QLT over this many shards")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    res = run(a.nc, a.nt, a.nr, a.ndev, a.device)
    return 0 if res["kernel_bitwise"] and res.get("bitwise", True) else 1


if __name__ == "__main__":
    sys.exit(main())
