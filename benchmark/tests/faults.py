"""Faults planted under the timed path, for the tests that see `correct`
come out false. Each is a hook: it takes the harness's Program and breaks
its step."""

import torch


def unchanged(prog):
    """A step that returns its state unchanged."""
    prog.step = lambda rho, q, ts, tf: (rho, q)


def half_batch(prog):
    """Half of the tracers left out; the mean over the rest stands in."""
    step = prog.step

    def half(rho, q, ts, tf):
        n = q.shape[0] // 2
        rho1, q1 = step(rho, q[:n].contiguous(), ts, tf)
        rest = q1.mean(0, keepdim=True).expand((q.shape[0] - n,)
                                               + q1.shape[1:])
        return rho1, torch.cat([q1, rest])

    prog.step = half


def altered(prog):
    """One tracer value altered where the step produces it."""
    step = prog.step

    def alter(rho, q, ts, tf):
        rho1, q1 = step(rho, q, ts, tf)
        q1 = q1.clone()
        q1.view(-1)[q1.numel() // 3] *= 1.001
        return rho1, q1

    prog.step = alter


def nan(prog):
    """One tracer value made NaN where the step produces it."""
    step = prog.step

    def poison(rho, q, ts, tf):
        rho1, q1 = step(rho, q, ts, tf)
        q1 = q1.clone()
        q1.view(-1)[q1.numel() // 5] = float("nan")
        return rho1, q1

    prog.step = poison


def jax_loaded(prog):
    """Not a fault of the step: a module named jax appears in sys.modules
    of a rank other than 0 (or of the only rank)."""
    import sys
    import types

    if prog.comm is None or prog.comm.rank != 0:
        sys.modules.setdefault("jax", types.ModuleType("jax"))


def no_exchange(prog):
    """The exchange between ranks left out: every point-to-point receive
    gets zeros."""
    comm = prog.comm
    comm.ppermute = lambda x, perm: torch.zeros_like(x)
