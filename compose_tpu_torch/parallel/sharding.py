"""The cell-sharded step on DTensor (compose_tpu.parallel.sharding): the
annotate-and-propagate baseline.

The state is annotated as sharded over cells (rho (ncell, np2) as
Shard(0), q (nt, ncell, np2) as Shard(1)) on a 1-D device mesh named
"cells", and the model's unchanged single-device step runs on those
DTensors. DTensor's sharding propagation partitions the per-cell work and
inserts the collectives, as GSPMD does for the JAX package: the
departure-cell gathers all-gather the state, after which the step runs
replicated on every rank. The mesh tables and constants the step closes
over are plain tensors on the rank's device, taken as replicated
(`implicit_replication`). The kernels K1-K3 reach each rank's local
tensors through their wrappers' DTensor route (`_native.on_local`); a CPU
DTensor takes their plain versions. The halo exchange of
parallel/sharded.py is the designed path; this one all-gathers the state.

One rank is one device: the process group (gloo on the CPU, NCCL with
one rank per card) must be initialised before `cell_mesh`.
"""

from collections import defaultdict

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Shard, distribute_tensor
from torch.distributed.tensor.debug import CommDebugMode
from torch.distributed.tensor.experimental import implicit_replication

RHO_PLACEMENTS = (Shard(0),)
Q_PLACEMENTS = (Shard(1),)


def cell_mesh(n_devices: int = None, device_type: str = "cuda"):
    """1-D device mesh named ("cells",) over the initialised process group,
    one device per rank; device_type "cpu" for gloo on the CPU."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("cell_mesh: torch.distributed is not initialised")
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"cell_mesh: {n_devices} devices asked for, the "
                         f"process group has {world} ranks")
    return init_device_mesh(device_type, (world,), mesh_dim_names=("cells",))


def shard_state(mesh, rho, q):
    """Place rho (ncell, np2) and q (nt, ncell, np2) with cells sharded.
    Every rank passes the same global tensors."""
    return (distribute_tensor(rho, mesh, RHO_PLACEMENTS),
            distribute_tensor(q, mesh, Q_PLACEMENTS))


def sharded_step(model, mesh):
    """The model's step on cell-sharded DTensors: a callable (rho_s, q_s,
    ts, tf) -> (rho_s, q_s) that runs model._step_impl unchanged under
    implicit replication, DTensor inserting the collectives, and returns
    the state in the input placements."""
    def step(rho_s, q_s, ts, tf):
        with implicit_replication():
            rho, q = model._step_impl(rho_s, q_s, ts, tf)
        return (rho.redistribute(mesh, RHO_PLACEMENTS),
                q.redistribute(mesh, Q_PLACEMENTS))
    return step


class CommCounter(CommDebugMode):
    """CommDebugMode that also sums the bytes of each collective's output
    (an all-gather's output is the gathered tensor, an all-reduce's the
    reduced one). `per_op()`: {collective: (count, output bytes)};
    `triggers`: per collective, (its name, the DTensor op whose
    redistribution issued it, that op's input shapes)."""

    def __init__(self):
        super().__init__()
        self.out_bytes = defaultdict(int)
        self.triggers = []
        self._last = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        n0 = self.get_total_counts()
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if out is NotImplemented:
            self._last = (func._overloadpacket.__name__, [
                tuple(a.shape) for a in args if isinstance(a, torch.Tensor)])
        elif self.get_total_counts() > n0:
            name = func._overloadpacket.__name__
            for t in (out if isinstance(out, (list, tuple)) else [out]):
                if isinstance(t, torch.Tensor):
                    self.out_bytes[name] += t.numel() * t.element_size()
            self.triggers.append((name,) + (self._last or (None, [])))
        return out

    def per_op(self):
        counts = {k.__name__: v for k, v in self.get_comm_counts().items()}
        return {k: (counts.get(k, 0), b) for k, b in self.out_bytes.items()}


def received_bytes(per_op, world: int) -> float:
    """Bytes that reach one rank from the others, from CommCounter.per_op:
    (world - 1) / world of each collective's output (an all-gather's
    exact share; an all-reduce's least)."""
    return sum(b for _, b in per_op.values()) * (world - 1) / world
