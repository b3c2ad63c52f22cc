"""Communicators over the "cells" axis (the counterpart of the JAX package's
1-D device mesh, compose_tpu.parallel.sharding.cell_mesh).

A communicator has `rank`, `size`, `device` and exactly the collectives the
sharded paths use:

  ppermute(x, perm)  - point-to-point: rank src sends x to rank dst for
                       each (src, dst) in perm; returns what this rank
                       receives (zeros if it receives nothing);
  all_gather(x, dim) - every rank's x stacked along a new axis `dim`, in
                       rank order, on every rank;
  sum(x)             - the elementwise sum over ranks, folded in rank
                       order (the non-BFB form of cdr.bfb.allreduce).

Two implementations run the same per-shard code:

  DistComm  - a torch.distributed process group: NCCL with one GPU per
              rank, or gloo for CPU processes;
  LocalComm - n shards in one process on one device, one thread per shard
              (each on its own CUDA stream on a GPU); a collective hands
              each shard the other shards' tensors once all have arrived.
              `run(fn)` calls fn(comm) on every shard and returns the
              results in rank order.
"""

import threading

import torch

from ..config import resolve_device


class DistComm:
    """One rank of a torch.distributed process group (already initialised
    by the caller, e.g. under torchrun). backend nccl needs a CUDA device
    per rank; gloo runs on the CPU. There is no fallback between them."""

    def __init__(self, device=None, group=None):
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError("DistComm: torch.distributed is not "
                               "initialised")
        self._dist = dist
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        backend = dist.get_backend(group)
        if backend == "nccl":
            if not torch.cuda.is_available():
                raise RuntimeError("DistComm: the nccl backend needs a CUDA "
                                   "device")
            self.device = resolve_device(
                device if device is not None
                else f"cuda:{self.rank % torch.cuda.device_count()}")
            if self.device.type != "cuda":
                raise RuntimeError("DistComm: the nccl backend needs a CUDA "
                                   "device")
        else:
            self.device = resolve_device("cpu" if device is None else device)

    def _peer(self, r):
        return r if self.group is None else \
            self._dist.get_global_rank(self.group, r)

    def ppermute(self, x, perm):
        """Send x along `perm`; the send and the receive are issued
        together (batch_isend_irecv), sends first, so no rank waits on
        another's order."""
        x = x.contiguous()
        dst = [d for s, d in perm if s == self.rank]
        src = [s for s, d in perm if d == self.rank]
        buf = torch.zeros_like(x)
        ops = [self._dist.P2POp(self._dist.isend, x, self._peer(d),
                                self.group) for d in dst]
        ops += [self._dist.P2POp(self._dist.irecv, buf, self._peer(s),
                                 self.group) for s in src]
        if ops:
            for req in self._dist.batch_isend_irecv(ops):
                req.wait()
        return buf

    def all_gather(self, x, dim=0):
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        self._dist.all_gather(parts, x, group=self.group)
        return torch.stack(parts, dim=dim)

    def sum(self, x):
        g = self.all_gather(x, 0)
        acc = g[0]
        for r in range(1, self.size):
            acc = acc + g[r]
        return acc


class _Aborted(RuntimeError):
    """Another shard of the same LocalComm.run raised."""


class _Shared:
    """State the shards of one LocalComm.run share: the run lock (held by
    the one shard that runs Python; the others wait in a collective or
    for the lock), and per collective its deposits and arrivals."""

    def __init__(self, n):
        self.n = n
        self.cond = threading.Condition()
        self.slots = ([None] * n, [None] * n)    # by generation parity
        self.count = {}
        self.aborted = False


class _LocalRank:
    """One shard's view of a LocalComm."""

    def __init__(self, shared, rank, size, device, stream):
        self._sh = shared
        self.rank = rank
        self.size = size
        self.device = device
        self._stream = stream
        self._gen = 0

    def _exchange(self, x, sources):
        """Deposit x, wait until every shard has deposited in this
        collective, and return the deposits of `sources` (in order).
        Called with the run lock held; waiting releases it. Deposits are
        double-buffered by generation: a shard deposits again only after
        every shard has read the previous collective. On a GPU the reader's
        stream waits for the producer's, and the tensor is marked used on
        the reader's stream for the caching allocator."""
        sh, r = self._sh, self.rank
        gen = self._gen
        self._gen += 1
        ev = None
        if self._stream is not None:
            ev = torch.cuda.Event()
            ev.record(self._stream)
        sh.slots[gen % 2][r] = (x, ev)
        sh.count[gen] = sh.count.get(gen, 0) + 1
        if sh.count[gen] == sh.n:
            sh.cond.notify_all()
        else:
            sh.cond.wait_for(lambda: sh.aborted or sh.count[gen] == sh.n)
        if sh.aborted:
            raise _Aborted("another shard failed")
        out = []
        for s in sources:
            y, ev_s = sh.slots[gen % 2][s]
            if ev_s is not None:
                self._stream.wait_event(ev_s)
                y.record_stream(self._stream)
            out.append(y)
        return out

    def ppermute(self, x, perm):
        src = [s for s, d in perm if d == self.rank]
        got = self._exchange(x, src)
        return got[0].clone() if got else torch.zeros_like(x)

    def all_gather(self, x, dim=0):
        return torch.stack(self._exchange(x, range(self.size)), dim=dim)

    def sum(self, x):
        g = self._exchange(x, range(self.size))
        acc = g[0]
        for y in g[1:]:
            acc = acc + y
        return acc


class LocalComm:
    """`n_shards` shards in this process on one device. run(fn) starts one
    thread per shard (each on its own CUDA stream on a GPU), calls
    fn(comm) with that shard's communicator and returns the results in
    rank order. One shard runs Python at a time: each holds the run lock
    until it waits in a collective, so the threads never contend for the
    interpreter, while the kernels they launch overlap on their streams.
    An exception in any shard stops the others and is raised from
    run()."""

    def __init__(self, n_shards: int, device="cuda"):
        if n_shards < 1:
            raise ValueError("LocalComm needs n_shards >= 1")
        self.size = n_shards
        self.device = resolve_device(device)

    def run(self, fn):
        n = self.size
        cuda = self.device.type == "cuda"
        if cuda:
            from .. import _native
            _native.lib()              # build once, before the threads
            main = torch.cuda.current_stream(self.device)
            start = torch.cuda.Event()
            start.record(main)
            streams = [torch.cuda.Stream(self.device) for _ in range(n)]
        sh = _Shared(n)
        results = [None] * n
        errors = []
        ends = [None] * n

        def worker(r):
            stream = streams[r] if cuda else None
            comm = _LocalRank(sh, r, n, self.device, stream)
            with sh.cond:
                try:
                    if cuda:
                        torch.cuda.set_device(self.device)
                        stream.wait_event(start)
                        with torch.cuda.stream(stream):
                            results[r] = fn(comm)
                            ends[r] = torch.cuda.Event()
                            ends[r].record(stream)
                    else:
                        results[r] = fn(comm)
                except BaseException as e:  # noqa: BLE001 - raised below
                    errors.append(e)
                    sh.aborted = True
                    sh.cond.notify_all()

        threads = [threading.Thread(target=worker, args=(r,), daemon=True)
                   for r in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            real = [e for e in errors if not isinstance(e, _Aborted)]
            raise (real or errors)[0]
        if cuda:
            for r in range(n):
                main.wait_event(ends[r])
                _record(results[r], main)
        return results


def _record(obj, stream):
    """Mark every tensor in a result as used on `stream`, so the caching
    allocator does not hand its memory back to the shard's stream while
    the caller still reads it there."""
    if torch.is_tensor(obj):
        if obj.is_cuda:
            obj.record_stream(stream)
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            _record(o, stream)
    elif isinstance(obj, dict):
        for o in obj.values():
            _record(o, stream)
