"""A DistComm that counts the bytes of its collectives (the
`comm_bytes_per_step` metric of the sharded cells).

Bytes are those this rank receives: a point-to-point buffer per source
that sends to it, and the other ranks' parts of an all-gather (`sum` is
an all-gather followed by local adds).
"""

from compose_tpu_torch.parallel.comm import DistComm


class CountingDistComm(DistComm):
    """DistComm with `bytes` and `p2p_bytes` counters, which count only
    while `on`."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.on = False
        self.reset()

    def reset(self):
        self.bytes = 0
        self.p2p_bytes = 0

    def _count(self, nbytes, p2p=False):
        if self.on:
            self.bytes += nbytes
            if p2p:
                self.p2p_bytes += nbytes

    def ppermute(self, x, perm):
        out = super().ppermute(x, perm)
        nsrc = sum(1 for _, d in perm if d == self.rank)
        self._count(nsrc * x.numel() * x.element_size(), p2p=True)
        return out

    def all_gather(self, x, dim=0):
        out = super().all_gather(x, dim)
        self._count((self.size - 1) * x.numel() * x.element_size())
        return out
