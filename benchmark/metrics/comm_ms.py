"""comm_ms: device milliseconds per step in which the sharded step's
collectives ran: the union of the NCCL kernels' intervals (the halo and
DSS point-to-point exchanges, the BFB allreduce's all-gathers) in
torch.profiler's trace of the traced steps, averaged over the ranks. An
NCCL kernel spins until its peers arrive, so the time includes the wait
for the other ranks as well as the exchange itself."""


def read(rec):
    t = rec.get("trace")
    if not t or not t["steps"] or not rec.get("nccl_s"):
        return None
    return 1e3 * rec["nccl_s"] / t["steps"]
