"""bfb_ms: device milliseconds per profiled step of the NCCL kernels
launched while the host was inside the program's span "comm.bfb": the
global redistribution's all-gathers: the BFB tree allreduce
(cdr/bfb.py), the sharded QLT's frontier and mn2's records. Each kernel
is tied to its launch by torch.profiler's correlation id
(progtrace.reduce_program); averaged over the ranks as comm_ms is. An
NCCL kernel spins until its peers arrive, so the wait counts."""


def read(rec):
    pt, t = rec.get("program_trace"), rec.get("trace")
    if not pt or not all(pt) or not t or not t["steps"]:
        return None
    s = [r["spans"].get("comm.bfb", {}).get("nccl_s", 0.0) for r in pt]
    if not any(s):
        return None
    return 1e3 * sum(s) / len(s) / t["steps"]
