"""departure_ms: host milliseconds per window step inside
IslTransport._departure_data (the DoPri5 trajectories, cell location,
Newton inverse and basis weights; in the sharded cell, of the rank's
nodes). Source: the benchmark's span "departure" (trace.Spans, a host
clock and a torch.profiler label around the call), over every step of
the --trace 1 run's window."""


def read(rec):
    s = rec["span_s"].get("departure")
    if not s or not rec["steps"]:
        return None
    return 1e3 * s / rec["steps"]
