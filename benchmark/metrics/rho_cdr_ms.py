"""rho_cdr_ms: host milliseconds per window step inside the density CDR
(IslTransport._rho_cdr, or ShardedIsl._rho_cdr on the rank's block): the
global redistribution, the positivity limiter and the density DSS.
Source: the benchmark's span "rho_cdr" (trace.Spans, a host clock and a
torch.profiler label around the call), over every step of the --trace 1
run's window."""


def read(rec):
    s = rec["span_s"].get("rho_cdr")
    if not s or not rec["steps"]:
        return None
    return 1e3 * s / rec["steps"]
