"""dss_ms: host milliseconds per window step inside IslTransport._dss_q,
the tracers' mixing-ratio DSS (K3). Source: the benchmark's span "dss"
(trace.Spans, a host clock and a torch.profiler label around the call),
over every step of the --trace 1 run's window."""


def read(rec):
    s = rec["span_s"].get("dss")
    if not s or not rec["steps"]:
        return None
    return 1e3 * s / rec["steps"]
