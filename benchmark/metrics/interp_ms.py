"""interp_ms: host milliseconds per window step inside
IslTransport._interp_phase (the departure interpolation of rho and the
tracers and the Jacobian ratio). Source: the benchmark's span "interp"
(trace.Spans, a host clock and a torch.profiler label around the call),
over every step of the --trace 1 run's window."""


def read(rec):
    s = rec["span_s"].get("interp")
    if not s or not rec["steps"]:
        return None
    return 1e3 * s / rec["steps"]
