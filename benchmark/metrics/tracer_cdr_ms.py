"""tracer_cdr_ms: host milliseconds per window step inside the tracer CDR
(IslTransport._tracer_cdr, or ShardedIsl._tracer_cdr on the rank's
block): records, global redistribution and the cell-local limiter.
Source: the benchmark's span "tracer_cdr" (trace.Spans, a host clock and
a torch.profiler label around the call), over every step of the --trace
1 run's window."""


def read(rec):
    s = rec["span_s"].get("tracer_cdr")
    if not s or not rec["steps"]:
        return None
    return 1e3 * s / rec["steps"]
