"""mn2_ms: host milliseconds per window step inside the program's span
"cdr.mn2": the cell-local mn2 limiter's Newton QP
(limiter.limit_tracer with limiter mn2), a host sync per iteration.
Source: the program's tracer summary over every step of the --trace 1
run's window."""


def read(rec):
    d = (rec.get("program") or {}).get("spans", {}).get("cdr.mn2")
    if not d or not rec["steps"]:
        return None
    return 1e3 * d["s"] / rec["steps"]
