"""qlt_ms: host milliseconds per window step inside the program's span
"cdr.qlt": the QLT tree's sweeps of the global redistribution
(spf.MassRedistributor, filter qlt), for rho and for the tracers. Source:
the program's tracer summary over every step of the --trace 1 run's
window."""


def read(rec):
    d = (rec.get("program") or {}).get("spans", {}).get("cdr.qlt")
    if not d or not rec["steps"]:
        return None
    return 1e3 * d["s"] / rec["steps"]
