"""trajectory_ms: host milliseconds per window step inside the program's
span "isl.departure.trajectory" (compose_tpu_torch/trace.py): the
departure points' DoPri5 integration of the CGLL nodes, or of the coarse
velocity grid and its interpolation to them; on four cards, of the
rank's nodes, rank 0's. Source: the program's tracer summary over every
step of the --trace 1 run's window."""


def read(rec):
    d = (rec.get("program") or {}).get("spans", {}).get(
        "isl.departure.trajectory")
    if not d or not rec["steps"]:
        return None
    return 1e3 * d["s"] / rec["steps"]
