"""locate_ms: host milliseconds per window step inside the program's span
"isl.departure.locate": cell location (cubed_sphere.locate), the Newton
inverse to reference coordinates (sqr.sphere_to_ref) and the basis
weights; rank 0's on four cards. Source: the program's tracer summary
over every step of the --trace 1 run's window."""


def read(rec):
    d = (rec.get("program") or {}).get("spans", {}).get(
        "isl.departure.locate")
    if not d or not rec["steps"]:
        return None
    return 1e3 * d["s"] / rec["steps"]
