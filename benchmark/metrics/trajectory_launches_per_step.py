"""trajectory_launches_per_step: device operations launched while rank 0's
host was inside the program's span "isl.departure.trajectory", per
profiled step: each operation of torch.profiler's trace of the traced
steps tied to its launch by the profiler's correlation id
(progtrace.reduce_program)."""


def read(rec):
    pt, t = rec.get("program_trace"), rec.get("trace")
    if not pt or not pt[0] or not t or not t["steps"]:
        return None
    d = pt[0]["spans"].get("isl.departure.trajectory")
    if not d:
        return None
    return d["launches"] / t["steps"]
