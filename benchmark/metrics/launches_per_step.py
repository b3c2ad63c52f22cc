"""launches_per_step: device operations (kernels, copies, fills) in
torch.profiler's trace of the traced steps, per step, on rank 0."""


def read(rec):
    t = rec.get("trace")
    if not t or not t["steps"]:
        return None
    return t["launches"] / t["steps"]
