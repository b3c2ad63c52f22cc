"""step_dof_per_s: tracer_dof_per_s read per layer, in the traced run's
measured window: the whole globe's tracer DOF (6 ne^2 np^2 ntracer) times
the steps completed, over the window's seconds on the host clock. It
stands for the rate in a cell where the host swings that rate from run
to run by more than an end-to-end bound can hold."""


def read(rec):
    if not rec.get("steps") or not rec.get("dof_per_s"):
        return None
    return rec["dof_per_s"]
