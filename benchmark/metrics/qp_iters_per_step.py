"""qp_iters_per_step: Newton iterations of local_qp.solve_1eq_bc_qp per
window step, the program's counter "qp.newton_iters" (one per run of the
loop's body; the loop's test before each is a host sync). Source: the
program's tracer summary over every step of the --trace 1 run's
window."""


def read(rec):
    c = (rec.get("program") or {}).get("counters", {}).get(
        "qp.newton_iters")
    if c is None or not rec["steps"]:
        return None
    return c / rec["steps"]
