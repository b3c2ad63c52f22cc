"""The readings that the limits of `correct` are set from: the port's
numbers over many seeds and the control's over a few, at the cell's own
size, in one process (one set of ranks for a four-card cell).

    python3 -m benchmark.control --workload <name> --seeds 1,2,... \
        --control-seeds 7,8,9 [--seconds 1]

The control is the port's single-precision route (x64 off) in place of
the configured float64, judged by the same reference. Each window runs
at least the traffic's `sample_within` steps, which hold the sampled
steps. One JSON line per run: workload, seed, variant, steps and the
numbers (check.compare); then the largest program reading and the
smallest control reading of each number.
"""

import argparse
import json
import sys
import time

import torch

from . import harness, spec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=1.0)
    a = ap.parse_args(argv)
    cell = spec.Cell(a.workload)
    harness.require_cards(cell.chips)
    jobs = [(int(s), "program") for s in a.seeds.split(",") if s] + \
        [(int(s), "control") for s in a.control_seeds.split(",") if s]
    t0 = time.time()
    if cell.chips == 1:
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        out = [harness.rank_run(cell, s, a.seconds, False, dev, time.time(),
                                v) for s, v in jobs]
    else:
        out = harness.run_ranks(cell.chips, dict(
            workload=cell.name, seed=None, seconds=a.seconds, trace=False,
            t_start=t0, variant=None, smi_dir=None, jobs=jobs),
            timeout=3000)
    worst = {}
    for (seed, variant), res in zip(jobs, out):
        print(json.dumps(dict(workload=cell.name, seed=seed, variant=variant,
                              steps=res["nsteps"], nums=res["nums"],
                              check_s=res["check_s"],
                              step_ms_median=sorted(res["step_ms"])[
                                  len(res["step_ms"]) // 2])), flush=True)
        for k, v in res["nums"].items():
            w = worst.setdefault(variant, {})
            w[k] = (max if variant == "program" else min)(w.get(k, v), v)
    print(json.dumps(dict(workload=cell.name, program_max=worst.get(
        "program"), control_min=worst.get("control"),
        seconds=time.time() - t0)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
