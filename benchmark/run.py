"""Run one cell of the benchmark and print its result line.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1> [--smi-dir DIR]

The last line of standard output is one JSON object: correct, attempted
(steps in the window), failed (compared numbers over their limits),
metrics (the cell's end-to-end metrics with --trace 0, its per-layer
metrics with --trace 1), device, with --trace 1 the breakdown, and last
the compared numbers beside their limits, which also close standard
error. nvidia-smi's clocks and power, read just before and just after
the window, go to a CSV file under --smi-dir (default build/bench/ in
the checkout).

Exits non-zero, printing no result, without the CUDA cards the cell asks
for, when a module of JAX or of the JAX package is loaded, or on any
error. There is no fallback to the CPU.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from . import spec  # noqa: E402


def _cache_dirs():
    """Every build and kernel cache inside the checkout, at fixed paths:
    the port's kernel library is built in build/kernels/ by the port
    itself; Triton's and torch's extension caches go beside it."""
    build = spec.ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["USE_FLAX"] = "0"


def _rounded(d):
    return {k: round(v, 3) for k, v in d.items()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--smi-dir", default=str(spec.ROOT / "build" / "bench"))
    a = ap.parse_args(argv)
    _cache_dirs()

    from . import harness

    cell = spec.Cell(a.workload)
    try:
        res = harness.run_cell(cell, a.seed, a.seconds, bool(a.trace),
                               T_START, smi_dir=a.smi_dir)
    except harness.NoDevice as e:
        sys.stderr.write(f"benchmark: {e}\n")
        return 2
    out = harness.result_line(cell, res, bool(a.trace), res["device"],
                              cell.chips)
    pl = harness.power_limit(0)
    ms = sorted(res["step_ms"])
    sys.stderr.write(
        f"benchmark: step ms median {ms[len(ms) // 2]:.3f} p95 "
        f"{harness.p95(ms):.3f} max {ms[-1]:.3f}; "
        f"{res['dof'] * res['nsteps'] / res['window_s']:.6e} DOF/s\n")
    sys.stderr.write(
        f"benchmark: {cell.name} seed {a.seed}: {res['nsteps']} steps in "
        f"{res['window_s']:.3f} s, set-up {res['setup_s']:.3f} s, check "
        f"{res['check_s']:.3f} s (samples {res['samples']}); card {pl}\n"
        f"benchmark: host over the window (rank 0): "
        f"{res['per_rank'][0].get('host')}\n"
        "benchmark: set-up parts (s) by rank: "
        f"{[_rounded(r['setup_parts']) for r in res['per_rank']]}\n")
    if a.trace:
        sys.stderr.write("benchmark: host syncs by site (rank 0): "
                         f"{res['per_rank'][0]['sync_sites']}\n")
    # The last look for JAX, once everything that runs in this process
    # (the check and the metric readers included) has run.
    bad = sorted(set(res.get("forbidden", []))
                 | set(harness.forbidden_modules()))
    if bad:
        sys.stderr.write("benchmark: modules of JAX or of the JAX package "
                         f"are loaded: {', '.join(bad)}\n")
        return 3
    print(json.dumps(out), flush=True)
    for line in harness.limit_lines(res):
        sys.stderr.write(line + "\n")
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
