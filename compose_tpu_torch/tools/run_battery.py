"""Run the regression battery (compose_tpu_torch.battery.ROWS) on the port
and write a per-row result manifest: row -> measured l2/cv/cv_gll/min/max
and pass/fail per assert, in tools/run_battery.py's format.

Incremental and resumable: rows already in the output JSON without an
error are skipped, and the file is rewritten after every row, so the
runner can be stopped and restarted freely. A row that raises is recorded
with its error. The exit code is 1 if any selected row failed or raised.

    python -m compose_tpu_torch.tools.run_battery [out.json] [row_id ...]
        [--device cpu]
"""

import argparse
import json
import os
import sys
import time
import traceback

from .. import battery


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out", nargs="?", default="BATTERY_torch.json")
    ap.add_argument("rows", nargs="*", help="only these row ids")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    only = set(a.rows)
    results = {}
    if os.path.exists(a.out):
        with open(a.out) as f:
            results = json.load(f).get("rows", {})
    rows = battery.ROWS
    for row_id, ref, _, _ in rows:
        if only and row_id not in only:
            continue
        if row_id in results and "error" not in results[row_id]:
            continue
        t0 = time.perf_counter()
        try:
            out, checks, ok = battery.run_row(row_id, a.device)
            rec = {
                "ref": ref,
                "measured": {"l2": out.l2_err, "cv": out.cv,
                             "cv_gll": out.cv_gll, "min": out.min_e,
                             "max": out.max_e},
                "checks": {k: {"value": v[0], "golden": v[1], "pass": v[2]}
                           for k, v in checks.items()},
                "pass": ok,
                "sec": round(time.perf_counter() - t0, 1),
            }
        except Exception as e:  # noqa: BLE001 - record and continue
            rec = {"ref": ref, "error": repr(e)[:500], "pass": False,
                   "sec": round(time.perf_counter() - t0, 1)}
            traceback.print_exc()
        results[row_id] = rec
        npass = sum(1 for r in results.values() if r.get("pass"))
        doc = {"n_rows": len(rows), "n_run": len(results), "n_pass": npass,
               "rows": results}
        with open(a.out + ".tmp", "w") as f:
            json.dump(doc, f, indent=1)
        os.replace(a.out + ".tmp", a.out)
        print(f"{row_id}: pass={rec['pass']} ({rec['sec']}s) "
              f"[{npass}/{len(results)} of {len(rows)}]", flush=True)
    bad = [r for r, rec in results.items()
           if (not only or r in only) and not rec.get("pass")]
    print("done" + (f"; failed: {' '.join(bad)}" if bad else ""))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
