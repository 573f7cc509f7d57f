"""Readings that a cell's correctness limit is set from.

    python3 perfbench/calibrate.py --workload qwen2-1.5b.docqa --seconds 20 \
        --seeds 11 12 13 > readings.jsonl

For each seed, one run of the cell as the benchmark makes it (set-up, a
window of ``--seconds`` at the cell's own load, the check), and then the
control on the same prompts and served tokens: the plain reference at the
next lower precision than the configuration states (int4 for int8), the
gap of the token it puts first.  The control stands in the program's
place: ``checks`` hold its numbers against the limits and ``correct``
reads false where a limit separates it; ``readings`` hold the program's
numbers and the control's both.  With ``--fault`` the control is not
read; the run has that fault of ``core/faults.py`` planted under its timed
path, and its numbers are what the fault reads.  One JSON line per seed.
The limit lies above the program's readings over a dozen seeds and below
the control's and the faults' (``PERF.md`` gives them).  The benchmark's
runs never call this.
"""

import time

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault", default=None,
                    help="plant a fault of core/faults.py under the timed "
                         "path and read the numbers it gives")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from perfbench.core import run as R
    from perfbench.core.driver import run_cell
    from perfbench.core.faults import FAULTS
    bench = R.benchmark()
    wl = R.workload(bench, args.workload)
    for seed in args.seeds:
        t = time.perf_counter()
        out = run_cell(bench, wl, seed=seed, seconds=args.seconds,
                       trace=False, device="cuda", t_start=t,
                       control=args.fault is None,
                       sabotage=FAULTS[args.fault] if args.fault else None)
        print(json.dumps({"seed": seed, "fault": args.fault,
                          "correct": out["correct"],
                          "attempted": out["attempted"],
                          "failed": out["failed"],
                          "readings": out.get("readings"),
                          "checks": out["checks"],
                          "check_detail": out.get("check_detail"),
                          "metrics": out["metrics"],
                          "wall_s": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
