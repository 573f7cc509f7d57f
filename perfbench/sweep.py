"""Find an open-loop cell's knee: the highest arrival rate the program
sustains without a growing backlog.

    python3 perfbench/sweep.py --workload qwen2-1.5b.docqa --seed 1 \
        --seconds 40 --rates 1.0 1.5 2.0 3.0 > sweep.jsonl

One set-up, then one window per rate on a fresh pool, each with the cell's
traffic at that rate.  Per rate it prints one JSON line: the requests due
and finished, TTFT percentiles over the window and over its first and last
quarter of due times, the ITL p95, and the most requests due but not yet
given a first token at any due time (the backlog).  A rate whose last
quarter waits far longer than its first is past the knee.  The cell's
traffic file then takes 0.8 of the knee as its fixed rate.  The benchmark's
runs never call this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from perfbench.core import run as R
    from perfbench.core.serve import ServeCell
    from perfbench.core.stats import percentile
    bench = R.benchmark()
    wl = R.workload(bench, args.workload)
    config = R.config_file(bench, wl["config"])
    mix = R.traffic_file(wl["traffic"])
    cell = ServeCell(wl["name"], config, mix, seed=args.seed,
                     seconds=args.seconds, trace=False, device="cuda",
                     t_start=T_START)
    cell.setup()
    print(json.dumps({"setup_s": time.perf_counter() - T_START,
                      "num_blocks": cell.num_blocks}), flush=True)
    for i, rate in enumerate(args.rates):
        if i:
            cell.new_loop()
        cell.mix = dict(mix, rate_per_s=rate)
        t = time.perf_counter()
        data = cell.run()
        reqs = [r for r in data.requests if r["measured"]]
        ttft = [r["stamps"][0] - r["due"] if r["stamps"] else None
                for r in reqs]
        firsts = sorted(r["stamps"][0] for r in reqs if r["stamps"])
        dues = sorted(r["due"] for r in reqs)
        backlog = max((sum(1 for d in dues if d <= t0)
                       - sum(1 for f in firsts if f <= t0)) for t0 in dues)
        q = max(len(reqs) // 4, 1)
        gaps = [b - a for r in reqs for a, b in zip(r["stamps"],
                                                    r["stamps"][1:])]
        print(json.dumps({
            "rate_per_s": rate, "due": len(reqs),
            "finished": sum(1 for r in reqs if r["state"] == "done"),
            "ttft_p50_s": percentile(ttft, 50),
            "ttft_p90_s": percentile(ttft, 90),
            "ttft_first_quarter_p50_s": percentile(ttft[:q], 50),
            "ttft_last_quarter_p50_s": percentile(ttft[-q:], 50),
            "itl_p95_s": percentile(gaps, 95) if gaps else None,
            "max_backlog": backlog,
            "wall_s": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
