"""One run of one cell: set-up, the window, the metrics, the check, and the
result line's object."""

from __future__ import annotations

import collections
import subprocess
import sys
from typing import Callable, Optional

from perfbench.core import run as R
from perfbench.core.stats import percentile


def run_cell(bench: dict, wl: dict, *, seed: int, seconds: float,
             trace: bool, device: str, t_start: float,
             config: Optional[dict] = None, mix: Optional[dict] = None,
             limits: Optional[dict] = None,
             sabotage: Optional[Callable] = None,
             control: bool = False) -> dict:
    """The result object of one run.  ``config``, ``mix`` and ``limits``
    replace the cell's files (the CPU tests run tiny copies);
    ``sabotage(cell)`` breaks the timed path before the first step it
    drives (the tests that see a broken program come out not correct).
    ``control`` puts the control (the reference at the next lower
    precision) in the program's place: its numbers are the ones held
    against the limits, so a sound limit reads it not correct, and
    ``readings`` keeps the program's and the control's numbers both, for
    setting the limits; the benchmark's runs never do."""
    config = config or R.config_file(bench, wl["config"])
    mix = mix or R.traffic_file(wl["traffic"])
    limits = limits or R.limits_file(wl["name"])
    if R.generator(mix["kind"]).HARNESS == "train":
        from perfbench.core.train import TrainCell as Cell
    else:
        from perfbench.core.serve import ServeCell as Cell
    cell = Cell(wl["name"], config, mix, seed=seed, seconds=seconds,
                trace=trace, device=device, t_start=t_start)
    cell.setup(sabotage)
    data = cell.run()
    metrics = R.read_metrics(bench, data, trace)
    attempted, failed = counts(data)
    cell.release()
    readings = cell.check(data, control)
    held = ({k: readings[f"control_{k}"] for k in limits} if control
            else readings)
    checks = {k: {"value": held[k], "limit": limits[k]["limit"]}
              for k in limits}
    correct = (attempted > 0 and failed == 0 and readings["sampled"] > 0
               and all(c["value"] <= c["limit"] for c in checks.values()))
    dev = {"platform": "gpu" if device != "cpu" else "cpu",
           "kind": device_name(device), "count": 1,
           "memory_peak_bytes": data.memory_peak_bytes}
    out = {"correct": bool(correct), "attempted": attempted,
           "failed": failed, "metrics": metrics, "device": dev}
    if trace and data.trace is not None:
        dev["busy_s"] = data.trace["busy_s"]
        dev["window_s"] = data.trace["window_s"]
        out["breakdown"] = {"device_ops": data.trace["device_ops"],
                            "idle_gaps": data.trace["idle_gaps"]}
    out["card"] = {"power_limit_w": power_limit(device)}
    if control:
        out["readings"] = readings
    if getattr(cell, "detail", None):
        out["check_detail"] = cell.detail
    if data.kind == "serve":
        out["requests"] = served(data)
    out["checks"] = checks
    return out


def counts(data: R.RunData):
    """(attempted, failed): serving counts the window's requests (open
    loop: those due in it; closed loop: those live in it), a request that
    failed or never finished counting as failed; training counts steps."""
    if data.kind == "train":
        n = sum(1 for t, _ in data.steps if data.t0 <= t < data.t1)
        return n, 0
    if R.generator(data.mix["kind"]).HARNESS == "serve_open":
        live = [r for r in data.requests if r["measured"]]
        bad = [r for r in live if r["reason"] in R.MISSING
               or r["state"] not in ("done",)]
        return len(live), len(bad)
    live = [r for r in data.requests
            if any(data.t0 <= t < data.t1 for t in r["stamps"])]
    bad = [r for r in live if r["reason"] in R.MISSING[:3]]
    return len(live), len(bad)


def served(data: R.RunData) -> dict:
    """How the window's requests ended, and for an open loop how long
    after the window's close its last request's last token came and the
    TTFT p90 (reported, not bounded: it spreads too widely for a bound)."""
    live = [r for r in data.requests if r["measured"]]
    ends = collections.Counter(str(r["reason"]) for r in live)
    out = {"finish": dict(sorted(ends.items()))}
    if R.generator(data.mix["kind"]).HARNESS == "serve_open":
        last = [r["stamps"][-1] for r in live if r["stamps"]]
        out["drain_s"] = max(last) - data.t1 if last else None
        ttft = R.ttft_samples(data)
        out["ttft_p90_ms"] = 1e3 * percentile(ttft, 90) if ttft else None
    return out


def device_name(device: str) -> str:
    if device == "cpu":
        return "cpu"
    import torch
    return torch.cuda.get_device_name(0)


def power_limit(device: str):
    if device == "cpu":
        return None
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def print_checks(checks: dict, stream=sys.stderr) -> None:
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=stream)
