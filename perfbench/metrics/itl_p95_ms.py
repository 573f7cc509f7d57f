"""95th percentile of every gap between consecutive output tokens of every
request due in the window."""

from perfbench.core.stats import percentile

LAYER = "Harness"
UNIT = "ms"
SOURCE = "host_clock"
MOVES = {"": ""}


def read(run, name):
    gaps = [b - a for r in run.requests if r["measured"]
            for a, b in zip(r["stamps"], r["stamps"][1:])]
    return 1e3 * percentile(gaps, 95) if gaps else None
