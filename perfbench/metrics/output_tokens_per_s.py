"""Every token generated in the window, over the window (the engine's token
stamps, all requests, all clients)."""

from perfbench.core.stats import window_rate

LAYER = "Harness"
UNIT = "tokens/s"
SOURCE = "host_clock"
MOVES = {"": ""}


def read(run, name):
    stamps = [t for r in run.requests for t in r["stamps"]]
    return window_rate(stamps, run.t0, run.t1)
