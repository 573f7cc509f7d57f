"""Set-up time: process start to the first timed request or step, with
weights made, kernels built or loaded, warm-up and, for serving, the KV
pool and the sessions that open the window."""

LAYER = "Harness"
UNIT = "s"
SOURCE = "host_clock"
MOVES = {"": ""}


def read(run, name):
    return run.setup_s
