"""Share of the traced window in which no operation ran on the device:
1 - busy / window, busy the union of the device events of the profiler's
raw trace."""

LAYER = "Device (H100)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = {"itl": "itl_p95_ms", "tput": "output_tokens_per_s",
         "train": "train_tokens_per_s"}


def read(run, name):
    tr = run.trace
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
