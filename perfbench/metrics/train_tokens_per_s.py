"""The tokens of every optimizer step finished in the window, over the
time from the window's start to the end of the last of them (a step that
the window's end cuts is neither counted nor timed, so the rate does not
move in whole steps)."""

LAYER = "Harness"
UNIT = "tokens/s"
SOURCE = "host_clock"
MOVES = {"": ""}


def read(run, name):
    done = [(t, n) for t, n in run.steps if run.t0 <= t < run.t1]
    if not done:
        return None
    return sum(n for _, n in done) / (max(t for t, _ in done) - run.t0)
