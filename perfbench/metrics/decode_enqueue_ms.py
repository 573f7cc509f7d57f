"""Mean host time to enqueue a decode step: the duration of the window's
``decode_forward`` spans under ``decode`` spans (the executor's forward and
sampling, up to the last launch before the loop's synchronizing read).
Against ``decode_step_ms`` it says how far the host paces the step."""

from perfbench.core.spans import under

LAYER = "Executor (serving/executor.py)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = {"itl": "itl_p95_ms"}


def read(run, name):
    durs = [s["dur"] for s, _ in under(run, "decode_forward", "decode")]
    if not durs:
        return None
    return sum(durs) / len(durs) / 1e3
