"""Executor prefill time per thousand prompt tokens: the prefill step
records' ``phases.dispatch_s`` (the executor call up to its synchronizing
read) over the prompt tokens they prefilled, in the window."""

LAYER = "Executor (serving/executor.py)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = {"itl": "itl_p95_ms"}


def read(run, name):
    recs = [r for r in run.records if r["kind"] == "prefill"]
    tokens = sum(r["prompt_tokens"] for r in recs)
    if not tokens:
        return None
    return 1e6 * sum(r["phases"]["dispatch_s"] for r in recs) / tokens
