"""Mean wall time of a decode step (the decode step records' ``wall_s``:
prepare, dispatch and commit) in the window."""

LAYER = "Serve loop (serving/engine.py ServeLoop)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = {"itl": "itl_p95_ms"}


def read(run, name):
    recs = [r for r in run.records if r["kind"] == "decode"]
    if not recs:
        return None
    return 1e3 * sum(r["wall_s"] for r in recs) / len(recs)
