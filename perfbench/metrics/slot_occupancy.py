"""Mean share of the decode batch's slots that hold a request (decode step
records' ``active_slots / n_slots``) in the window."""

LAYER = "Scheduler (serving/scheduler.py)"
UNIT = "%"
SOURCE = "program_counter"
MOVES = {"tput": "output_tokens_per_s"}


def read(run, name):
    recs = [r for r in run.records if r["kind"] == "decode"]
    if not recs:
        return None
    return 100.0 * sum(r["active_slots"] / r["n_slots"]
                       for r in recs) / len(recs)
