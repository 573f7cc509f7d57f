"""Serving cells at a tiny size on the CPU: a whole run (set-up, window,
metrics, the reference check) comes out correct, and comes out not
correct with the timed path broken or with the control in the program's
place.  The harness's look for a card is skipped: ``run_cell`` is called
on the CPU directly."""

import pytest

from perfbench.core import run as R
from perfbench.core.driver import run_cell
from perfbench.tests import tiny

SEED = 2 ** 31 + 77
CELLS = {"qwen2-1.5b.docqa": (True, tiny.docqa),
         "qwen2-7b.chat": (False, tiny.chat)}


def _run(name, seed=SEED, trace=False, **kw):
    bench = tiny.bench()
    tied, mix = CELLS[name]
    kw.setdefault("limits", tiny.LIMITS["serve"])
    return run_cell(bench, R.workload(bench, name), seed=seed, seconds=1.0,
                    trace=trace, device="cpu", t_start=0.0,
                    config=tiny.config(tied), mix=mix(), **kw)


@pytest.mark.parametrize("name", sorted(CELLS))
def test_a_run_is_correct_and_reports_its_metrics(name):
    out = _run(name)
    assert out["correct"], out
    assert out["attempted"] > 0 and out["failed"] == 0
    bench = tiny.bench()
    want = {m["name"] for m in R.cell_metrics(bench, name, False)}
    assert set(out["metrics"]) == want
    assert list(out)[-1] == "checks"
    assert out["checks"]["max_logit_gap"]["value"] < \
        out["checks"]["max_logit_gap"]["limit"]


def test_a_traced_run_reports_the_step_metrics():
    out = _run("qwen2-7b.chat", trace=True)
    assert out["correct"]
    for key in ("slot_occupancy.tput", "mfu.tput", "idle_share.tput"):
        assert key in out["metrics"], out["metrics"]
    # the device's readers find nothing to read on the CPU
    assert "k1_roofline.tput" not in out["metrics"]
    assert out["device"]["window_s"] > 0
    if "prefix_hit_share.tput" in out["metrics"]:      # admissions in it
        assert 0 <= out["metrics"]["prefix_hit_share.tput"]["value"] <= 100


def test_prefix_hit_share_reads_the_block_insert_spans():
    run = R.RunData(cell="c", kind="serve", config={}, mix={}, work=None,
                    t0=0.0, t1=1.0, setup_s=0.0)
    assert R.reader("prefix_hit_share").read(run, "x") is None
    run.spans = [{"name": "block_insert", "args": {"prefix_hits": 3,
                                                   "n_blocks": 1}},
                 {"name": "block_insert", "args": {"prefix_hits": 0,
                                                   "n_blocks": 4}},
                 {"name": "decode", "args": {}}]
    assert R.reader("prefix_hit_share").read(run, "x") == 100.0 * 3 / 8
