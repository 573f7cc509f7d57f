"""The training cell at a tiny size on the CPU: a whole run comes out
correct, and not correct with the step broken (state left unchanged, half
of the batch left out, the update doubled) or with the control in the
program's place."""

import pytest

from perfbench.core import faults, run as R
from perfbench.core.driver import run_cell
from perfbench.tests import tiny

NAME = "qwen2-1.5b.qat"
SEED = 2 ** 31 + 99


def _run(seed=SEED, trace=False, **kw):
    bench = tiny.bench()
    kw.setdefault("limits", tiny.LIMITS["train"])
    return run_cell(bench, R.workload(bench, NAME), seed=seed, seconds=2.0,
                    trace=trace, device="cpu", t_start=0.0,
                    config=tiny.config(True), mix=tiny.qat(), **kw)


def test_a_run_is_correct_and_reports_its_metrics():
    out = _run()
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0
    assert set(out["metrics"]) == {"train_tokens_per_s", "setup_s"}
    assert list(out["checks"]) == ["loss_gap", "grad_gap", "change_gap"]
    assert len(out["check_detail"]["step_loss_gaps"]) == 3


def test_a_traced_run_reports_the_step_metrics():
    out = _run(trace=True)
    assert "mfu.train" in out["metrics"]
    assert "idle_share.train" in out["metrics"]
    assert "peak_mem_gib.train" not in out["metrics"]   # no card


@pytest.mark.parametrize("fault", [faults.step_unchanged,
                                   faults.half_batch,
                                   faults.update_doubled])
def test_a_broken_step_is_not_correct(fault):
    out = _run(sabotage=fault)
    assert not out["correct"], out["checks"]


def test_the_control_is_not_correct():
    """The reference at int4 fake quantization, in the program's place,
    fails one of the numbers on three seeds."""
    lim = tiny.LIMITS["train"]
    for seed in (1, 2, 3):
        out = _run(seed=seed, control=True)
        assert not out["correct"], out["checks"]
        r = out["readings"]
        assert {k: c["value"] for k, c in out["checks"].items()} == \
            {k: r[f"control_{k}"] for k in lim}


def test_only_the_change_catches_a_doubled_update():
    """Twice the learning rate leaves the first step's loss and gradient
    as they are; the parameters' change after the check's steps reads
    about 1."""
    checks = _run(sabotage=faults.update_doubled)["checks"]
    lim = tiny.LIMITS["train"]
    assert checks["loss_gap"]["value"] <= lim["loss_gap"]["limit"]
    assert checks["grad_gap"]["value"] <= lim["grad_gap"]["limit"]
    assert 0.8 < checks["change_gap"]["value"] < 1.2
