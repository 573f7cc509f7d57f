"""Serving cells at a tiny size on the CPU, with the timed path broken or
the control in the program's place: each run comes out not correct."""

import pytest

from perfbench.core import faults
from perfbench.tests import tiny
from perfbench.tests.test_perfbench_serve import CELLS, _run


@pytest.mark.parametrize("fault", [faults.alter_tokens,
                                   faults.kv_unchanged])
@pytest.mark.parametrize("name", sorted(CELLS))
def test_a_broken_timed_path_is_not_correct(name, fault):
    out = _run(name, sabotage=fault)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("name", sorted(CELLS))
def test_the_control_is_not_correct(name):
    """The reference at int4, in the program's place: the gap of the
    token it puts first lies beyond the limit on three seeds."""
    limit = tiny.LIMITS["serve"]["max_logit_gap"]["limit"]
    for seed in (1, 2, 3):
        out = _run(name, seed=seed, control=True)
        assert not out["correct"], out["checks"]
        assert out["checks"]["max_logit_gap"]["value"] == \
            out["readings"]["control_max_logit_gap"] > limit
