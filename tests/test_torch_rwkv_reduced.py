"""The RWKV-6 family of the PyTorch port against the JAX reference, on
``rwkv6-7b``'s ``reduced()`` config (4 layers, d 128, 4 WKV heads of 32):
prefill logits, WKV state and token-shift carries, then one decode step's,
in bf16, bp_exact and bp_approx, at prompt lengths 6 (the step recurrence)
and 64 and 128 (the chunked form).  The checks and their tolerances, with
the reasons for them, are ``test_torch_rwkv.py``'s.
"""

import jax
import pytest

from repro.models import api as japi
from test_torch_rwkv import MODES, _cfgs, check_prefill_and_decode


@pytest.fixture(scope="module")
def jax_params():
    return japi.init(jax.random.PRNGKey(0), _cfgs("reduced")[0])


@pytest.mark.parametrize("S", [6, 64, 128])
@pytest.mark.parametrize("mode", MODES)
def test_prefill_and_decode_match_op_by_op(jax_params, mode, S):
    check_prefill_and_decode(jax_params, "reduced", mode, S)
