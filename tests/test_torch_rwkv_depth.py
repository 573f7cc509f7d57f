"""How far the RWKV-6 family amplifies a float32 reordering, in the JAX
reference and in the port: the same function evaluated by its two WKV
routes, the chunked form (a prefill of S = 64 tokens) and the step
recurrence (a prefill of the first S - 1 tokens, then one decode step of
the last), gives last-token logits that part by a gap that grows with depth
and width in bp_exact, in both packages alike.

``chip_smoke.py``'s ``serve_rwkv`` measures the same gap on full-width
rwkv6-7b in the port and takes it as the near-tie margin of its token
comparisons.  This test is the reference's side of that margin: at
rwkv6-7b's depth of 32 layers (narrower, so that it runs on a CPU) the
reference parts by as much as the port, so the port is no more sensitive
than the model it ports.  Tolerance: the port's gap within twice the
reference's, plus 2^-6 for depths where both are about 0 (seen: the
port's gap 0.72-0.97 of the reference's at the sizes run here).  ``pytest -s`` prints both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jax_get_arch
from repro.models import api as japi
from repro.models import layers as jlayers
from repro_torch.configs.base import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.models import api

S = 64


def _cfgs(num_layers, d_model):
    # rwkv6-7b's head size and d_ff / d_model ratio (14336 / 4096)
    kw = dict(num_layers=num_layers, d_model=d_model,
              d_ff=7 * d_model // 2, vocab_size=512,
              rwkv_head_dim=64, num_heads=d_model // 64,
              matmul_mode="bp_exact")
    return (jax_get_arch("rwkv6-7b").reduced().replace(**kw),
            get_arch("rwkv6-7b").reduced().replace(**kw))


def _jax_gap(jp, cfg, toks):
    prefill = jax.jit(lambda p, t: japi.prefill(p, cfg, {"tokens": t},
                                                S + 4))
    decode = jax.jit(lambda p, t, c: japi.decode_step(
        p, cfg, {"tokens": t, "cache": c, "cache_len": jnp.int32(S - 1)}))
    chunked, _ = prefill(jp, jnp.asarray(toks))
    _, cache = prefill(jp, jnp.asarray(toks[:, :-1]))
    step, _ = decode(jp, jnp.asarray(toks[:, -1:]), cache)
    return float(np.abs(np.asarray(chunked, np.float32)
                        - np.asarray(step, np.float32)).max())


def _port_gap(tp, cfg, toks):
    t = torch.from_numpy(toks).long()
    with torch.no_grad():
        chunked, _ = api.prefill(tp, cfg, {"tokens": t}, S + 4)
        _, cache = api.prefill(tp, cfg, {"tokens": t[:, :-1]}, S + 4)
        step, _ = api.decode_step(tp, cfg, {"tokens": t[:, -1:],
                                            "cache": cache,
                                            "cache_len": S - 1})
    return (chunked.float() - step.float()).abs().max().item()


@pytest.mark.parametrize("num_layers,d_model", [(8, 256), (32, 256),
                                                (32, 512)])
def test_route_gap_of_the_port_matches_the_reference(num_layers, d_model):
    jcfg, tcfg = _cfgs(num_layers, d_model)
    jp = jlayers.quantize_dense_params(japi.init(jax.random.PRNGKey(0),
                                                 jcfg))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    toks = np.random.default_rng(1).integers(
        2, jcfg.vocab_size, (4, S)).astype(np.int32)
    ref, port = _jax_gap(jp, jcfg, toks), _port_gap(tp, tcfg, toks)
    print(f"\n{num_layers} layers, d {d_model}: chunked-vs-step logit gap "
          f"reference {ref:.4f}, port {port:.4f}")
    assert np.isfinite(ref) and np.isfinite(port)
    assert port <= 2 * ref + 2.0 ** -6, (port, ref)
