"""The GPipe pipeline of the PyTorch port
(``repro_torch.distributed.pipeline.pipeline_apply``) against the JAX
package, on meshes of ``cpu`` shards.

  * ``test_pipeline.py``'s tanh stages (S 4, B 8, D 16, 4 microbatches):
    the output against the reference's sequential stack and the gradient
    against ``jax.grad`` of it, within 1e-5 (the reference test's
    tolerance for its own pipeline).
  * Against the port's own sequential stack run one microbatch at a time,
    bit for bit; every (stage, microbatch) pair runs once and no inactive
    pair runs; the hand-offs counted as collective-permutes.
  * A nested-dict ``stage_params`` tree, a mesh with a second axis, and
    the refusal of a batch that does not split.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.distributed.pipeline import pipeline_apply
from repro_torch.launch import op_analysis
from repro_torch.launch.mesh import make_mesh

S, B, D = 4, 8, 16


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((S, D, D)) / np.sqrt(D)).astype(np.float32)
    x = rng.standard_normal((B, D)).astype(np.float32)
    return w, x


def _jax_sequential(w, x):
    h = x
    for s in range(S):
        h = jnp.tanh(h @ w[s])
    return h


def test_pipeline_matches_reference_stack_and_grad():
    w, x = _inputs()
    mesh = make_mesh((S,), ("model",), "cpu")
    wt = torch.tensor(w, requires_grad=True)
    got = pipeline_apply(lambda p, h: torch.tanh(h @ p), wt,
                         torch.tensor(x), mesh=mesh, n_microbatches=4)
    want = np.asarray(_jax_sequential(jnp.asarray(w), jnp.asarray(x)))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5,
                               rtol=1e-5)
    (got ** 2).sum().backward()
    g_ref = jax.grad(lambda w_: jnp.sum(_jax_sequential(
        w_, jnp.asarray(x)) ** 2))(jnp.asarray(w))
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(g_ref),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("n_micro", [1, 2, 4, 8])
def test_pipeline_equals_own_stack_per_microbatch(n_micro):
    w, x = _inputs(1)
    mesh = make_mesh((S,), ("model",), "cpu")
    calls = []

    def stage(p, h):
        calls.append(h.shape[0])
        return torch.tanh(h @ p)

    wt, xt = torch.tensor(w), torch.tensor(x)
    with op_analysis.OpAnalysis(mesh) as oa:
        got = pipeline_apply(stage, wt, xt, mesh=mesh,
                             n_microbatches=n_micro)
    mb = B // n_micro
    want = []
    for m in range(n_micro):
        h = xt[m * mb:(m + 1) * mb]
        for s in range(S):
            h = torch.tanh(h @ wt[s])
        want.append(h)
    assert torch.equal(got, torch.cat(want))
    assert calls == [mb] * (S * n_micro)
    res = oa.result()
    assert res["collective_counts"]["collective-permute"] == S * n_micro
    assert res["collective_bytes"]["collective-permute"] == \
        S * n_micro * mb * D * 4
    # each stage's shard runs every row through its one product
    assert res["dot_flops_per_device"] == 2.0 * B * D * D
    assert res["dot_flops_total"] == 2.0 * B * D * D * S


def test_pipeline_dict_params_and_two_axis_mesh():
    w, x = _inputs(2)
    mesh = make_mesh((2, S), ("data", "model"), "cpu")
    params = {"w": torch.tensor(w), "b": {"bias": torch.ones(S, D)}}

    def stage(p, h):
        return torch.tanh(h @ p["w"] + p["b"]["bias"])

    got = pipeline_apply(stage, params, torch.tensor(x), mesh=mesh,
                         axis_name="model", n_microbatches=2)
    h = torch.tensor(x)
    for s in range(S):
        h = torch.tanh(h @ params["w"][s] + params["b"]["bias"][s])
    torch.testing.assert_close(got, h, rtol=0, atol=0)
    with pytest.raises(ValueError, match="microbatches"):
        pipeline_apply(stage, params, torch.tensor(x), mesh=mesh,
                       n_microbatches=3)
