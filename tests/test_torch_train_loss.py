"""The families' training losses in the PyTorch port against the JAX
reference: ``api.loss_fn`` and its gradients on one ``reduced()`` config
per family (dense, MoE, RWKV-6, the VLM with its vision splice and M-RoPE
positions, the Mamba-2 hybrid, the encoder-decoder), on the same weights
(the reference's ``api.init``, jitted, through
``convert.params_from_numpy``) and the same numpy batch.

The reference's loss and gradients are one ``jax.jit`` of
``value_and_grad``, compiled with ``xla_allow_excess_precision`` off, so
that every bf16 intermediate is rounded as PyTorch's eager operations
round it.  The loss agrees within 1e-2 and every gradient leaf within a
relative Frobenius error of 5e-2 (the worst leaf is printed).
Checkpointing each layer (``remat``) changes no gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jax_get_arch
from repro.models import api as japi
from repro_torch.configs.base import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.models import api, remat
from repro_torch.tree import leaf_paths

B, S = 2, 64
NAMES = ["qwen2-1.5b", "granite-moe-1b-a400m", "rwkv6-7b", "qwen2-vl-7b",
         "zamba2-2.7b", "seamless-m4t-medium"]


def _batch(cfg, seed=1):
    """(reference batch, port batch) from one numpy draw."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(2, cfg.vocab_size, (B, S)).astype(np.int32)
    arrays = {"tokens": tokens, "loss_mask": rng.random((B, S)) > 0.1}
    if cfg.family == "vlm":
        mask = np.zeros((B, S), bool)
        mask[:, 2:18] = True
        pos = np.broadcast_to(np.arange(S, dtype=np.int32), (3, B, S)).copy()
        pos[1, :, 2:18] = 2 + np.arange(16) // 4     # a 4 x 4 patch grid
        pos[2, :, 2:18] = 2 + np.arange(16) % 4
        arrays.update(vision_mask=mask, positions=pos,
                      vision_embeds=(rng.standard_normal(
                          (B, S, cfg.d_model)) * 0.02).astype(np.float32))
    if cfg.family == "audio":
        arrays["src_embeds"] = rng.standard_normal(
            (B, 32, cfg.d_model)).astype(np.float32)
    jb = {k: jnp.asarray(v) for k, v in arrays.items()}
    tb = {k: torch.from_numpy(v) for k, v in arrays.items()}
    tb["tokens"] = tb["tokens"].long()
    tb["positions"] = tb["positions"].long() if "positions" in tb else None
    if tb["positions"] is None:
        del tb["positions"]
    if cfg.family == "vlm":
        jb["vision_embeds"] = jb["vision_embeds"].astype(jnp.bfloat16)
        tb["vision_embeds"] = tb["vision_embeds"].to(torch.bfloat16)
    return jb, tb


def _port_grads(params, cfg, batch, remat_on=True):
    paths = [(k, p) for k, p in leaf_paths(params) if p.is_floating_point()]
    for _, p in paths:
        p.requires_grad_(True)
    loss, metrics = api.loss_fn(params, cfg, batch, remat=remat_on)
    grads = torch.autograd.grad(loss, [p for _, p in paths],
                                allow_unused=True, materialize_grads=True)
    return loss.detach(), metrics, {k: g.float().numpy() for (k, _), g in
                                    zip(paths, grads)}


def _reference(name):
    jcfg = jax_get_arch(name).reduced()
    jp = jax.jit(lambda key: japi.init(key, jcfg))(jax.random.PRNGKey(0))
    jb, tb = _batch(jcfg)
    f = jax.jit(jax.value_and_grad(lambda p: japi.loss_fn(p, jcfg, jb),
                                   has_aux=True))
    (loss, _), grads = f.lower(jp).compile(
        compiler_options={"xla_allow_excess_precision": False})(jp)
    flat = jax.tree_util.tree_flatten_with_path(grads)[0]
    grads = {"/".join(str(getattr(k, "key", k)) for k in path):
             np.asarray(g).astype(np.float32) for path, g in flat}
    return float(loss), grads, jax.tree.map(np.asarray, jp), tb


@pytest.mark.parametrize("name", NAMES)
def test_loss_and_grads_match_reference(name):
    cfg = get_arch(name).reduced()
    want_loss, want, jp, tb = _reference(name)
    params = params_from_numpy(jp, device="cpu")
    loss, metrics, got = _port_grads(params, cfg, tb)
    assert abs(float(loss) - want_loss) <= 1e-2, (float(loss), want_loss)
    assert float(metrics["ce_loss"]) > 0.5 * np.log(cfg.vocab_size)
    assert set(got) == set(want)
    errs = {}
    for k, g in got.items():
        den = np.linalg.norm(want[k])
        errs[k] = (np.linalg.norm(g - want[k]) / den if den > 0
                   else np.linalg.norm(g))
    worst = max(errs, key=errs.get)
    print(f"{name}: loss {float(loss):.5f} vs {want_loss:.5f}, "
          f"worst leaf {worst} {errs[worst]:.4f}")
    assert errs[worst] <= 5e-2, (worst, errs[worst])


@pytest.mark.parametrize("name", NAMES)
def test_layer_checkpointing_changes_no_gradient(name):
    cfg = get_arch(name).reduced()
    params = api.init(cfg, seed=0, device="cpu")
    _, tb = _batch(jax_get_arch(name).reduced())
    remat.reset_runs()
    loss_on, _, on = _port_grads(params, cfg, tb, remat_on=True)
    runs = remat.RUNS["body"]
    loss_off, _, off = _port_grads(params, cfg, tb, remat_on=False)
    assert remat.RUNS["body"] == runs
    # each checkpointed body ran twice: its forward and its recomputation
    bodies = {"hybrid": cfg.num_layers // max(cfg.attn_every, 1),
              "audio": cfg.num_layers + cfg.encoder_layers}
    assert runs == 2 * bodies.get(cfg.family, cfg.num_layers)
    assert float(loss_on) == float(loss_off)
    for k in on:
        np.testing.assert_array_equal(on[k], off[k], err_msg=k)
