"""The train loop of the PyTorch port against the JAX reference, on the
reference's own mini config (``tests/test_substrate.py``'s ``_mini``:
qwen2 at 2 layers, d 64, vocab 256, 4 sequences of 32 tokens).

Two ``make_train_step`` steps from the same weights (the reference's
``api.init`` through ``convert.params_from_numpy``) and batch agree
within 2e-2, and each leaf's float32 master update within 10% of the
reference's (relative Frobenius error); a rejected step (a spike over the running median, or a
non-finite loss) leaves params, optimizer state and error state bit for
bit as they were; gradient accumulation over 2 micro-batches matches one
batch within 2e-2 (the reference's own bound); the ``Trainer``'s loss
falls, and a second ``Trainer`` resumes from its checkpoint and ends
bit for bit where an unbroken run ends.  In bp_exact
both packages give every dense weight an exactly-zero gradient
(ROADMAP Queue 3).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jax_get_arch
from repro.models import api as japi
from repro.train import optimizer as jopt
from repro.train.train_loop import TrainConfig as JaxTrainConfig
from repro.train.train_loop import make_train_step as jax_make_train_step
from repro_torch.configs.base import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.data.pipeline import DataConfig
from repro_torch.distributed import compression
from repro_torch.models import api
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.train_loop import TrainConfig, Trainer, make_train_step
from repro_torch.tree import leaf_paths, leaves, tree_map

MINI = dict(num_layers=2, d_model=64, d_ff=128, vocab_size=256, head_dim=16)
OPT = dict(peak_lr=1e-3, warmup_steps=2, total_steps=6)
#: relative Frobenius error of each leaf's float32 master update after two
#: steps against the reference's (a step that updated nothing gives 1; the
#: leaves measured 0.010-0.069)
UPDATE_RTOL = 0.1
#: the key bias's gradient is zero in exact arithmetic (it adds one
#: constant to every score of a query, which the softmax ignores), so
#: Adam's sign-like first steps follow each package's rounding noise
NOISE_ONLY = {"layers/attn/wk/b"}


def _cfgs(mode="bf16"):
    return (jax_get_arch("qwen2-1.5b").reduced().replace(matmul_mode=mode,
                                                         **MINI),
            get_arch("qwen2-1.5b").reduced().replace(matmul_mode=mode,
                                                     **MINI))


def _train_cfg(tmp_path="unused", **kw):
    return TrainConfig(total_steps=6, ckpt_every=3, ckpt_dir=str(tmp_path),
                       log_every=1, optimizer=opt_lib.OptimizerConfig(**OPT),
                       **kw)


@pytest.fixture(scope="module")
def jax_params():
    jcfg, _ = _cfgs()
    return jax.tree.map(np.asarray, jax.jit(
        lambda key: japi.init(key, jcfg))(jax.random.PRNGKey(0)))


def _tokens(seed=1):
    return np.random.default_rng(seed).integers(0, 256, (4, 32)).astype(
        np.int32)


def _snapshot(tree):
    return tree_map(lambda t: t.detach().clone(), tree)


def _bytes(t):
    t = t.detach()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy(
        ).tobytes()


def _by_path(tree):
    """A JAX (or numpy) tree as float32 numpy arrays keyed by leaf path."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(k, "key", k)) for k in path):
            np.asarray(v).astype(np.float32) for path, v in flat}


def _assert_bit_equal(a, b):
    for (path, x), y in zip(leaf_paths(a), leaves(b)):
        assert x.dtype == y.dtype and _bytes(x) == _bytes(y), path


def test_two_train_steps_match_reference(jax_params):
    jcfg, cfg = _cfgs()
    jstep = jax_make_train_step(jcfg, JaxTrainConfig(
        total_steps=6, optimizer=jopt.OptimizerConfig(**OPT)))
    step = make_train_step(cfg, _train_cfg())
    jp = jax.tree.map(jnp.asarray, jax_params)
    jo, je = jopt.init_state(jp), jnp.zeros((1,))
    params = params_from_numpy(jax_params, device="cpu")
    opt, err = opt_lib.init_state(params), torch.zeros(1)
    tokens = _tokens()
    for _ in range(2):
        jp, jo, je, jm = jstep(jp, jo, je, {"tokens": jnp.asarray(tokens)},
                               jnp.float32(0))
        params, opt, err, m = step(params, opt, err,
                                   {"tokens": torch.from_numpy(tokens)}, 0.0)
        assert float(m["committed"]) == float(jm["committed"]) == 1.0
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=2e-3)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=2e-2)
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
    want = _by_path(jp)
    for path, t in leaf_paths(params):
        np.testing.assert_allclose(t.detach().float().numpy(), want[path],
                                   atol=2e-2, rtol=2e-2, err_msg=path)
    assert int(opt["step"]) == 2
    # the bf16 params above cannot see two steps of ~1e-3; the float32
    # master weights' updates can: each leaf's update against the
    # reference's, by relative Frobenius error
    start, want = _by_path(jax_params), _by_path(jo["master"])
    errs = {}
    for path, t in leaf_paths(opt["master"]):
        if path in NOISE_ONLY:
            continue
        got, ref = t.numpy() - start[path], want[path] - start[path]
        errs[path] = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    worst = max(errs, key=errs.get)
    print(f"worst master-update leaf {worst}: {errs[worst]:.3g}")
    assert errs[worst] <= UPDATE_RTOL, (worst, errs[worst])


@pytest.mark.parametrize("cause", ["spike", "nan"])
@pytest.mark.parametrize("compress", [False, True],
                         ids=["plain", "compressed"])
def test_rejected_step_keeps_state_bit_identical(jax_params, cause,
                                                 compress):
    _, cfg = _cfgs()
    tc = _train_cfg(compress_grads=compress)
    step = make_train_step(cfg, tc)
    params = params_from_numpy(jax_params, device="cpu")
    if cause == "nan":
        params["final_norm"]["scale"][0] = float("nan")
    opt = opt_lib.init_state(params)
    err = (compression.init_error_state(params) if compress
           else torch.zeros(1))
    before = _snapshot({"params": params, "opt": opt, "err": err})
    median = 1e-9 if cause == "spike" else 0.0
    params, opt, err, m = step(params, opt, err,
                               {"tokens": torch.from_numpy(_tokens())},
                               median)
    assert float(m["committed"]) == 0.0
    assert np.isfinite(float(m["loss"])) == (cause == "spike")
    _assert_bit_equal(before, {"params": params, "opt": opt, "err": err})
    # the same step commits with no median yet (a spike needs one)
    if cause == "spike":
        params, opt, err, m = step(params, opt, err,
                                   {"tokens": torch.from_numpy(_tokens())},
                                   0.0)
        assert float(m["committed"]) == 1.0 and int(opt["step"]) == 1
        if compress:
            assert any(e.abs().sum() > 0 for e in leaves(err))


def test_grad_accum_matches_full_batch(jax_params):
    _, cfg = _cfgs()
    tokens = torch.from_numpy(_tokens())
    out = []
    for accum in (1, 2):
        params = params_from_numpy(jax_params, device="cpu")
        opt = opt_lib.init_state(params)
        step = make_train_step(cfg, _train_cfg(grad_accum=accum))
        params, _, _, m = step(params, opt, torch.zeros(1),
                               {"tokens": tokens}, 0.0)
        out.append((params, m))
    (p1, m1), (p2, m2) = out
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                               rtol=2e-2)
    for (path, a), b in zip(leaf_paths(p1), leaves(p2)):
        np.testing.assert_allclose(a.detach().float().numpy(),
                                   b.detach().float().numpy(), atol=2e-2,
                                   rtol=2e-2, err_msg=path)


def test_bp_exact_dense_weights_get_zero_gradient(jax_params):
    """The reference's STE gives the int8 weight a zero cotangent, and the
    float weight is quantized with ``round`` on every call: in bp_* modes
    no dense weight learns, in either package (ROADMAP Queue 3)."""
    jcfg, cfg = _cfgs("bp_exact")
    tokens = _tokens()
    jg = jax.jit(jax.grad(lambda p: japi.loss_fn(p, jcfg, {
        "tokens": jnp.asarray(tokens)})[0]))(jax.tree.map(jnp.asarray,
                                                          jax_params))
    params = params_from_numpy(jax_params, device="cpu")
    flat = leaves(params)
    for p in flat:
        p.requires_grad_(p.is_floating_point())
    loss, _ = api.loss_fn(params, cfg, {"tokens": torch.from_numpy(tokens)})
    grads = torch.autograd.grad(loss, flat, allow_unused=True,
                                materialize_grads=True)
    want = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(g)
            for path, g in jax.tree_util.tree_flatten_with_path(jg)[0]}
    dense = [(path, g) for (path, _), g in zip(leaf_paths(params), grads)
             if path.endswith("/w")]
    assert len(dense) == 7
    for path, g in dense:
        assert not g.any() and not np.any(want[path]), path
    assert grads[leaves(params).index(params["embed"]["table"])].any()


def test_trainer_loss_falls_and_resumes(tmp_path, jax_params):
    _, cfg = _cfgs()
    data = DataConfig(vocab_size=256, seq_len=32, global_batch=4)
    seen = []
    tc = _train_cfg(tmp_path, grad_accum=2)
    tr = Trainer(cfg, tc, data,
                 device="cpu", params=params_from_numpy(jax_params,
                                                        device="cpu"))
    end, hist = tr.run(on_metrics=lambda s, m: seen.append((s, m)))
    assert end == 6 and tr.ckpt.latest_step() == 6
    assert [s for s, _ in seen] == [1, 2, 3, 4, 5, 6]
    assert all(m["committed"] == 1.0 for _, m in seen)
    losses = [loss for _, loss in hist]
    assert losses[-1] < losses[0], losses
    # a second trainer resumes from step 6's checkpoint, bit for bit
    saved = _snapshot(tr._state_tree())
    tr2 = Trainer(cfg, dataclasses.replace(tc, total_steps=8), data,
                  device="cpu", init_seed=1)
    assert tr2.start_step == 6
    _assert_bit_equal(saved, tr2._state_tree())
    end2, hist2 = tr2.run()
    assert end2 == 8 and [s for s, _ in hist2] == [7, 8]
    assert tr2.ckpt.all_steps() == [3, 6, 8]     # keep 3
    # and the resumed run ends where an unbroken one does, bit for bit
    whole = Trainer(cfg, dataclasses.replace(
        tc, total_steps=8, ckpt_dir=str(tmp_path / "whole")), data,
        device="cpu", params=params_from_numpy(jax_params, device="cpu"))
    _, hist_whole = whole.run()
    assert [loss for _, loss in hist_whole] == losses + [
        loss for _, loss in hist2]
    _assert_bit_equal(whole._state_tree(), tr2._state_tree())
