"""The training substrate of the PyTorch port against the JAX reference:
AdamW (schedule, three updates, decay flags, clipping), the data
pipeline, checkpoints (in both directions, bit for bit), gradient
compression with error feedback, and the runtime guards.

Inputs are made with numpy from fixed seeds and handed to both packages.
float32 results agree within 1e-6; batches and checkpoints are compared
bit for bit.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import CheckpointManager as JaxCkpt
from repro.data import pipeline as jdata
from repro.distributed import compression as jcomp
from repro.runtime import fault_tolerance as jft
from repro.train import optimizer as jopt
from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.data import pipeline as tdata
from repro_torch.distributed import compression as tcomp
from repro_torch.runtime import fault_tolerance as tft
from repro_torch.train import optimizer as topt
from repro_torch.tree import leaf_paths, tree_map

TOL = dict(rtol=1e-6, atol=1e-6)


def _np(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.detach().numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


def _flat_jax(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in flat}


def _tree(seed):
    """A small params-shaped float32 tree whose paths hit every decay
    rule: paths naming norm / scale / bias / ln / ``_b`` do not decay, the
    rest do."""
    rng = np.random.default_rng(seed)
    shapes = {"layers": {"attn": {"wq": {"w": (3, 8, 8), "b": (3, 8)}},
                         "attn_norm": {"scale": (3, 8)},
                         "ln1": {"bias": (3, 8)}},
              "embed": {"table": (16, 8)}, "conv_b": (4,),
              "final_norm": {"scale": (8,)}}
    return tree_map(lambda s: rng.standard_normal(s).astype(np.float32),
                    shapes)


def test_lr_schedule_matches_reference():
    cfg = dict(peak_lr=1.0, warmup_steps=10, total_steps=100,
               min_lr_ratio=0.1)
    for s in (0, 1, 5, 10, 11, 55, 99, 100, 150):
        got = float(topt.lr_schedule(topt.OptimizerConfig(**cfg), s))
        want = float(jopt.lr_schedule(jopt.OptimizerConfig(**cfg),
                                      jnp.int32(s)))
        assert abs(got - want) <= 1e-6 * max(1.0, abs(want)), (s, got, want)


@pytest.mark.parametrize("grad_scale", [1.0, 1e6], ids=["plain", "clipped"])
def test_three_adamw_steps_match_reference(grad_scale):
    ocfg = dict(peak_lr=1e-2, warmup_steps=1, total_steps=10,
                weight_decay=0.1, clip_norm=1.0)
    params = _tree(0)
    jp = tree_map(jnp.asarray, params)
    tp = tree_map(lambda a: torch.from_numpy(a.copy()), params)
    js, ts = jopt.init_state(jp), topt.init_state(tp)
    for i in range(3):
        g = tree_map(lambda a: a * grad_scale, _tree(10 + i))
        jp, js, jm = jopt.apply_updates(jopt.OptimizerConfig(**ocfg), jp, js,
                                        tree_map(jnp.asarray, g))
        tp, ts, tm = topt.apply_updates(topt.OptimizerConfig(**ocfg), tp, ts,
                                        tree_map(torch.from_numpy, g))
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
    assert int(ts["step"]) == int(js["step"]) == 3
    for part, jtree, ttree in (("params", jp, tp), ("m", js["m"], ts["m"]),
                               ("v", js["v"], ts["v"]),
                               ("master", js["master"], ts["master"])):
        want = _flat_jax(jtree)
        for path, t in leaf_paths(ttree):
            np.testing.assert_allclose(_np(t), np.asarray(want[path]),
                                       err_msg=f"{part}/{path}", **TOL)
    # the decay flags, per path, equal the reference's
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    want_flags = {"/".join(str(getattr(k, "key", k)) for k in path):
                  jopt._decay_mask(path) for path, _ in flat}
    got_flags = {path: topt._decay_mask(path) for path, _ in leaf_paths(tp)}
    assert got_flags == want_flags
    # (no substring names a dense layer's bias "b": it decays)
    assert sorted(k for k, v in got_flags.items() if v) == [
        "embed/table", "layers/attn/wq/b", "layers/attn/wq/w"]


def test_clipping_reports_the_norm_before_the_clip():
    cfg = topt.OptimizerConfig(peak_lr=1e-3, warmup_steps=0,
                               total_steps=10, clip_norm=1.0)
    params = {"w": torch.zeros(4)}
    state = topt.init_state(params)
    _, _, m = topt.apply_updates(cfg, params, state,
                                 {"w": torch.full((4,), 1e9)})
    assert float(m["grad_norm"]) > 1e8
    # Adam's first step is scale-free: each weight moves by lr (nothing
    # from decay: the weights are zero)
    np.testing.assert_allclose(params["w"].numpy(), -float(m["lr"]),
                               rtol=1e-6)


@pytest.mark.parametrize("kw", [
    dict(vocab_size=128, seq_len=32, global_batch=4),
    dict(vocab_size=100, seq_len=64, global_batch=2, pad_fraction=0.2,
         seed=7),
    dict(vocab_size=151936, seq_len=1024, global_batch=2),
    dict(vocab_size=128, seq_len=16, global_batch=8, num_hosts=2,
         host_id=1)], ids=["small", "pad", "qwen2", "host1"])
def test_make_batch_is_bit_identical(kw):
    for step in (0, 3, 1000):
        got = tdata.make_batch(tdata.DataConfig(**kw), step)
        want = jdata.make_batch(jdata.DataConfig(**kw), step)
        assert set(got) == set(want) == {"tokens", "loss_mask"}
        for k in got:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_prefetcher_resumes_from_step():
    cfg = tdata.DataConfig(vocab_size=64, seq_len=8, global_batch=2)
    loader = tdata.PrefetchingLoader(cfg, start_step=5)
    try:
        got = [next(loader) for _ in range(3)]
    finally:
        loader.close()
    for i, b in enumerate(got):
        np.testing.assert_array_equal(
            b["tokens"], jdata.make_batch(jdata.DataConfig(
                vocab_size=64, seq_len=8, global_batch=2), 5 + i)["tokens"])
    assert loader.stats()["consumed"] == 3


def _state_arrays(seed):
    """A train-state-shaped tree of numpy arrays: bf16 params, float32
    optimizer leaves, an int32 scalar step, a bool leaf."""
    rng = np.random.default_rng(seed)
    bf16 = jnp.asarray(rng.standard_normal((3, 5)), jnp.bfloat16)
    return {"params": {"w": np.asarray(bf16),
                       "norm": {"scale": rng.random(5).astype(np.float32)}},
            "opt": {"step": np.asarray(7, np.int32),
                    "m": {"w": rng.standard_normal((3, 5)).astype(
                        np.float32)}},
            "mask": rng.random(4) > 0.5,
            "err": np.zeros((1,), np.float32)}


def _to_torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(
        a.view(np.int16), copy=True)).view(torch.bfloat16)
        if a.dtype.name == "bfloat16" else torch.from_numpy(np.array(a)),
        tree)


def test_checkpoints_cross_load_bit_for_bit(tmp_path):
    arrays = _state_arrays(0)
    # the reference writes, the port restores
    JaxCkpt(str(tmp_path / "ref"), async_save=False).save(
        3, jax.tree.map(jnp.asarray, arrays))
    like = tree_map(torch.zeros_like, _to_torch(arrays))
    got = CheckpointManager(str(tmp_path / "ref")).restore(3, like)
    for (path, t), (_, want) in zip(leaf_paths(got), leaf_paths(arrays)):
        assert t.dtype == dict(leaf_paths(like))[path].dtype
        np.testing.assert_array_equal(_np(t), _np(want), err_msg=path)
    # the port writes, the reference restores
    port = CheckpointManager(str(tmp_path / "port"), async_save=False)
    port.save(3, _to_torch(arrays))
    back = JaxCkpt(str(tmp_path / "port")).restore(
        3, jax.tree.map(jnp.asarray, arrays))
    for path, want in leaf_paths(arrays):
        np.testing.assert_array_equal(_np(_flat_jax(back)[path]), _np(want),
                                      err_msg=path)
    # and the two manifests are the same file
    manifests = [json.loads((tmp_path / d / "step_000000003" /
                             "MANIFEST.json").read_text())
                 for d in ("ref", "port")]
    assert manifests[0] == manifests[1]


def test_checkpoint_roundtrip_gc_corruption_and_tmp_dirs(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = {"a": torch.arange(6.0).reshape(2, 3),
            "b": {"c": torch.tensor([1, 2, 3], dtype=torch.int32)}}
    for s in (1, 2, 3):
        mgr.save(s, tree_map(lambda x: x + s, tree))   # asynchronous
        tree["a"].add_(100.0)      # the save copied the tree first
    mgr.wait()
    assert mgr.all_steps() == [2, 3]                    # gc keeps newest 2
    got = mgr.restore(3, tree)
    np.testing.assert_array_equal(got["a"].numpy(),
                                  np.arange(6.0).reshape(2, 3) + 203)
    assert got["b"]["c"].dtype == torch.int32
    # corruption is detected
    d = tmp_path / "step_000000003"
    fname = sorted(f for f in os.listdir(d) if f.endswith(".npy"))[0]
    arr = np.load(d / fname)
    arr.reshape(-1)[0] += 1
    np.save(d / fname, arr)
    with pytest.raises(IOError, match="corruption"):
        mgr.restore(3, tree)
    # a save cut short is never resumed from
    os.makedirs(tmp_path / "step_000000009.tmp")
    assert mgr.latest_step() == 3
    assert CheckpointManager(str(tmp_path / "empty")).latest_step() is None


def test_compression_and_error_feedback_match_reference():
    rng = np.random.default_rng(0)
    g = (rng.standard_normal(300) * 5).astype(np.float32)
    qj, sj, _ = jcomp.compress(jnp.asarray(g))
    qt, st, meta = tcomp.compress(torch.from_numpy(g))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    back = tcomp.decompress(qt, st, meta)
    assert float((back - torch.from_numpy(g)).abs().max()) <= \
        np.abs(g).max() / 127.0 + 1e-6
    # error feedback over steps, on a tree with a ragged leaf
    shapes = {"w": (64,), "b": {"c": (3, 50)}}
    je = jcomp.init_error_state(tree_map(jnp.zeros, shapes))
    te = tcomp.init_error_state(tree_map(torch.zeros, shapes))
    for i in range(5):
        gi = tree_map(lambda s: rng.standard_normal(s).astype(np.float32),
                      shapes)
        js, je = jcomp.compress_tree_with_feedback(
            tree_map(jnp.asarray, gi), je)
        ts, te = tcomp.compress_tree_with_feedback(
            tree_map(torch.from_numpy, gi), te)
        for part, jt, tt in (("sent", js, ts), ("err", je, te)):
            want = _flat_jax(jt)
            for path, t in leaf_paths(tt):
                np.testing.assert_allclose(t.numpy(), np.asarray(want[path]),
                                           err_msg=f"{i} {part} {path}",
                                           **TOL)
    tree = {"w": torch.zeros((1024, 1024), dtype=torch.bfloat16)}
    assert tcomp.compressed_bytes(tree) == jcomp.compressed_bytes(
        {"w": jnp.zeros((1024, 1024), jnp.bfloat16)})


def test_spike_guard_and_retries():
    for mod in (tft, jft):
        guard = mod.SpikeGuard(mod.SpikeGuardConfig(
            window=8, spike_factor=2.0, max_consecutive_skips=2))
        assert [guard.should_commit(x) for x in (1.0, 1.1, 0.9, 1.0)] == \
            [True] * 4
        assert not guard.should_commit(float("nan"))
        assert not guard.should_commit(5.0)           # > 2 x median 1.0
        assert guard.should_commit(1.5)
        assert guard.total_skips == 2
        for _ in range(2):
            assert not guard.should_commit(float("inf"))
        with pytest.raises(RuntimeError, match="consecutive"):
            guard.should_commit(float("inf"))
    calls, retried = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return "ok"

    assert tft.with_retries(flaky, base_delay=0.001,
                            on_retry=lambda a, e: retried.append(a)) == "ok"
    assert retried == [0, 1]
    with pytest.raises(OSError):
        tft.with_retries(lambda: (_ for _ in ()).throw(OSError("down")),
                         max_attempts=2, base_delay=0.001)
    with pytest.raises(ValueError):    # not retriable: raised at once
        tft.with_retries(lambda: int("x"), base_delay=0.001)
    guard = tft.PreemptionGuard(install=False)
    guard._handler(15, None)
    assert guard.requested
