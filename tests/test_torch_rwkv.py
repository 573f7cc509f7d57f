"""The RWKV-6 family of the PyTorch port against the JAX reference: model
entry points (this file: the ``test_serving.py`` reduction; the same checks
on ``reduced()`` are in ``test_torch_rwkv_reduced.py``, a file of their own
so that the two run on separate test workers).

Both packages get the same weights (the reference's ``api.init`` through
``repro_torch.convert.params_from_numpy``; in the bp_* modes the
reference's ``quantize_dense_params`` first) and the same numpy tokens.
The reference runs op by op (``jax.disable_jit``), so that every operation
rounds to its dtype as PyTorch's eager operations do.  Prefill logits, the
WKV state and both token-shift carries, then one decode step's logits and
state, are compared on the ``test_serving.py`` reduction (2 layers, d 64)
and on ``reduced()`` (4 layers, d 128), in bf16, bp_exact and bp_approx, at
prompt lengths 6 (the step recurrence) and 64 and 128 (the chunked form:
the WKV6 kernel's plain version in the port, ``wkv_chunked`` in the
reference).

Tolerances, and why.  The two packages sum the WKV contractions (float32)
in different orders: seen here, the state agrees to ~1e-6 of its size when
nothing upstream differs.  Where such a float32 difference moves the bf16
rounding of the WKV output, the difference becomes one bf16 unit in the
last place, and downstream layers carry it on (in the bp_* modes it can
also move an int8 activation by one step).  Seen on these cases: logits
within 0.043, carries within 0.031, states within 1% of their largest
element, with 23-100% of the logits bit-identical.  So: logits and carries
(bf16) within atol = rtol = 2^-4, the WKV state within 2% of its largest
element, and at least 10% of the logits bit-identical.  The parity of the
WKV recurrence itself, without the model around it, is held at the
reference kernel test's 2e-4 in ``test_torch_wkv6.py``.
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
from repro_torch.kernels.wkv6 import ops as wkv6_ops
from repro_torch.models import api, layers

CONFIGS = {
    # tests/test_serving.py's reduction, and reduced() itself
    "small": dict(num_layers=2, d_model=64, d_ff=128, vocab_size=128),
    "reduced": {},
}
MODES = ("bf16", "bp_exact", "bp_approx")
BF16_TOL = 2.0 ** -4
STATE_TOL = 0.02
MIN_EXACT = 0.10


def _cfgs(which, mode="bf16"):
    kw = dict(CONFIGS[which], matmul_mode=mode)
    return (jax_get_arch("rwkv6-7b").reduced().replace(**kw),
            get_arch("rwkv6-7b").reduced().replace(**kw))


@pytest.fixture(scope="module")
def jax_params():
    return japi.init(jax.random.PRNGKey(0), _cfgs("small")[0])


def _both_params(jp, mode):
    if mode != "bf16":
        jp = jlayers.quantize_dense_params(jp)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _assert_state_matches(ct, cj, what):
    assert set(ct) == set(cj) == {"wkv", "x_tm", "x_cm"}
    for name in cj:
        got, want = _np(ct[name]), _np(cj[name])
        assert got.shape == want.shape, (what, name)
        if name == "wkv":
            assert ct[name].dtype == torch.float32
            np.testing.assert_allclose(
                got, want, rtol=0, atol=STATE_TOL * np.abs(want).max(),
                err_msg=f"{what}: {name}")
        else:
            assert ct[name].dtype == torch.bfloat16
            np.testing.assert_allclose(got, want, rtol=BF16_TOL,
                                       atol=BF16_TOL,
                                       err_msg=f"{what}: {name}")


def _assert_logits_match(lt, lj, what):
    got, want = _np(lt), _np(lj)
    assert lt.dtype == torch.bfloat16 and got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=BF16_TOL, atol=BF16_TOL,
                               err_msg=what)
    exact = float(np.mean(got == want))
    assert exact >= MIN_EXACT, f"{what}: only {exact:.3f} bit-identical"


def check_prefill_and_decode(jax_params, which, mode, S):
    """Prefill then one decode step in both packages; every output held to
    the module's tolerances."""
    jcfg, tcfg = _cfgs(which, mode)
    jp, tp = _both_params(jax_params, mode)
    toks = np.random.default_rng(S).integers(
        2, jcfg.vocab_size, (2, S)).astype(np.int32)
    nt = np.asarray([[5], [7]], np.int32)
    with jax.disable_jit():
        lj, cj = japi.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, S + 4)
        lj2, cj2 = japi.decode_step(jp, jcfg, {"tokens": jnp.asarray(nt),
                                               "cache": cj,
                                               "cache_len": jnp.int32(S)})
    wkv6_ops.reset_launches()
    lt, ct = api.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks).long()},
                         S + 4)
    assert wkv6_ops.LAUNCHES["wkv6"] == 0      # CPU tensors: plain version
    assert tuple(lt.shape) == (2, tcfg.vocab_padded)
    _assert_logits_match(lt, lj, "prefill logits")
    _assert_state_matches(ct, cj, "prefill state")
    prefill_state = {n: t.clone() for n, t in ct.items()}
    lt2, ct2 = api.decode_step(tp, tcfg, {
        "tokens": torch.from_numpy(nt).long(), "cache": ct, "cache_len": S})
    assert ct2 is ct                           # updated in place
    assert not torch.equal(ct["wkv"], prefill_state["wkv"])
    _assert_logits_match(lt2, lj2, "decode logits")
    _assert_state_matches(ct2, cj2, "decode state")


@pytest.mark.parametrize("S", [6, 64, 128])
@pytest.mark.parametrize("mode", MODES)
def test_prefill_and_decode_match_op_by_op(jax_params, mode, S):
    check_prefill_and_decode(jax_params, "small", mode, S)


def test_init_is_seeded_and_mirrors_the_reference_tree():
    jcfg, tcfg = _cfgs("small")
    a = api.init(tcfg, seed=3, device="cpu")
    b = api.init(tcfg, seed=3, device="cpu")
    c = api.init(tcfg, seed=4, device="cpu")
    assert torch.equal(a["layers"]["tm"]["maa_w1"],
                       b["layers"]["tm"]["maa_w1"])
    assert not torch.equal(a["layers"]["cm"]["wk"]["w"],
                           c["layers"]["cm"]["wk"]["w"])
    shapes = jax.eval_shape(lambda k: japi.init(k, jcfg),
                            jax.random.PRNGKey(0))
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    assert len(flat) == sum(1 for _ in _leaves(a))
    for path, leaf in flat:
        node = a
        for k in path:
            node = node[k.key]
        assert tuple(node.shape) == tuple(leaf.shape), path
        assert str(node.dtype).split(".")[-1] == str(leaf.dtype), path
    assert torch.all(a["layers"]["tm"]["decay_base"] == -1.0)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def test_bridge_and_quantization_keep_the_rwkv_tree(jax_params):
    """f32 leaves stay f32, the bf16 low-rank projections stay bf16 (they
    are not dense dicts), and only the seven dense ``w`` per layer plus the
    lm_head are quantized, bit-exactly as the reference quantizes them."""
    jp = jax_params
    jq = jlayers.quantize_dense_params(jp)
    tq = layers.quantize_dense_params(
        params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu"))
    tm, cm = tq["layers"]["tm"], tq["layers"]["cm"]
    for key in ("mu", "decay_base", "bonus_u"):
        assert tm[key].dtype == torch.float32, key
    assert cm["mu_k"].dtype == torch.float32
    for key in ("maa_w1", "maa_w2", "decay_w1", "decay_w2"):
        assert tm[key].dtype == torch.bfloat16, key
        np.testing.assert_array_equal(_np(tm[key]),
                                      _np(jq["layers"]["tm"][key]))
    quantized = [(("layers", "tm", n), tm[n]) for n in
                 ("wr", "wk", "wv", "wg", "wo")]
    quantized += [(("layers", "cm", n), cm[n]) for n in ("wk", "wv")]
    quantized += [(("lm_head",), tq["lm_head"])]
    for path, node in quantized:
        want = jq
        for k in path:
            want = want[k]
        assert node["w"].dtype == torch.int8, path
        np.testing.assert_array_equal(_np(node["w"]), _np(want["w"]))
        np.testing.assert_array_equal(_np(node["w_scale"]),
                                      _np(want["w_scale"]))
    n_int8 = sum(1 for t in _leaves(tq) if t.dtype == torch.int8)
    assert n_int8 == 8
    assert tq["embed"]["table"].dtype == torch.bfloat16


def test_cache_helpers_and_slot_surgery():
    _, cfg = _cfgs("small", "bp_exact")
    specs = api.cache_specs(cfg, 3, 99)
    H, N = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    assert specs == {"wkv": ((2, 3, H, N, N), torch.float32),
                     "x_tm": ((2, 3, 64), torch.bfloat16),
                     "x_cm": ((2, 3, 64), torch.bfloat16)}
    tp = layers.quantize_dense_params(api.init(cfg, seed=0, device="cpu"))
    toks = torch.from_numpy(np.arange(2, 14).reshape(2, 6)).long()
    _, src = api.prefill(tp, cfg, {"tokens": toks}, 8)
    pool = api.zeros_cache(cfg, 3, 8, "cpu")
    api.slot_insert(cfg, pool, src, 2, src_index=1)
    got = api.slot_extract(cfg, pool, 2)
    for name in src:
        assert torch.equal(got[name][:, 0], src[name][:, 1]), name
    assert not pool["wkv"][:, 0].any()


def test_recurrent_family_refuses_ragged_paged_and_verify():
    _, cfg = _cfgs("small")
    params = api.init(cfg, device="cpu")
    tokens = torch.zeros((2, 8), dtype=torch.long)
    with pytest.raises(ValueError, match="recurrent"):
        api.prefill(params, cfg, {"tokens": tokens}, 16,
                    prompt_lens=torch.tensor([4, 8]))
    with pytest.raises(ValueError, match="no paged cache layout"):
        api.paged_cache_specs(cfg, 8, 4)
    with pytest.raises(ValueError, match="no paged decode path"):
        api.decode_step_paged(params, cfg, {"tokens": tokens[:, :1]})
    assert not api.supports_verify(cfg)
    with pytest.raises(ValueError, match="no multi-token verify path"):
        api.verify_step(params, cfg, {"tokens": tokens})
    with pytest.raises(ValueError, match="no multi-token verify path"):
        api.verify_step_paged(params, cfg, {"tokens": tokens})
