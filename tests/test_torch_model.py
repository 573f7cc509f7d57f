"""Dense causal LM of the PyTorch port against the JAX reference.

Both packages get the same weights (the reference's ``api.init`` through
``repro_torch.convert.params_from_numpy``) and the same numpy inputs.

The reference is evaluated op by op (``jax.disable_jit``): every operation
then rounds its result to its dtype, as PyTorch's eager operations do.
The bf16 logits are held to rtol = atol = 1e-2, and at least 99% of all
logits and cache entries must be bit-identical.  What remains is float32
contraction order: XLA and PyTorch sum the attention einsums in different
orders, and once in a while that moves a bf16 rounding (and, downstream of
it, an int8 KV value by one).  Under ``jit`` XLA also keeps some bf16
intermediates in float32 across a fusion (``xla_allow_excess_precision``,
on by default), which moves jitted logits by a few bf16 units in the last
place; in the bp_* modes one such unit can carry an activation across an
int8 rounding boundary, so the comparison with the jitted reference is the
serving tests' token streams.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jax_get_arch
from repro.models import api as japi
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro_torch.configs.base import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.kernels.bitparticle_matmul.ops import is_kmajor
from repro_torch.models import api, attention, layers

SMALL = dict(num_layers=2, d_model=64, d_ff=128, vocab_size=128, head_dim=16)
MODES = [("bf16", False), ("bf16", True), ("bp_exact", True),
         ("bp_approx", True)]
MODE_IDS = ["bf16", "bf16-int8kv", "bp_exact-int8kv", "bp_approx-int8kv"]


def _cfgs(mode="bf16", int8kv=False):
    kw = dict(SMALL, matmul_mode=mode, kv_cache_int8=int8kv)
    return (jax_get_arch("qwen2-1.5b").reduced().replace(**kw),
            get_arch("qwen2-1.5b").reduced().replace(**kw))


@pytest.fixture(scope="module")
def jax_params():
    cfg, _ = _cfgs()
    return japi.init(jax.random.PRNGKey(0), cfg)


def _both_params(jp, mode):
    if mode != "bf16":
        jp = jlayers.quantize_dense_params(jp)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _tokens(B, S, seed=1):
    return np.random.default_rng(seed).integers(2, 128, (B, S)).astype(
        np.int32)


def _assert_matches(got, want, what, *, atol=1e-2, rtol=1e-2,
                    min_exact=0.99):
    """Within (rtol, atol), and bit-identical on at least ``min_exact`` of
    the elements."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)
    exact = float(np.mean(got == want))
    assert exact >= min_exact, f"{what}: only {exact:.4f} bit-identical"


def _assert_cache_matches(cj, ct):
    assert set(cj) == set(ct)
    for name in cj:
        if ct[name].dtype == torch.int8:        # one int8 step at most
            _assert_matches(ct[name], cj[name], name, atol=1, rtol=0)
        else:
            _assert_matches(ct[name], cj[name], name)


def test_quantize_dense_params_bit_exact(jax_params):
    jq = jlayers.quantize_dense_params(jax_params)
    tq = layers.quantize_dense_params(
        params_from_numpy(jax.tree.map(np.asarray, jax_params),
                          device="cpu"))
    for part in ("wq", "wk", "wv", "wo"):
        for key in ("w", "w_scale"):
            np.testing.assert_array_equal(
                _np(tq["layers"]["attn"][part][key]),
                _np(jq["layers"]["attn"][part][key]))
    for part in ("w_gate", "w_up", "w_down"):
        for key in ("w", "w_scale"):
            np.testing.assert_array_equal(
                _np(tq["layers"]["ffn"][part][key]),
                _np(jq["layers"]["ffn"][part][key]))
    w = tq["layers"]["ffn"]["w_gate"]["w"]
    assert w.dtype == torch.int8 and is_kmajor(w[0])
    assert tuple(tq["layers"]["ffn"]["w_gate"]["w_scale"].shape) == (2, 128)


def test_bridge_keeps_structure_dtypes_and_bits(jax_params):
    jq = jlayers.quantize_dense_params(jax_params)
    tp = params_from_numpy(jax.tree.map(np.asarray, jq), device="cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(jq)[0]
    for path, leaf in flat_j:
        node = tp
        for k in path:
            node = node[k.key]
        assert tuple(node.shape) == tuple(leaf.shape)
        np.testing.assert_array_equal(_np(node), _np(leaf))
    assert tp["embed"]["table"].dtype == torch.bfloat16
    assert tp["layers"]["attn"]["wq"]["b"].dtype == torch.float32
    assert is_kmajor(tp["layers"]["attn"]["wq"]["w"][1])


def _assert_mirrors_reference_tree(params, jcfg):
    """Same leaves, shapes and dtypes as the reference's ``api.init``."""
    shapes = jax.eval_shape(lambda k: japi.init(k, jcfg),
                            jax.random.PRNGKey(0))
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    n_leaves = 0
    for path, leaf in flat:
        node = params
        for k in path:
            node = node[k.key]
        assert tuple(node.shape) == tuple(leaf.shape), path
        assert str(node.dtype).split(".")[-1] == str(leaf.dtype), path
        n_leaves += 1
    assert n_leaves == len(list(_leaves(params)))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def test_init_is_seeded_and_mirrors_the_reference_tree():
    _, cfg = _cfgs()
    a = api.init(cfg, seed=3, device="cpu")
    b = api.init(cfg, seed=3, device="cpu")
    c = api.init(cfg, seed=4, device="cpu")
    assert torch.equal(a["layers"]["ffn"]["w_up"]["w"],
                       b["layers"]["ffn"]["w_up"]["w"])
    assert not torch.equal(a["layers"]["ffn"]["w_up"]["w"],
                           c["layers"]["ffn"]["w_up"]["w"])
    jcfg, _ = _cfgs()
    _assert_mirrors_reference_tree(a, jcfg)
    # truncated at two standard deviations, as the reference
    w = a["layers"]["ffn"]["w_up"]["w"].float()
    assert w.abs().max() <= 2 * SMALL["d_model"] ** -0.5
    # the MoE tree: a router and bf16 expert stacks in place of the FFN,
    # an untied lm head
    moe_kw = dict(SMALL, d_ff=32)
    jm = jax_get_arch("granite-moe-1b-a400m").reduced().replace(**moe_kw)
    tm = get_arch("granite-moe-1b-a400m").reduced().replace(**moe_kw)
    m = api.init(tm, seed=3, device="cpu")
    assert "ffn" not in m["layers"] and "lm_head" in m
    assert torch.equal(m["layers"]["moe"]["experts_up"],
                       api.init(tm, seed=3, device="cpu")["layers"]["moe"][
                           "experts_up"])
    _assert_mirrors_reference_tree(m, jm)


@pytest.mark.parametrize("mode,int8kv", MODES, ids=MODE_IDS)
def test_prefill_matches_op_by_op(jax_params, mode, int8kv):
    jcfg, tcfg = _cfgs(mode, int8kv)
    jp, tp = _both_params(jax_params, mode)
    toks = _tokens(3, 8)
    lens = np.asarray([8, 5, 3], np.int32)       # ragged, right-padded
    with jax.disable_jit():
        lj, cj = japi.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, 12,
                              prompt_lens=jnp.asarray(lens))
    lt, ct = api.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks).long()},
                         12, prompt_lens=torch.from_numpy(lens))
    assert lt.dtype == torch.bfloat16 and tuple(lt.shape) == (3, 256)
    _assert_matches(lt, lj, "logits")
    _assert_cache_matches(cj, ct)


def _prefilled(jp, tp, jcfg, tcfg, T=12):
    toks = _tokens(3, 8, seed=2)
    with jax.disable_jit():
        _, cj = japi.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, T)
    _, ct = api.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks).long()},
                        T)
    return cj, ct


@pytest.mark.parametrize("mode,int8kv", MODES, ids=MODE_IDS)
def test_decode_step_matches_op_by_op(jax_params, mode, int8kv):
    jcfg, tcfg = _cfgs(mode, int8kv)
    jp, tp = _both_params(jax_params, mode)
    cj, ct = _prefilled(jp, tp, jcfg, tcfg)
    nt = np.asarray([[5], [7], [9]], np.int32)
    cl = np.asarray([8, 6, 3], np.int32)          # per-slot depths
    with jax.disable_jit():
        lj, cj = japi.decode_step(jp, jcfg, {"tokens": jnp.asarray(nt),
                                             "cache": cj,
                                             "cache_len": jnp.asarray(cl)})
    lt, ct = api.decode_step(tp, tcfg, {"tokens": torch.from_numpy(nt).long(),
                                        "cache": ct,
                                        "cache_len": torch.from_numpy(cl)})
    _assert_matches(lt, lj, "logits")
    _assert_cache_matches(cj, ct)


@pytest.mark.parametrize("mode,int8kv", MODES, ids=MODE_IDS)
def test_verify_step_matches_op_by_op(jax_params, mode, int8kv):
    jcfg, tcfg = _cfgs(mode, int8kv)
    jp, tp = _both_params(jax_params, mode)
    cj, ct = _prefilled(jp, tp, jcfg, tcfg)
    nt = _tokens(3, 3, seed=5)
    cl = np.asarray([8, 10, 2], np.int32)         # slot 1 overruns T=12
    with jax.disable_jit():
        lj, cj = japi.verify_step(jp, jcfg, {"tokens": jnp.asarray(nt),
                                             "cache": cj,
                                             "cache_len": jnp.asarray(cl)})
    lt, ct = api.verify_step(tp, tcfg, {"tokens": torch.from_numpy(nt).long(),
                                        "cache": ct,
                                        "cache_len": torch.from_numpy(cl)})
    assert tuple(lt.shape) == (3, 3, 256)
    _assert_matches(lt, lj, "logits")
    _assert_cache_matches(cj, ct)


DENSE_ARCHS = ("qwen2-7b", "phi3-medium-14b", "granite-34b")


@pytest.mark.parametrize("mode,int8kv", [MODES[0], MODES[2]],
                         ids=[MODE_IDS[0], MODE_IDS[2]])
@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_dense_configs_prefill_and_decode_match_op_by_op(arch, mode, int8kv):
    """The other dense configs at ``reduced()``: untied lm heads (K1 in the
    bp_* modes), granite-34b's GELU FFN, one kv head each."""
    kw = dict(matmul_mode=mode, kv_cache_int8=int8kv)
    jcfg = jax_get_arch(arch).reduced().replace(**kw)
    tcfg = get_arch(arch).reduced().replace(**kw)
    jp, tp = _both_params(japi.init(jax.random.PRNGKey(0), jcfg), mode)
    assert "lm_head" in tp
    rng = np.random.default_rng(3)
    toks = rng.integers(2, 500, (3, 8)).astype(np.int32)
    lens = np.asarray([8, 6, 4], np.int32)
    with jax.disable_jit():
        lj, cj = japi.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, 12,
                              prompt_lens=jnp.asarray(lens))
    lt, ct = api.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks).long()},
                         12, prompt_lens=torch.from_numpy(lens))
    _assert_matches(lt, lj, "prefill logits")
    _assert_cache_matches(cj, ct)
    nt = rng.integers(2, 500, (3, 1)).astype(np.int32)
    with jax.disable_jit():
        lj, cj = japi.decode_step(jp, jcfg, {"tokens": jnp.asarray(nt),
                                             "cache": cj,
                                             "cache_len": jnp.asarray(lens)})
    lt, ct = api.decode_step(tp, tcfg, {"tokens": torch.from_numpy(nt).long(),
                                        "cache": ct,
                                        "cache_len": torch.from_numpy(lens)})
    _assert_matches(lt, lj, "decode logits")
    _assert_cache_matches(cj, ct)


def test_get_arch_mirrors_the_reference_configs():
    """Every ported architecture, and its ``reduced()`` form, equals the
    reference's config on every field the port's config has."""
    import dataclasses
    from repro_torch.configs.base import PORTED_ARCHS
    fields = [f.name for f in dataclasses.fields(get_arch("qwen2-1.5b"))]
    for name in PORTED_ARCHS:
        for t, j in ((get_arch(name), jax_get_arch(name)),
                     (get_arch(name).reduced(),
                      jax_get_arch(name).reduced())):
            for f in fields:
                assert getattr(t, f) == getattr(j, f), (name, f)
            assert t.vocab_padded == j.vocab_padded
            assert t.resolved_head_dim == j.resolved_head_dim
    assert {"granite-moe-1b-a400m", "moonshot-v1-16b-a3b", "qwen2-7b",
            "phi3-medium-14b", "granite-34b"} <= set(PORTED_ARCHS)


@pytest.mark.parametrize("cache_len,S", [
    (np.asarray([2, 6, 7], np.int32), 3),    # per-slot, tails past T drop
    (np.asarray([1, 7, 0], np.int32), 1),    # per-slot single row
    (np.int32(6), 3),                        # scalar, overrunning tail drops
    (np.int32(9), 1),                        # scalar single row: clamped
])
def test_write_kv_matches_reference_drop_semantics(cache_len, S):
    rng = np.random.default_rng(int(np.sum(cache_len)) + S)
    cache = rng.standard_normal((3, 8, 2, 4)).astype(np.float32)
    new = rng.standard_normal((3, S, 2, 4)).astype(np.float32)
    want = jattn.write_kv(jnp.asarray(cache), jnp.asarray(new),
                          jnp.asarray(cache_len))
    cl = (int(cache_len) if np.ndim(cache_len) == 0
          else torch.from_numpy(cache_len))
    got = attention.write_kv(torch.from_numpy(cache.copy()),
                             torch.from_numpy(new), cl)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_quantize_kv_bit_exact():
    rng = np.random.default_rng(8)
    k = rng.standard_normal((2, 5, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 5, 2, 16)).astype(np.float32) * 7
    k[0, 0, 0] = 0.0
    for got, want in zip(
            attention.quantize_kv(torch.from_numpy(k), torch.from_numpy(v)),
            jattn.quantize_kv(jnp.asarray(k), jnp.asarray(v))):
        np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("cache_len", [np.int32(4),
                                       np.asarray([1, 5], np.int32)])
@pytest.mark.parametrize("int8", [False, True])
def test_decode_attention_matches_reference(cache_len, int8):
    rng = np.random.default_rng(12)
    q = rng.standard_normal((2, 2, 4, 16)).astype(np.float32)
    kc = rng.standard_normal((2, 8, 2, 16)).astype(np.float32)
    vc = rng.standard_normal((2, 8, 2, 16)).astype(np.float32)
    kw_j, kw_t = {}, {}
    if int8:
        kq, ks, vq, vs = jattn.quantize_kv(jnp.asarray(kc), jnp.asarray(vc))
        kc, vc = np.array(kq), np.array(vq)
        kw_j = dict(k_scale=ks, v_scale=vs)
        kw_t = dict(k_scale=torch.from_numpy(np.array(ks)),
                    v_scale=torch.from_numpy(np.array(vs)))
    want = jattn.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                  jnp.asarray(vc), jnp.asarray(cache_len),
                                  **kw_j)
    got = attention.decode_attention(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
        torch.from_numpy(np.asarray(cache_len)), **kw_t)
    # float32 einsums summed in another order: a few float32 ulps
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_flash_attention_chunked_and_rejects_ragged_chunk():
    rng = np.random.default_rng(13)
    q = rng.standard_normal((2, 8, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 8, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 8, 2, 16)).astype(np.float32)
    with jax.disable_jit():
        want = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), chunk=4)
    got = attention.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), chunk=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        attention.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), chunk=3)


def test_rope_angles_within_one_float32_ulp():
    # cos/sin are library functions in both packages and may round apart
    # by one unit in the last place
    pos = np.arange(40, dtype=np.int32).reshape(2, 20)
    cj, sj = jlayers.rope_angles(jnp.asarray(pos), 32, 1e6)
    ct, st = layers.rope_angles(torch.from_numpy(pos), 32, 1e6)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=2.5e-7,
                               atol=1.2e-7)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=2.5e-7,
                               atol=1.2e-7)


def test_slot_insert_extract_roundtrip():
    _, cfg = _cfgs("bp_exact", True)
    tp = layers.quantize_dense_params(api.init(cfg, seed=0, device="cpu"))
    _, src = api.prefill(tp, cfg, {"tokens": torch.from_numpy(
        _tokens(2, 4)).long()}, 8)
    pool = api.zeros_cache(cfg, 3, 8, "cpu")
    api.slot_insert(cfg, pool, src, 2, src_index=1)
    got = api.slot_extract(cfg, pool, 2)
    for name in src:
        assert torch.equal(got[name][:, 0], src[name][:, 1]), name
    assert not pool["k"][:, 0].any()
    small = api.zeros_cache(cfg, 1, 4, "cpu")
    with pytest.raises(ValueError, match="does not fit"):
        api.slot_insert(cfg, pool, small, 0)
