"""The mixture-of-experts family of the PyTorch port against the JAX
reference.

Both packages get the same weights (the reference's ``init_moe`` /
``api.init`` through ``repro_torch.convert.params_from_numpy``) and the
same numpy inputs.

  * ``moe_ffn`` on ``granite-moe-1b-a400m``'s ``reduced()`` config (8
    experts, top 2), bf16 activations, with a bf16 router and with the
    int8 router of the bp_* modes (``quantize_dense_params``), with
    capacity drops (``capacity_factor=0.25``) and without (8.0): the
    reference runs op by op (``jax.disable_jit``).  The output lies within
    the reference's own oracle tolerance (atol = rtol = 0.08,
    ``tests/test_sequence_mixers.py``), the expert picks, dispatch slots
    and kept flags are identical, the aux loss within 1e-5.  With router
    columns made equal, exact ties among the probabilities go to the lower
    expert id in both (``jax.lax.top_k``'s rule; ``torch.topk`` promises
    none, so the port sorts stably).
  * Prefill, decode and verify of the whole reduced MoE model, op by op,
    as ``tests/test_torch_model.py`` holds the dense family.
  * Greedy ``serve()`` on the slab and paged stores on
    ``tests/test_paged_kv.py::test_moe_family``'s config and requests (bf16
    and bp_exact): the streams, finish reasons and the report's counters
    equal the JAX engine's, run jitted in a subprocess with
    ``XLA_FLAGS=--xla_allow_excess_precision=false``
    (``torch_parity.run_reference``).  Capacity depends on the padded
    token count, so this also holds the port to the reference's batch
    shapes: prefill buckets, idle decode slots.
  * A probed prefill's stats equal the stats the reference's tap collects
    from the jitted prefill, the router's activations included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from repro.configs.base import get_arch as jax_get_arch
from repro.core import probe as jprobe
from repro.models import api as japi
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro_torch import serving as tserving
from repro_torch.configs.base import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.models import api, layers, moe

ARCH = "granite-moe-1b-a400m"
#: tests/test_paged_kv.py::test_moe_family's config
SERVE_SMALL = dict(num_layers=2, d_model=64, vocab_size=128, head_dim=16)
SERVE_MODES = ("bf16", "bp_exact")
REPORT_FIELDS = ("steps", "n_syncs", "total_new_tokens", "peak_active_slots",
                 "n_preemptions", "prefix_hit_blocks", "peak_blocks_in_use")
PROBE_TOKENS_SHAPE = (2, 12)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _to_torch(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


# ---------------------------------------------------------------------------
# moe_ffn, op by op
# ---------------------------------------------------------------------------

def _ffn_cfgs(cf):
    return (jax_get_arch(ARCH).reduced().replace(capacity_factor=cf),
            get_arch(ARCH).reduced().replace(capacity_factor=cf))


@pytest.fixture(scope="module")
def moe_params():
    jcfg, _ = _ffn_cfgs(1.25)
    return jmoe.init_moe(jax.random.PRNGKey(0), jcfg)


def _router_quantized(jp, quantized):
    return jlayers.quantize_dense_params(jp) if quantized else jp


def _reference_routing(jp, xg, jcfg):
    """The reference's routing and dispatch (``moe.py:91-113``), op by
    op."""
    logits = jlayers.dense(jp["router"], xg, "bf16").astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    top_p, top_e = jax.lax.top_k(probs, jcfg.top_k)
    C = jmoe._capacity(xg.shape[1], jcfg)
    slot, order, keep = jax.vmap(
        lambda te: jmoe._dispatch_indices(te, C, jcfg.num_experts))(top_e)
    return top_e, slot, order, keep


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _run_ffn(jp, jcfg, tcfg, x):
    """(reference (out, aux, routing), port (out, aux, routing)) on the
    same bf16 input."""
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    B, S, D = x.shape
    G = jmoe._num_groups(B * S)
    assert G == moe._num_groups(B * S)
    with jax.disable_jit():
        oj, aj = jmoe.moe_ffn(jp, xj, jcfg, "bf16")
        rj = _reference_routing(jp, xj.reshape(G, -1, D), jcfg)
    tpar = _to_torch(jp)
    ot, at = moe.moe_ffn(tpar, xt, tcfg, "bf16")
    _, _, top_e = moe.route(tpar, xt.reshape(G, -1, D), tcfg)
    C = moe._capacity(B * S // G, tcfg)
    assert C == jmoe._capacity(B * S // G, jcfg)
    rt = (top_e,) + moe._dispatch_indices(top_e, C, tcfg.num_experts)
    return (oj, aj, rj), (ot, at, rt)


def _assert_ffn_matches(ref, got, drops):
    (oj, aj, rj), (ot, at, rt) = ref, got
    assert ot.dtype == torch.bfloat16 and tuple(ot.shape) == oj.shape
    for name, a, b in zip(("top_e", "slot", "order", "keep"), rt, rj):
        np.testing.assert_array_equal(_np(a), _np(b), err_msg=name)
    keep = _np(rt[3])
    assert (not keep.all()) if drops else keep.all()
    np.testing.assert_allclose(_np(ot), _np(oj), atol=0.08, rtol=0.08)
    assert abs(float(at) - float(aj)) <= 1e-5
    assert float(at) > 0


@pytest.mark.parametrize("router", ["bf16", "int8"])
@pytest.mark.parametrize("cf,drops", [(8.0, False), (0.25, True)],
                         ids=["no-drops", "drops"])
def test_moe_ffn_matches_reference(moe_params, router, cf, drops):
    jcfg, tcfg = _ffn_cfgs(cf)
    jp = _router_quantized(moe_params, router == "int8")
    # T = 70 tokens: two groups of 35 (at 64 tokens, eight groups of 8
    # could never overfill the capacity floor of 8 slots)
    ref, got = _run_ffn(jp, jcfg, tcfg, _x((2, 35, jcfg.d_model), 1))
    _assert_ffn_matches(ref, got, drops)


@pytest.mark.parametrize("router", ["bf16", "int8"])
def test_router_ties_go_to_the_lower_expert(moe_params, router):
    """Router columns 0-2, 3-5 and 6-7 made equal: every token's
    probabilities tie exactly in threes, and top 2 of a three-way tie must
    be its two lowest ids, in ascending order, in both packages."""
    jcfg, tcfg = _ffn_cfgs(1.25)
    w = np.asarray(moe_params["router"]["w"])
    cols = [0, 0, 0, 3, 3, 3, 6, 6]
    jp = dict(moe_params, router={"w": jnp.asarray(w[:, cols])})
    jp = _router_quantized(jp, router == "int8")
    ref, got = _run_ffn(jp, jcfg, tcfg, _x((2, 16, jcfg.d_model), 2))
    top_e = _np(got[2][0]).reshape(-1, 2)
    # the picks are the two lowest ids of one tied group, in order
    assert np.isin(top_e[:, 0], (0, 3, 6)).all()
    assert (top_e[:, 1] == top_e[:, 0] + 1).all()
    _assert_ffn_matches(ref, got, drops=False)


def test_num_groups_and_capacity_follow_the_reference():
    jcfg, tcfg = _ffn_cfgs(1.25)
    full_j = jax_get_arch("moonshot-v1-16b-a3b")
    full_t = get_arch("moonshot-v1-16b-a3b")
    for T in (1, 4, 7, 8, 16, 20, 64, 96, 512, 2048, 4096, 6000):
        assert moe._num_groups(T) == jmoe._num_groups(T), T
        tg = T // moe._num_groups(T)
        for cj, ct in ((jcfg, tcfg), (full_j, full_t)):
            assert moe._capacity(tg, ct) == jmoe._capacity(tg, cj), (T, ct)


def test_init_moe_draws_bf16_layer_by_layer():
    _, cfg = _ffn_cfgs(1.25)
    gen = torch.Generator().manual_seed(0)
    p = moe.init_moe(gen, cfg, (3,))
    E, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    assert p["router"]["w"].shape == (3, d, E)
    for name, shape in (("experts_gate", (E, d, f)),
                        ("experts_up", (E, d, f)),
                        ("experts_down", (E, f, d))):
        leaf = p[name]
        assert leaf.dtype == torch.bfloat16 and leaf.shape == (3, *shape)
        # truncated at two standard deviations; layers drawn apart
        std = (d if name != "experts_down" else f) ** -0.5
        assert leaf.float().abs().max() <= 2 * std
        assert not torch.equal(leaf[0], leaf[1])
    q = layers.quantize_dense_params(p)
    assert q["router"]["w"].dtype == torch.int8
    assert q["experts_up"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# the whole reduced model, op by op
# ---------------------------------------------------------------------------

MODEL_MODES = [("bf16", False), ("bp_exact", True), ("bp_approx", True)]
MODEL_IDS = ["bf16", "bp_exact-int8kv", "bp_approx-int8kv"]


def _model_cfgs(mode="bf16", int8kv=False):
    kw = dict(matmul_mode=mode, kv_cache_int8=int8kv)
    return (jax_get_arch(ARCH).reduced().replace(**kw),
            get_arch(ARCH).reduced().replace(**kw))


@pytest.fixture(scope="module")
def model_params():
    jcfg, _ = _model_cfgs()
    return japi.init(jax.random.PRNGKey(0), jcfg)


def _both(jp, mode):
    if mode != "bf16":
        jp = jlayers.quantize_dense_params(jp)
    return jp, _to_torch(jp)


def _tokens(B, S, seed):
    return np.random.default_rng(seed).integers(2, 500, (B, S)).astype(
        np.int32)


def _assert_matches(got, want, what, *, atol=1e-2, rtol=1e-2,
                    min_exact=0.99):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)
    exact = float(np.mean(got == want))
    assert exact >= min_exact, f"{what}: only {exact:.4f} bit-identical"


def _assert_rows_match(got, want, what, max_rows_apart=1, tol=5e-2):
    """Logits row by row: all but ``max_rows_apart`` rows bit-identical,
    the rest within ``tol``.  The verify step's attention sums its float32
    products in another order than the reference's (bf16 mode shows it
    as differences of ~1e-4 in the written V); in a bp_* mode one such
    rounding can move an int8 activation of ``wo`` by one, and that row's
    logits by a few hundredths."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=what)
    apart = (got != want).reshape(-1, got.shape[-1]).any(-1)
    assert apart.sum() <= max_rows_apart, f"{what}: rows {np.where(apart)}"


def _assert_cache_matches(cj, ct):
    assert set(cj) == set(ct)
    for name in cj:
        if ct[name].dtype == torch.int8:
            _assert_matches(ct[name], cj[name], name, atol=1, rtol=0)
        else:
            _assert_matches(ct[name], cj[name], name)


@pytest.mark.parametrize("mode,int8kv", MODEL_MODES, ids=MODEL_IDS)
def test_model_prefill_decode_verify_match_op_by_op(model_params, mode,
                                                    int8kv):
    jcfg, tcfg = _model_cfgs(mode, int8kv)
    jp, tpar = _both(model_params, mode)
    toks = _tokens(3, 8, 1)
    lens = np.asarray([8, 5, 3], np.int32)
    with jax.disable_jit():
        lj, cj = japi.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, 12,
                              prompt_lens=jnp.asarray(lens))
    lt, ct = api.prefill(tpar, tcfg, {"tokens": torch.from_numpy(toks).long()},
                         12, prompt_lens=torch.from_numpy(lens))
    assert lt.dtype == torch.bfloat16 and tuple(lt.shape) == (3, 512)
    _assert_matches(lt, lj, "prefill logits")
    _assert_cache_matches(cj, ct)
    for what, nt, cl in (
            ("decode", np.asarray([[5], [7], [9]], np.int32),
             np.asarray([8, 5, 3], np.int32)),
            ("verify", _tokens(3, 3, 5), np.asarray([9, 6, 4], np.int32))):
        bj = {"tokens": jnp.asarray(nt), "cache": cj,
              "cache_len": jnp.asarray(cl)}
        bt = {"tokens": torch.from_numpy(nt).long(), "cache": ct,
              "cache_len": torch.from_numpy(cl)}
        fj, ft = ((japi.decode_step, api.decode_step) if what == "decode"
                  else (japi.verify_step, api.verify_step))
        with jax.disable_jit():
            lj, cj = fj(jp, jcfg, bj)
        lt, ct = ft(tpar, tcfg, bt)
        if what == "decode":
            _assert_matches(lt, lj, "decode logits")
        else:
            _assert_rows_match(lt, lj, "verify logits")
        _assert_cache_matches(cj, ct)


def test_forward_sums_the_layers_aux_losses(model_params):
    jcfg, tcfg = _model_cfgs()
    jp, tpar = _both(model_params, "bf16")
    toks = _tokens(3, 8, 1)     # the shapes the op-by-op test above ran
    from repro.models import causal_lm as jclm
    from repro_torch.models import causal_lm
    with jax.disable_jit():
        _, aux_j, _ = jclm.forward(jp, jcfg, {"tokens": jnp.asarray(toks)})
    _, aux_t, cache = causal_lm.forward(
        tpar, tcfg, {"tokens": torch.from_numpy(toks).long()})
    assert cache is None and aux_t.dtype == torch.float32
    assert abs(float(aux_t) - float(aux_j)) <= 1e-5 * jcfg.num_layers
    dcfg = get_arch("qwen2-1.5b").reduced()
    dense = api.init(dcfg, device="cpu")
    assert float(causal_lm.forward(
        dense, dcfg, {"tokens": torch.from_numpy(toks).long()})[1]) == 0.0


# ---------------------------------------------------------------------------
# greedy serve() and the probe against the reference engine
# ---------------------------------------------------------------------------

def _serve_cfg(get, mode):
    return get(ARCH).reduced().replace(matmul_mode=mode, **SERVE_SMALL)


def _serve(pkg, engine, prompts):
    reqs = [pkg.Request(prompt=np.asarray(prompts[i], np.int32).copy(),
                        max_new_tokens=4, arrival_time=float(i),
                        request_id=i) for i in range(len(prompts))]
    return engine.serve(reqs, n_slots=2)


def _probe_tokens():
    tokens = tp.tokens(3, PROBE_TOKENS_SHAPE)
    tokens[1, 7:] = 0
    return tokens


def write_reference(out_dir: str) -> None:
    """Serve ``test_moe_family``'s requests on both stores in both modes,
    and run the probed prefill, in the JAX engine (called in the subprocess
    that the ``reference`` fixture starts)."""
    from repro import serving as jserving

    base = _serve_cfg(jax_get_arch, "bf16")
    params = japi.init(jax.random.PRNGKey(0), base)
    # tests/test_paged_kv.py::_prompts(cfg, 3, 6)
    prompts = np.asarray(jax.random.randint(
        jax.random.PRNGKey(1), (3, 6), 2, base.vocab_size), np.int32)
    out = {"prompts": prompts.tolist()}
    for mode in SERVE_MODES:
        for backend in ("slab", "paged"):
            eng = jserving.ServingEngine(
                base.replace(matmul_mode=mode), params,
                jserving.ServeConfig(max_new_tokens=8, temperature=0.0,
                                     cache_backend=backend, block_size=4))
            out[f"{mode}/{backend}"] = tp.summary(
                _serve(jserving, eng, prompts), REPORT_FIELDS)
    pcfg = base.replace(matmul_mode="bp_exact")
    qparams = jlayers.quantize_dense_params(params)

    def tapped(p, b):
        with jprobe.probe_tap():
            japi.prefill(p, pcfg, b, 16)
            return jprobe.collect()
    out["probe_stats"] = np.asarray(jax.jit(tapped)(
        qparams, {"tokens": jnp.asarray(_probe_tokens())})).tolist()
    tp.save_reference(out_dir, out, params)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return tp.run_reference("test_torch_moe",
                            tmp_path_factory.mktemp("jax_moe_reference"))


@pytest.mark.parametrize("backend", ["slab", "paged"])
@pytest.mark.parametrize("mode", SERVE_MODES)
def test_greedy_serve_matches_reference(reference, mode, backend):
    cfg = _serve_cfg(get_arch, mode)
    eng = tserving.ServingEngine(
        cfg, reference["params"],
        tserving.ServeConfig(max_new_tokens=8, temperature=0.0,
                             cache_backend=backend, block_size=4),
        device="cpu")
    prompts = reference["prompts"]
    got = tp.summary(_serve(tserving, eng, prompts), REPORT_FIELDS)
    want = reference[f"{mode}/{backend}"]
    assert got["tokens"] == want["tokens"], (
        "token streams differ:\n"
        + tp.flip_report(eng, prompts, got["tokens"], want["tokens"]))
    assert got["finish"] == want["finish"]
    assert got["report"] == want["report"]


def test_probed_prefill_matches_reference_tap(reference):
    cfg = _serve_cfg(get_arch, "bp_exact")
    params = layers.quantize_dense_params(reference["params"])
    tok = torch.as_tensor(_probe_tokens()).long()
    logits, _, stats = api.prefill_probed(params, cfg, {"tokens": tok}, 16)
    # per layer (attention, router) plus the untied lm head's trailing row
    assert stats.dtype == torch.float32
    assert stats.shape == (cfg.num_layers + 1, 3)
    np.testing.assert_array_equal(
        stats.numpy(), np.asarray(reference["probe_stats"], np.float32))
    assert torch.equal(logits, api.prefill(params, cfg, {"tokens": tok},
                                           16)[0])
