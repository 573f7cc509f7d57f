"""The hybrid family (zamba2-2.7b: Mamba-2 layers and a shared attention
block) of the PyTorch port against the JAX reference, on its ``reduced()``
config (d_model 128, SSM state 16, 8 SSM heads of 32) cut to 4 Mamba
layers in two super-blocks of 2, so that the shared block still runs
twice.

Both packages get the same weights (the reference's ``api.init`` through
``repro_torch.convert.params_from_numpy``) and the same numpy inputs.  The
causal conv and the SSD forms run the reference op by op
(``jax.disable_jit``); ``mamba2_block`` and the model run it jitted in a
subprocess with
``XLA_FLAGS=--xla_allow_excess_precision=false``
(``torch_parity.run_reference``), so that each operation rounds as
PyTorch's eager ones do.

  * The causal conv: the whole sequence against the same sequence fed one
    step at a time through its carry (bit-identical), and against the
    reference (bit-identical: the taps sum in bf16 in the reference's
    order, then the bias, then SiLU in float32).
  * The three SSD forms (``ssd_step``, ``ssd_sequential``,
    ``ssd_chunked`` at four chunks of 8, float32) against the reference's
    within rtol = atol = 1e-5 (float32 contraction order), the chunked
    form against the sequential one within 1e-4, and ``mamba2_block`` on
    both of its
    branches (S = 32 in chunks of 16; S = 9: sequential) and its single step,
    bf16 output within rtol = atol = 1e-2 with at least 95% bit-identical
    (``test_torch_model.py``'s tolerance, with the share lowered for the
    SSD's float32 sums feeding a bf16 rounding).
  * The cut model's prefill (S = 64 and 21) and two decode steps, bp_exact,
    with ``test_torch_rwkv.py``'s tolerances for a recurrence summed in
    float32 in another order than the reference's: seen here, layer 0's
    SSM state agrees to ~1e-8, and where such a difference moves the bf16
    rounding of a layer's output, later layers carry one bf16 unit on
    (and can move an int8 activation by one step); over the 12 layers of
    ``reduced()`` itself, logits parted by up to 0.074 with 18-34% of them
    bit-identical.  So logits, conv
    states and K/V (bf16) within atol = rtol = 2^-4 with at least 10% of
    the logits bit-identical, the SSM state within 2% of its largest
    element.
  * A greedy ``serve()`` of ``reduced()`` itself (12 Mamba layers) in
    bp_exact on the slab store, whose streams, finish reasons and counters
    equal the JAX engine's (jitted in the same subprocess), with prompts
    of 64 and 128 tokens (chunked SSD) and 37 and 50 (sequential); and
    ``generate()``.  (On the 4-layer cut, request 1 of this workload
    parts from the reference at its token 4, a top-2 margin of one bf16
    unit.)
  * Slot insert and extract of the (n_super, attn_every, B, ...) states on
    axis 2, against the reference's.
  * The five refusals, as the reference makes them: ragged prefill, the
    paged store, the verify step (speculation), chunked prefill and the
    sparsity probe.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from repro.configs.base import get_arch as jax_get_arch
from repro.models import api as japi
from repro.models import layers as jlayers
from repro.models import mamba2 as jmamba2
from repro_torch import serving as tserving
from repro_torch.configs.base import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.models import api, mamba2

ARCH = "zamba2-2.7b"
CUT = dict(num_layers=4, attn_every=2)
MAX_NEW = 6
PROMPT_LENS = (64, 37, 128, 50)
REPORT_FIELDS = ("steps", "n_syncs", "total_new_tokens")


def _cfg(get, mode="bp_exact", cut=True):
    return get(ARCH).reduced().replace(matmul_mode=mode,
                                       **(CUT if cut else {}))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _to_torch(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


def _assert_matches(got, want, what, *, atol=1e-2, rtol=1e-2,
                    min_exact=0.95):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)
    exact = float(np.mean(got == want))
    assert exact >= min_exact, f"{what}: only {exact:.4f} bit-identical"


def _prompts(vocab=512):
    rng = np.random.default_rng(21)
    return [rng.integers(2, vocab, n).astype(np.int32) for n in PROMPT_LENS]


def _requests(pkg):
    return [pkg.Request(prompt=p.copy(), max_new_tokens=MAX_NEW,
                        arrival_time=float(i), request_id=i)
            for i, p in enumerate(_prompts())]


def _engine(pkg, params, get, **kw):
    return pkg.ServingEngine(_cfg(get, cut=False), params, pkg.ServeConfig(
        max_new_tokens=MAX_NEW, temperature=0.0), **kw)


MODEL_S = (64, 21)
DECODE_STEPS = 2


def _model_tokens(S):
    return np.random.default_rng(S).integers(2, 512, (2, S)).astype(np.int32)


def _decode_inputs(S, step):
    return (np.asarray([[5 + step], [9 + step]], np.int32),
            np.asarray([S + step] * 2, np.int32))


def write_reference(out_dir: str) -> None:
    """A greedy slab serve of the workload on ``reduced()``, and the cut
    model's prefill and decode steps, jitted (called in the
    subprocess)."""
    from repro import serving as jserving
    params = japi.init(jax.random.PRNGKey(0), _cfg(jax_get_arch, cut=False))
    eng = _engine(jserving, params, jax_get_arch)
    rep = eng.serve(_requests(jserving), n_slots=2)
    tp.save_reference(out_dir, {"serve": tp.summary(rep, REPORT_FIELDS)},
                      params)
    cfg = _cfg(jax_get_arch)
    qp = jlayers.quantize_dense_params(japi.init(jax.random.PRNGKey(1), cfg))
    arrays = _reference_blocks(jax.tree.map(lambda a: a[0, 0],
                                            qp["mamba"]["mixer"]), cfg)
    prefill = jax.jit(lambda p, b, T: japi.prefill(p, cfg, b, T),
                      static_argnums=2)
    decode = jax.jit(lambda p, b: japi.decode_step(p, cfg, b))
    for S in MODEL_S:
        logits, cache = prefill(qp, {"tokens": jnp.asarray(_model_tokens(S))},
                                S + 4)
        arrays[f"S{S}_prefill_logits"] = logits
        arrays.update({f"S{S}_prefill_{k}": v for k, v in cache.items()})
        for step in range(DECODE_STEPS):
            nt, cl = _decode_inputs(S, step)
            logits, cache = decode(qp, {"tokens": jnp.asarray(nt),
                                        "cache": cache,
                                        "cache_len": jnp.asarray(cl)})
            arrays[f"S{S}_decode{step}_logits"] = logits
        arrays.update({f"S{S}_decoded_{k}": v for k, v in cache.items()})
    tp.save_arrays(out_dir, **arrays)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return tp.run_reference("test_torch_hybrid",
                            tmp_path_factory.mktemp("jax_hybrid_reference"))


@pytest.fixture(scope="module")
def jax_params():
    return japi.init(jax.random.PRNGKey(1), _cfg(jax_get_arch))


def _x(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# the Mamba-2 pieces
# ---------------------------------------------------------------------------

def test_causal_conv_full_against_streaming_and_reference():
    W, C, S = 4, 24, 9
    x = torch.from_numpy(_x((2, S, C), 1)).to(torch.bfloat16)
    w = torch.from_numpy(_x((W, C), 2, C ** -0.5))
    b = torch.from_numpy(_x((C,), 3, 0.1))
    full, state = mamba2.causal_conv(x, w, b)
    st = None
    steps = []
    for t in range(S):
        y, st = mamba2.causal_conv(x[:, t:t + 1], w, b, st)
        steps.append(y)
    assert torch.equal(torch.cat(steps, dim=1), full)
    assert torch.equal(st, state)
    with jax.disable_jit():
        yj, sj = jmamba2._causal_conv(jnp.asarray(x.float().numpy()).astype(
            jnp.bfloat16), jnp.asarray(w.numpy()), jnp.asarray(b.numpy()))
    np.testing.assert_array_equal(_np(full), _np(yj))
    np.testing.assert_array_equal(_np(state), _np(sj))


def _ssd_inputs(S, seed=4, B=2, H=3, P=8, N=5):
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((B, S, H, P)).astype(np.float32)
    Bs = rng.standard_normal((B, S, N)).astype(np.float32)
    Cs = rng.standard_normal((B, S, N)).astype(np.float32)
    dt = (np.log1p(np.exp(rng.standard_normal((B, S, H)) - 2.0))
          ).astype(np.float32)
    A = np.exp(rng.standard_normal(H) * 0.3).astype(np.float32)
    s0 = rng.standard_normal((B, H, P, N)).astype(np.float32) * 0.1
    return xh, Bs, Cs, dt, A, s0


def test_ssd_forms_match_reference_and_each_other():
    args = _ssd_inputs(32)
    ta = [torch.from_numpy(a) for a in args]
    ja = [jnp.asarray(a) for a in args]
    with jax.disable_jit():
        yj, sj = jmamba2.ssd_step(ja[0][:, 0], ja[1][:, 0], ja[2][:, 0],
                                  ja[3][:, 0], ja[4], ja[5])
        yqj, sqj = jmamba2.ssd_sequential(*ja)
        ycj, scj = jmamba2.ssd_chunked(*ja, chunk=8)
    yt, st = mamba2.ssd_step(ta[0][:, 0], ta[1][:, 0], ta[2][:, 0],
                             ta[3][:, 0], ta[4], ta[5])
    yqt, sqt = mamba2.ssd_sequential(*ta)
    yct, sct = mamba2.ssd_chunked(*ta, chunk=8)
    for got, want in ((yt, yj), (st, sj), (yqt, yqj), (sqt, sqj),
                      (yct, ycj), (sct, scj)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_allclose(yct.numpy(), yqt.numpy(), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(sct.numpy(), sqt.numpy(), rtol=1e-4,
                               atol=1e-4)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        mamba2.ssd_chunked(*[torch.from_numpy(a) for a in _ssd_inputs(37)],
                           chunk=8)


BLOCK_S = (32, 9, 1)


def _block_inputs(cfg, S):
    """(x, conv state, SSM state) of a ``mamba2_block`` case: the states
    only for the single step."""
    x = _x((2, S, cfg.d_model), 5)
    if S > 1:
        return x, None, None
    return (x, _x((2, cfg.ssm_conv_width - 1, cfg.d_model * 2
                   + 2 * cfg.ssm_state), 6),
            _x((2, 2 * cfg.d_model // cfg.ssm_head_dim, cfg.ssm_head_dim,
                cfg.ssm_state), 7, 0.1))


def _reference_blocks(mixer, cfg):
    """The reference's ``mamba2_block`` on layer (0, 0)'s quantized mixer
    at each of ``BLOCK_S``, jitted (in the subprocess)."""
    out = {}
    for S in BLOCK_S:
        x, cs, ss = _block_inputs(cfg, S)
        fn = jax.jit(lambda p, x, c, s: jmamba2.mamba2_block(
            p, x, cfg, "bp_exact", conv_state=c, ssm_state=s,
            single_step=S == 1, chunk=16))
        y, c, st = fn(mixer, jnp.asarray(x).astype(jnp.bfloat16),
                      None if cs is None else jnp.asarray(cs).astype(
                          jnp.bfloat16),
                      None if ss is None else jnp.asarray(ss))
        out.update({f"block{S}_y": y, f"block{S}_conv": c,
                    f"block{S}_ssm": st})
    return out


@pytest.mark.parametrize("S", BLOCK_S, ids=["chunked", "sequential",
                                            "single-step"])
def test_mamba2_block_both_branches(reference, jax_params, S):
    tcfg = _cfg(get_arch)
    tpar = _to_torch(jlayers.quantize_dense_params(
        jax.tree.map(lambda a: a[0, 0], jax_params["mamba"]["mixer"])))
    x, cs, ss = _block_inputs(tcfg, S)
    yt, ct, st = mamba2.mamba2_block(
        tpar, torch.from_numpy(x).to(torch.bfloat16), tcfg, "bp_exact",
        conv_state=None if cs is None else torch.from_numpy(cs).to(
            torch.bfloat16),
        ssm_state=None if ss is None else torch.from_numpy(ss),
        single_step=S == 1, chunk=16)
    want = reference["arrays"]
    assert yt.dtype == torch.bfloat16
    _assert_matches(yt, want[f"block{S}_y"], "mixer output")
    np.testing.assert_array_equal(_np(ct), want[f"block{S}_conv"])
    np.testing.assert_allclose(_np(st), want[f"block{S}_ssm"], rtol=1e-3,
                               atol=1e-3)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

BF16_TOL = 2.0 ** -4
STATE_TOL = 0.02
MIN_EXACT = 0.10


def _assert_cache_matches(ct, want, prefix):
    for name in ("conv", "k", "v"):
        _assert_matches(ct[name], want[f"{prefix}_{name}"], name,
                        atol=BF16_TOL, rtol=BF16_TOL, min_exact=0.0)
    ref = want[f"{prefix}_ssm"]
    err = np.abs(_np(ct["ssm"]) - ref).max()
    assert err <= STATE_TOL * np.abs(ref).max(), err


@pytest.mark.parametrize("S", MODEL_S, ids=["chunked", "sequential"])
def test_prefill_and_decode_match_reference(reference, jax_params, S):
    tcfg = _cfg(get_arch)
    tpar = _to_torch(jlayers.quantize_dense_params(jax_params))
    want = reference["arrays"]
    lt, ct = api.prefill(tpar, tcfg, {"tokens": torch.from_numpy(
        _model_tokens(S)).long()}, S + 4)
    _assert_matches(lt, want[f"S{S}_prefill_logits"], "prefill logits",
                    atol=BF16_TOL, rtol=BF16_TOL, min_exact=MIN_EXACT)
    _assert_cache_matches(ct, want, f"S{S}_prefill")
    for step in range(DECODE_STEPS):
        nt, cl = _decode_inputs(S, step)
        lt, ct = api.decode_step(tpar, tcfg, {
            "tokens": torch.from_numpy(nt).long(), "cache": ct,
            "cache_len": torch.from_numpy(cl)})
        _assert_matches(lt, want[f"S{S}_decode{step}_logits"],
                        f"decode {step} logits", atol=BF16_TOL,
                        rtol=BF16_TOL, min_exact=MIN_EXACT)
    _assert_cache_matches(ct, want, f"S{S}_decoded")


def test_slot_insert_extract_on_axis_2(jax_params):
    jcfg, tcfg = _cfg(jax_get_arch, "bf16"), _cfg(get_arch, "bf16")
    tpar = _to_torch(jax_params)
    toks = np.random.default_rng(3).integers(2, 512, (2, 10)).astype(
        np.int32)
    _, src = api.prefill(tpar, tcfg, {"tokens": torch.from_numpy(toks)
                                      .long()}, 16)
    assert api.cache_batch_axes(tcfg) == {"conv": 2, "ssm": 2, "k": 1,
                                          "v": 1}
    pool = api.zeros_cache(tcfg, 3, 16, "cpu")
    api.slot_insert(tcfg, pool, src, 2, src_index=1)
    jsrc = {name: jnp.asarray(_np(t)).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)
        for name, t in src.items()}
    jpool = japi.slot_insert(jcfg, japi.zeros_cache(jcfg, 3, 16), jsrc, 2,
                             1)
    for name in pool:
        np.testing.assert_array_equal(_np(pool[name]), _np(jpool[name]),
                                      err_msg=name)
    assert torch.equal(pool["conv"][:, :, 2], src["conv"][:, :, 1])
    assert not pool["ssm"][:, :, :2].any()
    one = api.slot_extract(tcfg, pool, 2)
    assert tuple(one["ssm"].shape)[:3] == (2, 2, 1)
    assert torch.equal(one["ssm"][:, :, 0], src["ssm"][:, :, 1])
    assert torch.equal(one["k"][:, 0], src["k"][:, 1])


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def test_greedy_serve_matches_reference(reference):
    eng = _engine(tserving, reference["params"], get_arch, device="cpu")
    loop = eng.make_loop(_requests(tserving), n_slots=2)
    rep = loop.run()
    got, want = tp.summary(rep, REPORT_FIELDS), reference["serve"]
    assert got["tokens"] == want["tokens"], (
        "token streams differ:\n"
        + tp.flip_report(eng, _prompts(), got["tokens"], want["tokens"]))
    assert got["finish"] == want["finish"]
    assert got["report"] == want["report"]
    # exact-length groups: no prefill is padded
    prefills = [r for r in loop.stream if r["kind"] == "prefill"]
    assert sorted(r["pad_to"] for r in prefills) == sorted(PROMPT_LENS)
    for i, p in enumerate(_prompts()):
        g = eng.generate({"tokens": p[None]}, max_new_tokens=MAX_NEW)
        assert g.tokens[0].tolist() == got["tokens"][str(i)], i


@pytest.mark.parametrize("case", ["ragged", "paged", "verify", "chunked",
                                  "probe"])
def test_hybrid_refusals(reference, case):
    cfg = _cfg(get_arch)
    params = reference["params"]
    if case == "ragged":
        toks = torch.ones((2, 8), dtype=torch.long)
        with pytest.raises(ValueError, match="recurrent state"):
            api.prefill(params, cfg, {"tokens": toks}, 16,
                        prompt_lens=torch.tensor([8, 5]))
        return
    if case == "paged":
        with pytest.raises(ValueError, match="no paged cache layout"):
            api.paged_cache_specs(cfg, 8, 4)
        eng = tserving.ServingEngine(cfg, params, tserving.ServeConfig(
            cache_backend="paged"), device="cpu")
        with pytest.raises(ValueError, match="position-indexed KV"):
            eng.serve(_requests(tserving)[:1], n_slots=1)
        return
    if case == "probe":
        eng = tserving.ServingEngine(cfg, params, tserving.ServeConfig(
            probe=tserving.SparsityProbe(probe_every=1)), device="cpu")
        with pytest.raises(ValueError, match="probe unsupported"):
            eng.make_loop(_requests(tserving)[:1])
        return
    scfg = (tserving.ServeConfig(draft="prompt_lookup") if case == "verify"
            else tserving.ServeConfig(prefill_chunk=16))
    with pytest.raises(ValueError, match="multi-token verify path"):
        tserving.ServingEngine(cfg, params, scfg, device="cpu")
