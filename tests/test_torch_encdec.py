"""The encoder-decoder (audio) family (seamless-m4t-medium) of the PyTorch
port against the JAX reference, on its ``reduced()`` config (2 encoder
and 4 decoder layers, d_model 128).

Both packages get the same weights (the reference's ``api.init`` through
``repro_torch.convert.params_from_numpy``) and the same numpy inputs; the
reference runs jitted in a subprocess with
``XLA_FLAGS=--xla_allow_excess_precision=false``
(``torch_parity.run_reference``), so that each operation rounds as
PyTorch's eager ones do.

  * ``encode`` (non-causal, RoPE over the frames), ``cross_kv``, a
    prefill and two decode steps, bp_exact: within rtol = atol = 1e-2 and
    at least 99% bit-identical (``test_torch_model.py``'s tolerance).
  * A greedy ``serve(extras={id: {"src_embeds": ...}})`` whose sources
    have 128 frames, the pool's cross length: streams, finish reasons and
    counters equal the reference's serve.
  * The reference's fault with a shorter source (ROADMAP Queue 3): its
    pool holds ``max(cache_T // 4, 128)`` cross positions, an 80-frame
    source fills the leading 80, and decode attends to all of them, so
    its stream reads the slot's earlier occupant.  The port masks the
    cross positions at and after each row's ``cross_len``: its 80-frame
    serve equals the reference's ``generate()`` of the request, and the
    reference's serve is printed beside it.  (Requests of one admission
    group stack their sources, so the 80-frame request has a prompt
    length of its own, as it must in the reference too.)
  * One rebuild-and-replay recovery (an injected step fault, no retries)
    whose replayed prefills carry ``src_embeds`` again: streams and
    counters equal the reference engine's under the same injector.
  * The paged store is refused.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from repro.configs.base import get_arch as jax_get_arch
from repro.models import api as japi
from repro.models import encdec as jencdec
from repro.models import layers as jlayers
from repro_torch import serving as tserving
from repro_torch.configs.base import get_arch
from repro_torch.models import api, encdec

ARCH = "seamless-m4t-medium"
MAX_NEW = 6
FRAMES = 128
SHORT = 80
REPORT_FIELDS = ("steps", "n_syncs", "total_new_tokens")
FAULT_FIELDS = REPORT_FIELDS + ("n_recoveries", "n_injected_faults",
                                "n_preemptions")


def _cfg(get, mode="bp_exact"):
    return get(ARCH).reduced().replace(matmul_mode=mode)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _src(seed, frames, d=128):
    """Frame embeddings at the embedding table's scale (float32; both
    packages cast them to bf16)."""
    return (np.random.default_rng(seed).standard_normal((frames, d))
            * d ** -0.5).astype(np.float32)


def _workload(short: bool):
    """Four requests on two slots; with ``short``, request 3 (arriving
    when a slot has served a 128-frame source) has 80 frames."""
    rng = np.random.default_rng(31)
    lens = (12, 17, 12, 9)
    prompts = [rng.integers(2, 512, n).astype(np.int32) for n in lens]
    extras = {i: {"src_embeds": _src(40 + i, SHORT if short and i == 3
                                     else FRAMES)}
              for i in range(len(prompts))}
    return prompts, extras


def _requests(pkg, prompts):
    return [pkg.Request(prompt=p.copy(), max_new_tokens=MAX_NEW,
                        arrival_time=float(2 * i), request_id=i)
            for i, p in enumerate(prompts)]


def _engine(pkg, params, get, device=None, **scfg):
    return pkg.ServingEngine(_cfg(get), params, pkg.ServeConfig(
        max_new_tokens=MAX_NEW, temperature=0.0, **scfg),
        **({} if device is None else {"device": device}))


def _injector(pkg):
    return pkg.FaultInjector(schedule=[("step", 3)])


def _model_inputs():
    rng = np.random.default_rng(5)
    return (rng.integers(2, 512, (2, 10)).astype(np.int32),
            np.stack([_src(7, 48), _src(8, 48)]))


def _decode_inputs(step):
    return (np.asarray([[5 + step], [9 + step]], np.int32),
            np.asarray([10 + step, 10 + step], np.int32))


def write_reference(out_dir: str) -> None:
    """Serves at 128 and 80 frames, ``generate()`` of each request, a
    serve with one recovery, and the model's entry points, jitted (called
    in the subprocess)."""
    import dataclasses

    from repro import serving as jserving
    params = japi.init(jax.random.PRNGKey(0), _cfg(jax_get_arch))
    out = {}
    # one engine throughout, so that its compiled steps are shared
    eng = _engine(jserving, params, jax_get_arch)
    for name, short in (("full", False), ("short", True)):
        prompts, extras = _workload(short)
        rep = eng.serve(_requests(jserving, prompts), n_slots=2,
                        extras=extras)
        out[name] = tp.summary(rep, REPORT_FIELDS)
    out["short_generate"] = {
        str(i): np.asarray(eng.generate(
            {"tokens": p[None], "src_embeds": extras[i]["src_embeds"][None]},
            max_new_tokens=MAX_NEW).tokens[0]).tolist()
        for i, p in enumerate(prompts)}
    prompts, extras = _workload(False)
    eng.serve_cfg = dataclasses.replace(
        eng.serve_cfg, faults=_injector(jserving), max_step_retries=0)
    rep = eng.serve(_requests(jserving, prompts), n_slots=2, extras=extras)
    out["recovery"] = tp.summary(rep, FAULT_FIELDS)
    tp.save_reference(out_dir, out, params)

    cfg = _cfg(jax_get_arch)
    qp = jlayers.quantize_dense_params(params)
    toks, src = _model_inputs()
    enc = jax.jit(lambda p, s: jencdec.encode(p, cfg, s))(qp, src)
    cks, cvs = jax.jit(lambda p, e: jencdec.cross_kv(p, cfg, e))(qp, enc)
    logits, cache = jax.jit(lambda p, b: japi.prefill(p, cfg, b, 16))(
        qp, {"tokens": jnp.asarray(toks), "src_embeds": jnp.asarray(src)})
    arrays = {"encode": enc, "cross_k": cks, "cross_v": cvs,
              "prefill_logits": logits, "prefill_k": cache["k"],
              "prefill_v": cache["v"]}
    decode = jax.jit(lambda p, b: japi.decode_step(p, cfg, b))
    for step in range(2):
        nt, cl = _decode_inputs(step)
        logits, cache = decode(qp, {"tokens": jnp.asarray(nt),
                                    "cache": cache,
                                    "cache_len": jnp.asarray(cl)})
        arrays[f"decode{step}_logits"] = logits
    arrays.update(decoded_k=cache["k"], decoded_v=cache["v"])
    tp.save_arrays(out_dir, **arrays)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return tp.run_reference("test_torch_encdec",
                            tmp_path_factory.mktemp("jax_encdec_reference"))


def _assert_matches(got, want, what, *, atol=1e-2, rtol=1e-2,
                    min_exact=0.99):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)
    exact = float(np.mean(got == want))
    assert exact >= min_exact, f"{what}: only {exact:.4f} bit-identical"


@pytest.fixture(scope="module")
def quantized(reference):
    from repro_torch.models.layers import quantize_dense_params
    return quantize_dense_params(reference["params"])


def test_encode_and_cross_kv_match_reference(reference, quantized):
    cfg = _cfg(get_arch)
    want = reference["arrays"]
    _, src = _model_inputs()
    enc = encdec.encode(quantized, cfg, torch.from_numpy(src))
    _assert_matches(enc, want["encode"], "encode")
    cks, cvs = encdec.cross_kv(quantized, cfg, enc)
    assert tuple(cks.shape) == (cfg.num_layers, 2, 48, cfg.num_kv_heads,
                                cfg.resolved_head_dim)
    _assert_matches(cks, want["cross_k"], "cross_k")
    _assert_matches(cvs, want["cross_v"], "cross_v")


def test_prefill_and_decode_match_reference(reference, quantized):
    cfg = _cfg(get_arch)
    want = reference["arrays"]
    toks, src = _model_inputs()
    logits, cache = api.prefill(quantized, cfg, {
        "tokens": torch.from_numpy(toks).long(),
        "src_embeds": torch.from_numpy(src)}, 16)
    _assert_matches(logits, want["prefill_logits"], "prefill logits")
    for name in ("k", "v"):
        _assert_matches(cache[name], want[f"prefill_{name}"], name)
    assert cache["cross_len"].tolist() == [48, 48]
    for step in range(2):
        nt, cl = _decode_inputs(step)
        logits, cache = api.decode_step(quantized, cfg, {
            "tokens": torch.from_numpy(nt).long(), "cache": cache,
            "cache_len": torch.from_numpy(cl)})
        _assert_matches(logits, want[f"decode{step}_logits"],
                        f"decode {step} logits")
    for name in ("k", "v"):
        _assert_matches(cache[name], want[f"decoded_{name}"], name)


def _port_serve(reference, short, on_step_end=None, **scfg):
    prompts, extras = _workload(short)
    eng = _engine(tserving, reference["params"], get_arch, device="cpu",
                  **scfg)
    loop = eng.make_loop(_requests(tserving, prompts), n_slots=2,
                         extras=extras)
    loop.on_step_end = on_step_end
    return eng, prompts, loop, loop.run()


def test_serve_at_full_frames_matches_reference(reference):
    eng, prompts, loop, rep = _port_serve(reference, False)
    got, want = tp.summary(rep, REPORT_FIELDS), reference["full"]
    assert got["tokens"] == want["tokens"], (
        "token streams differ:\n"
        + tp.flip_report(eng, prompts, got["tokens"], want["tokens"]))
    assert got["finish"] == want["finish"]
    assert got["report"] == want["report"]
    # exact-length groups: no prompt is padded beside a longer one
    assert ({r["pad_to"] for r in loop.stream if r["kind"] == "prefill"}
            <= {len(p) for p in prompts})


def test_short_source_serve_equals_reference_generate(reference):
    lens = []
    _, _, loop, rep = _port_serve(
        reference, True, on_step_end=lambda lp: lens.append(
            lp.cm.cache["cross_len"].tolist()))
    got = tp.summary(rep, ())["tokens"]
    gen = reference["short_generate"]
    ref_serve = reference["short"]["tokens"]
    print(f"\nport serve {got}\nreference generate {gen}\n"
          f"reference serve {ref_serve}")
    assert ref_serve["3"] != gen["3"], "the reference's fault did not show"
    assert got == gen
    # the 80-frame request's slot carried its own source length, in a pool
    # of 128 cross positions
    assert loop.cm.cache["cross_k"].shape[2] == FRAMES
    assert any(SHORT in ls for ls in lens)


def test_recovery_replays_src_embeds(reference):
    _, prompts, loop, rep = _port_serve(
        reference, False, faults=_injector(tserving), max_step_retries=0)
    got, want = tp.summary(rep, FAULT_FIELDS), reference["recovery"]
    assert got == want
    assert rep.n_recoveries == 1
    assert got["tokens"] == reference["full"]["tokens"]
    # the replay prefills ran again with the requests' sources
    n_prefill = sum(r["kind"] == "prefill" for r in loop.stream)
    assert n_prefill > len(prompts)


def test_paged_store_refused(reference):
    cfg = _cfg(get_arch)
    with pytest.raises(ValueError, match="no paged cache layout"):
        api.paged_cache_specs(cfg, 8, 4)
    eng = tserving.ServingEngine(cfg, reference["params"],
                                 tserving.ServeConfig(cache_backend="paged"),
                                 device="cpu")
    prompts, extras = _workload(False)
    with pytest.raises(ValueError, match="position-indexed KV"):
        eng.serve(_requests(tserving, prompts)[:1], n_slots=1,
                  extras=extras)
