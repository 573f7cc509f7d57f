"""The vision-language family (qwen2-vl-7b) of the PyTorch port against the
JAX reference, on its ``reduced()`` config cut to two layers.

Both packages get the same weights (the reference's ``api.init`` through
``repro_torch.convert.params_from_numpy``) and the same numpy inputs.

  * ``mrope_angles`` on three unequal position rows, within one float32
    unit (``test_torch_model.py``'s RoPE tolerance: rtol 2.5e-7, atol
    1.2e-7).
  * Prefill with a ``vision_embeds`` splice and three unequal position
    rows, then decode and verify, in bp_exact, against the reference run
    jitted in a subprocess with
    ``XLA_FLAGS=--xla_allow_excess_precision=false``
    (``torch_parity.run_reference``), so that its every operation rounds
    as PyTorch's eager ones do: logits within rtol = atol = 1e-2 and at
    least 99% of logits and cache entries bit-identical
    (``test_torch_model.py``'s tolerance).
  * Greedy ``serve(extras=...)`` in bp_exact on the slab and paged stores
    against the JAX engine (in the same subprocess): every stream equals
    the reference's
    slab serve and its one-request ``generate()``.  Two requests carry the
    same 40 tokens and different images.  The reference's paged store
    keys its prefix trie on tokens alone, so there the second request
    adopts the first one's blocks and its stream parts from its own
    ``generate()`` (a reference fault, ROADMAP Queue 3); the port keeps
    such requests out of the trie, so its paged streams equal
    ``generate()``, and the reference's paged streams are printed beside
    them.  Text-only requests on the same config still share a system
    prompt's blocks.
  * The refusals: M-RoPE ``positions`` among the extras
    (``NotImplementedError``), a group that mixes requests with and without
    an extra, and chunked prefill with extras (``ValueError``).
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
from repro_torch import serving as tserving
from repro_torch.configs.base import get_arch
from repro_torch.models import api, layers

ARCH = "qwen2-vl-7b"
CUT = dict(num_layers=2)
BLOCK_SIZE = 16
MAX_NEW = 6
REPORT_FIELDS = ("steps", "n_syncs", "total_new_tokens")


def _cfg(get, mode="bp_exact"):
    return get(ARCH).reduced().replace(matmul_mode=mode, **CUT)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _image(seed, S, span, d):
    """A request's extras: a leading vision span of ``span`` positions
    whose embeddings lie at the embedding table's scale (float32 here;
    both packages cast them to bf16)."""
    rng = np.random.default_rng(seed)
    mask = np.zeros(S, bool)
    mask[:span] = True
    return {"vision_embeds": (rng.standard_normal((S, d))
                              * d ** -0.5).astype(np.float32),
            "vision_mask": mask}


def _workload(vocab=512, d=128):
    """(prompts, arrivals, extras): requests 0 and 1 carry the same 40
    tokens (a 32-position vision span) and different images; request 2 a
    24-token prompt with 8 vision positions; requests 3 and 4 are
    text-only and share a 32-token system prompt."""
    rng = np.random.default_rng(11)
    shared = rng.integers(2, vocab, 40).astype(np.int32)
    system = rng.integers(2, vocab, 32).astype(np.int32)
    prompts = [shared, shared.copy(),
               rng.integers(2, vocab, 24).astype(np.int32),
               np.concatenate([system, rng.integers(2, vocab, 5)]).astype(
                   np.int32),
               np.concatenate([system, rng.integers(2, vocab, 9)]).astype(
                   np.int32)]
    extras = {0: _image(1, 40, 32, d), 1: _image(2, 40, 32, d),
              2: _image(3, 24, 8, d)}
    arrivals = (0.0, 2.0, 3.0, 4.0, 6.0)
    return prompts, arrivals, extras


def _requests(pkg, prompts, arrivals):
    return [pkg.Request(prompt=p.copy(), max_new_tokens=MAX_NEW,
                        arrival_time=a, request_id=i)
            for i, (p, a) in enumerate(zip(prompts, arrivals))]


def _engine(pkg, params, get, backend, **kw):
    return pkg.ServingEngine(_cfg(get), params, pkg.ServeConfig(
        max_new_tokens=MAX_NEW, temperature=0.0, cache_backend=backend,
        block_size=BLOCK_SIZE), **kw)


def _generate_one(engine, prompt, extra):
    batch = {"tokens": prompt[None]}
    batch.update({k: v[None] for k, v in (extra or {}).items()})
    return np.asarray(engine.generate(batch, max_new_tokens=MAX_NEW)
                      .tokens[0]).tolist()


def write_reference(out_dir: str) -> None:
    """Serve the workload on both stores and ``generate()`` each request
    (called in the subprocess)."""
    import dataclasses

    from repro import serving as jserving
    params = japi.init(jax.random.PRNGKey(0), _cfg(jax_get_arch))
    prompts, arrivals, extras = _workload()
    out = {"serve": {}}
    # one engine throughout, so that its compiled steps are shared
    eng = _engine(jserving, params, jax_get_arch, "slab")
    for backend in ("slab", "paged"):
        eng.serve_cfg = dataclasses.replace(eng.serve_cfg,
                                            cache_backend=backend)
        rep = eng.serve(_requests(jserving, prompts, arrivals), n_slots=2,
                        extras=extras)
        out["serve"][backend] = tp.summary(
            rep, REPORT_FIELDS + ("prefix_hit_blocks",))
    out["generate"] = {str(i): _generate_one(eng, p, extras.get(i))
                       for i, p in enumerate(prompts)}
    tp.save_reference(out_dir, out, params)

    cfg = _cfg(jax_get_arch)
    qp = jlayers.quantize_dense_params(params)
    logits, cache = jax.jit(lambda p, b: japi.prefill(p, cfg, b, 20))(
        qp, jax.tree.map(jnp.asarray, _vision_batch()))
    arrays = {"prefill_logits": logits,
              **{f"prefill_{k}": v for k, v in cache.items()}}
    nt, cl, vt, vcl = _step_inputs()
    logits, cache = jax.jit(lambda p, b: japi.decode_step(p, cfg, b))(
        qp, {"tokens": jnp.asarray(nt), "cache": cache,
             "cache_len": jnp.asarray(cl)})
    arrays["decode_logits"] = logits
    logits, cache = jax.jit(lambda p, b: japi.verify_step(p, cfg, b))(
        qp, {"tokens": jnp.asarray(vt), "cache": cache,
             "cache_len": jnp.asarray(vcl)})
    arrays["verify_logits"] = logits
    arrays.update({f"verified_{k}": v for k, v in cache.items()})
    tp.save_arrays(out_dir, **arrays)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return tp.run_reference("test_torch_vlm",
                            tmp_path_factory.mktemp("jax_vlm_reference"))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _positions3(B, S, seed=4):
    """Three unequal (t, h, w) rows: t counts up, h and w walk a grid."""
    rng = np.random.default_rng(seed)
    t = np.broadcast_to(np.arange(S), (B, S))
    h = rng.integers(0, 8, (B, S))
    w = rng.integers(0, 8, (B, S))
    return np.stack([t, h, w]).astype(np.int32)


def test_mrope_angles_unequal_rows():
    jcfg, tcfg = _cfg(jax_get_arch), _cfg(get_arch)
    pos = _positions3(3, 11)
    assert not (pos[0] == pos[1]).all() and not (pos[1] == pos[2]).all()
    hd = tcfg.resolved_head_dim
    cj, sj = jlayers.mrope_angles(jnp.asarray(pos), hd, jcfg.rope_theta,
                                  jcfg.mrope_sections)
    ct, st = layers.mrope_angles(torch.from_numpy(pos), hd, tcfg.rope_theta,
                                 tcfg.mrope_sections)
    assert tuple(ct.shape) == (3, 11, hd // 2)
    for got, want in ((ct, cj), (st, sj)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2.5e-7, atol=1.2e-7)
    # each band takes its section's row
    plain = layers.rope_angles(torch.from_numpy(pos), hd, tcfg.rope_theta)[0]
    bands = np.repeat(np.arange(3), tcfg.mrope_sections)
    for h, row in enumerate(bands):
        assert torch.equal(ct[..., h], plain[row, ..., h])


def _assert_matches(got, want, what, *, atol=1e-2, rtol=1e-2,
                    min_exact=0.99):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)
    exact = float(np.mean(got == want))
    assert exact >= min_exact, f"{what}: only {exact:.4f} bit-identical"


def _vision_batch(B=2, S=12, seed=5):
    rng = np.random.default_rng(seed)
    d = _cfg(get_arch).d_model
    toks = rng.integers(2, 512, (B, S)).astype(np.int32)
    ex = [_image(seed + i, S, 5 + i, d) for i in range(B)]
    return {"tokens": toks,
            "vision_embeds": np.stack([e["vision_embeds"] for e in ex]),
            "vision_mask": np.stack([e["vision_mask"] for e in ex]),
            "positions": _positions3(B, S)}


def _step_inputs():
    """A decode step's tokens and positions, then a 3-token verify's."""
    return (np.asarray([[5], [7]], np.int32), np.asarray([12, 12], np.int32),
            np.asarray([[9, 3, 4], [2, 8, 6]], np.int32),
            np.asarray([13, 10], np.int32))


def test_prefill_decode_verify_match_reference(reference):
    from repro_torch.models.layers import quantize_dense_params
    tcfg = _cfg(get_arch)
    tpar = quantize_dense_params(reference["params"])
    want = reference["arrays"]
    b = _vision_batch()
    lt, ct = api.prefill(tpar, tcfg, _torch_batch(b), 20)
    _assert_matches(lt, want["prefill_logits"], "prefill logits")
    for name in ct:
        _assert_matches(ct[name], want[f"prefill_{name}"], name)
    # the splice changes the logits: the text-only prefill differs
    lt_text, _ = api.prefill(tpar, tcfg, _torch_batch(
        {"tokens": b["tokens"], "positions": b["positions"]}), 20)
    assert not torch.equal(lt_text, lt)
    nt, cl, vt, vcl = _step_inputs()
    lt, ct = api.decode_step(tpar, tcfg, {
        "tokens": torch.from_numpy(nt).long(), "cache": ct,
        "cache_len": torch.from_numpy(cl)})
    _assert_matches(lt, want["decode_logits"], "decode logits")
    lt, ct = api.verify_step(tpar, tcfg, {
        "tokens": torch.from_numpy(vt).long(), "cache": ct,
        "cache_len": torch.from_numpy(vcl)})
    assert tuple(lt.shape) == (2, 3, tcfg.vocab_padded)
    _assert_matches(lt, want["verify_logits"], "verify logits")
    for name in ct:
        _assert_matches(ct[name], want[f"verified_{name}"], name)


def _torch_batch(b):
    out = {k: torch.from_numpy(v) for k, v in b.items()}
    out["tokens"] = out["tokens"].long()
    if "positions" in out:
        out["positions"] = out["positions"].long()
    return out


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _port_serve(reference, backend):
    prompts, arrivals, extras = _workload()
    eng = _engine(tserving, reference["params"], get_arch, backend,
                  device="cpu")
    loop = eng.make_loop(_requests(tserving, prompts, arrivals), n_slots=2,
                         extras=extras)
    return eng, prompts, loop.run()


@pytest.mark.parametrize("backend", ["slab", "paged"])
def test_serve_with_extras_matches_reference(reference, backend):
    eng, prompts, rep = _port_serve(reference, backend)
    got = tp.summary(rep, REPORT_FIELDS + ("prefix_hit_blocks",))
    want = reference["serve"]["slab"]
    gen = reference["generate"]
    assert want["tokens"] == gen, "the reference's slab serve parts from " \
                                  "its generate()"
    print(f"\n{backend}: port {got['tokens']}\nreference paged "
          f"{reference['serve']['paged']['tokens']} (prefix hits "
          f"{reference['serve']['paged']['report']['prefix_hit_blocks']})")
    assert got["tokens"] == want["tokens"], (
        "token streams differ:\n"
        + tp.flip_report(eng, prompts, got["tokens"], want["tokens"]))
    assert got["finish"] == want["finish"]
    for field in REPORT_FIELDS:
        assert got["report"][field] == want["report"][field], field
    # the two requests with equal tokens and other images part
    assert got["tokens"]["0"] != got["tokens"]["1"]
    if backend == "paged":
        # only the text-only requests share their system prompt's 2 blocks
        assert got["report"]["prefix_hit_blocks"] == 2


def test_reference_paged_trie_fault_is_repaired(reference):
    """The reference's paged serve hands request 1 request 0's blocks:
    its stream parts from its own ``generate()``.  The port's equals it."""
    ref_paged = reference["serve"]["paged"]
    gen = reference["generate"]
    assert ref_paged["tokens"]["1"] != gen["1"]
    assert (ref_paged["report"]["prefix_hit_blocks"]
            > reference["serve"]["slab"]["report"]["prefix_hit_blocks"])
    _, _, rep = _port_serve(reference, "paged")
    assert tp.summary(rep, ())["tokens"] == gen


def test_text_only_requests_share_on_vlm_config(reference):
    prompts, arrivals, _ = _workload()
    eng = _engine(tserving, reference["params"], get_arch, "paged",
                  device="cpu")
    rep = eng.serve(_requests(tserving, prompts[3:], arrivals[3:]),
                    n_slots=2)
    assert rep.prefix_hit_blocks == 2
    got = tp.summary(rep, ())["tokens"]
    assert [got[str(i)] for i in range(2)] == [reference["generate"][str(i)]
                                               for i in (3, 4)]


@pytest.mark.parametrize("case", ["positions", "mixed", "chunked"])
def test_extras_refusals(reference, case):
    prompts, arrivals, extras = _workload()
    scfg = tserving.ServeConfig(max_new_tokens=2,
                                prefill_chunk=16 if case == "chunked"
                                else None)
    eng = tserving.ServingEngine(_cfg(get_arch), reference["params"], scfg,
                                 device="cpu")
    reqs = [tserving.Request(prompt=prompts[0].copy(), max_new_tokens=2,
                             request_id=i) for i in range(2)]
    if case == "chunked":
        with pytest.raises(ValueError, match="chunked prefill"):
            eng.make_loop(reqs, extras={0: extras[0]})
        return
    if case == "positions":
        ex = {i: dict(extras[0], positions=_positions3(1, 40)[:, 0])
              for i in range(2)}
        with pytest.raises(NotImplementedError, match="positions"):
            eng.serve(reqs, n_slots=2, extras=ex)
        return
    with pytest.raises(ValueError, match="mixes requests"):
        eng.serve(reqs, n_slots=2, extras={0: extras[0]})
