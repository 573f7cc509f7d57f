"""The paged store's model code in the PyTorch port against the JAX package.

  * The plain version of the paged-attention decode kernel (what the port
    runs on the CPU, and what the CUDA kernel is held against on the card)
    against the reference's Pallas kernel in interpret mode and its gather
    oracle, on the ragged shapes of ``test_kernel_paged_attention.py``, the
    int8-scale case and the length-0 all-trash case, within 1e-5 (that
    test's own tolerance).  Its bitwise assertion between the oracle and
    the dense decode attention is not carried over: it fails on the
    reference itself, so the storage identity is held to the same 1e-5.
  * ``paged_write_kv`` and ``paged_insert`` bit-exact against the
    reference's scatters.
  * ``decode_step_paged`` / ``verify_step_paged`` against the reference run
    op by op, as ``test_torch_model.py`` holds the slab steps.

Inputs are made with numpy from a seed and handed to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jax_get_arch
from repro.kernels.paged_attention.kernel import paged_attention_kernel
from repro.kernels.paged_attention.ref import paged_attention_xla
from repro.models import api as japi
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro_torch.configs.base import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.kernels.paged_attention import ops, ref
from repro_torch.models import api, attention, layers

RAGGED = [
    # B, H, KH, D, n_blocks, bs, pages_per_seq, T_hi
    (1, 2, 1, 8, 6, 4, 4, 16),
    (3, 4, 2, 16, 12, 4, 5, 20),
    (5, 6, 3, 32, 20, 8, 3, 24),
    (2, 8, 8, 16, 10, 2, 7, 14),     # MHA (G = 1), tiny blocks
    (4, 4, 1, 64, 16, 16, 2, 32),    # MQA-style, one kv head
]
TOL = dict(atol=1e-5, rtol=1e-5)


def _case(seed, B, H, KH, D, n_blocks, bs, pps, T_hi):
    """Random pages + a random block table/lengths per sequence (unused
    table entries point at the trash page 0), as numpy arrays."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kp = rng.standard_normal((n_blocks, bs, KH, D)).astype(np.float32)
    vp = rng.standard_normal((n_blocks, bs, KH, D)).astype(np.float32)
    bt = np.zeros((B, pps), np.int32)
    lengths = np.zeros(B, np.int32)
    for b in range(B):
        lengths[b] = rng.integers(0, T_hi)
        n_used = lengths[b] // bs + 1
        bt[b, :n_used] = rng.choice(np.arange(1, n_blocks), size=n_used,
                                    replace=False)
    return q, kp, vp, bt, lengths


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _port(q, kp, vp, bt, lens, **kw):
    return ops.paged_attention(*_t(q, kp, vp, bt, lens), **kw).numpy()


@pytest.mark.parametrize("B,H,KH,D,n_blocks,bs,pps,T_hi", RAGGED)
@pytest.mark.parametrize("against", ["interpret_kernel", "gather_oracle"])
def test_plain_matches_reference(B, H, KH, D, n_blocks, bs, pps, T_hi,
                                 against):
    q, kp, vp, bt, lens = _case(B * 1000 + H * 100 + KH * 10 + D, B, H, KH,
                                D, n_blocks, bs, pps, T_hi)
    args = [jnp.asarray(a) for a in (q, kp, vp, bt, lens)]
    if against == "interpret_kernel":
        want = paged_attention_kernel(*args, interpret=True)
    else:
        want = paged_attention_xla(*args)
    got = _port(q, kp, vp, bt, lens)
    assert got.shape == (B, H, D)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_int8_scale_pages_match_reference():
    B, H, KH, D, n_blocks, bs, pps = 2, 4, 2, 16, 10, 4, 4
    q, kp, vp, bt, lens = _case(5, B, H, KH, D, n_blocks, bs, pps, 14)
    rng = np.random.default_rng(6)
    kq = np.round(np.clip(kp * 20, -127, 127)).astype(np.int8)
    vq = np.round(np.clip(vp * 20, -127, 127)).astype(np.int8)
    ks = (np.abs(rng.standard_normal((n_blocks, bs, KH))) + 0.01).astype(
        np.float32)
    vs = (np.abs(rng.standard_normal((n_blocks, bs, KH))) + 0.01).astype(
        np.float32)
    want = paged_attention_xla(*[jnp.asarray(a) for a in (q, kq, vq, bt,
                                                           lens)],
                               k_scale_pages=jnp.asarray(ks),
                               v_scale_pages=jnp.asarray(vs))
    ks_t, vs_t = _t(ks, vs)
    got = _port(q, kq, vq, bt, lens, k_scale_pages=ks_t, v_scale_pages=vs_t)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    # the storage transform: the slab decode attention over the gathered
    # pages gives the same output
    g = [ref.gather_pages(p, torch.from_numpy(bt)) for p in _t(kq, vq, ks,
                                                               vs)]
    dense = attention.decode_attention(
        torch.from_numpy(q)[:, None], g[0], g[1], torch.from_numpy(lens),
        k_scale=g[2], v_scale=g[3])[:, 0]
    np.testing.assert_allclose(got, dense.numpy(), **TOL)


def test_length_zero_all_trash_row_is_finite_and_matches():
    B, H, KH, D, n_blocks, bs, pps = 2, 2, 1, 8, 6, 4, 3
    q, kp, vp, _, _ = _case(31, B, H, KH, D, n_blocks, bs, pps, 10)
    bt = np.zeros((B, pps), np.int32)
    lens = np.zeros(B, np.int32)
    got = _port(q, kp, vp, bt, lens)
    assert np.isfinite(got).all()
    want = paged_attention_kernel(*[jnp.asarray(a) for a in (q, kp, vp, bt,
                                                              lens)],
                                  interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_plain_backend_and_int64_lengths():
    # the engine hands int64 positions; 'plain' is the same function
    q, kp, vp, bt, lens = _case(21, 3, 6, 3, 32, 12, 8, 3, 20)
    want = _port(q, kp, vp, bt, lens)
    got = ops.paged_attention(*_t(q, kp, vp, bt),
                              torch.from_numpy(lens.astype(np.int64)),
                              backend="plain").numpy()
    np.testing.assert_array_equal(got, want)
    ops.reset_launches()
    _port(q, kp, vp, bt, lens)
    assert ops.LAUNCHES["paged_attention"] == 0      # CPU: plain version
    assert ops.ROUTED_PLAIN["int8_kv"] == 0


# ---------------------------------------------------------------------------
# the paged scatters
# ---------------------------------------------------------------------------

def test_paged_write_kv_bit_exact():
    rng = np.random.default_rng(3)
    pages = rng.standard_normal((6, 4, 2, 8)).astype(np.float32)
    new = rng.standard_normal((3, 2, 2, 8)).astype(np.float32)
    blk = np.asarray([[1, 1], [4, 5], [2, 3]], np.int32)
    off = np.asarray([[2, 3], [3, 0], [0, 1]], np.int32)
    want = jattn.paged_write_kv(jnp.asarray(pages), jnp.asarray(new),
                                jnp.asarray(blk), jnp.asarray(off))
    got = attention.paged_write_kv(torch.from_numpy(pages.copy()),
                                   torch.from_numpy(new),
                                   torch.from_numpy(blk).long(),
                                   torch.from_numpy(off).long())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _cfgs(mode="bf16", int8kv=False):
    kw = dict(num_layers=2, d_model=64, d_ff=128, vocab_size=128,
              head_dim=16, matmul_mode=mode, kv_cache_int8=int8kv)
    return (jax_get_arch("qwen2-1.5b").reduced().replace(**kw),
            get_arch("qwen2-1.5b").reduced().replace(**kw))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


@pytest.mark.parametrize("int8kv", [False, True], ids=["bf16kv", "int8kv"])
def test_paged_insert_bit_exact(int8kv):
    jcfg, tcfg = _cfgs(int8kv=int8kv)
    rng = np.random.default_rng(4)
    src = {name: rng.standard_normal(shape).astype(np.float32) * 30
           for name, (shape, _) in api.cache_specs(tcfg, 2, 12).items()}
    # logical block 0 is a prefix hit (trash-redirected), 1 and 2 are fresh
    ids = np.asarray([0, 5, 2], np.int32)
    jp = japi.zeros_paged_cache(jcfg, 7, 4)
    jsrc = {k: jnp.asarray(v).astype(jp[k].dtype) for k, v in src.items()}
    want = japi.paged_insert(jcfg, jp, jsrc, jnp.asarray(ids), 1)
    tp = api.zeros_paged_cache(tcfg, 7, 4, "cpu")
    tsrc = {k: torch.from_numpy(v).to(tp[k].dtype) for k, v in src.items()}
    got = api.paged_insert(tcfg, tp, tsrc, torch.from_numpy(ids), 1)
    assert got is tp                                   # in place
    for name in want:
        # page 0 is the trash page: duplicate writes land there in any order
        np.testing.assert_array_equal(_np(got[name])[:, 1:],
                                      _np(want[name])[:, 1:])


# ---------------------------------------------------------------------------
# decode / verify over paged KV, op by op against the reference
# ---------------------------------------------------------------------------

MODES = [("bf16", False), ("bp_exact", False), ("bp_exact", True)]
MODE_IDS = ["bf16", "bp_exact-bf16kv", "bp_exact-int8kv"]
BS, P = 4, 4                     # 4 blocks of 4 per sequence, T = 16


@pytest.fixture(scope="module")
def jax_params():
    cfg, _ = _cfgs()
    return japi.init(jax.random.PRNGKey(0), cfg)


def _paged_state(jax_params, mode, int8kv):
    """Both packages' params and a 12-block page pool holding three
    prefilled sequences at scattered pages."""
    jcfg, tcfg = _cfgs(mode, int8kv)
    jp = jax_params
    if mode != "bf16":
        jp = jlayers.quantize_dense_params(jp)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    toks = np.random.default_rng(2).integers(2, 128, (3, 8)).astype(np.int32)
    with jax.disable_jit():
        _, cj = japi.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, BS * P)
    _, ct = api.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks).long()},
                        BS * P)
    tables = np.asarray([[3, 7, 0, 0], [1, 9, 4, 0], [11, 2, 0, 0]],
                        np.int32)
    jpages = japi.zeros_paged_cache(jcfg, 12, BS)
    tpages = api.zeros_paged_cache(tcfg, 12, BS, "cpu")
    for b in range(3):
        ids = tables[b].copy()
        jpages = japi.paged_insert(jcfg, jpages, cj, jnp.asarray(ids), b)
        api.paged_insert(tcfg, tpages, ct, torch.from_numpy(ids), b)
    return jcfg, tcfg, jp, tp, jpages, tpages, tables


def _assert_close(got, want, what, *, min_exact=0.99):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    atol = 1 if got.dtype == np.int8 else 1e-2
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=atol, err_msg=what)
    exact = float(np.mean(got == want))
    assert exact >= min_exact, f"{what}: only {exact:.4f} bit-identical"


@pytest.mark.parametrize("mode,int8kv", MODES, ids=MODE_IDS)
def test_decode_step_paged_matches_op_by_op(jax_params, mode, int8kv):
    jcfg, tcfg, jp, tp, jpages, tpages, tables = _paged_state(
        jax_params, mode, int8kv)
    nt = np.asarray([[5], [7], [9]], np.int32)
    cl = np.asarray([8, 8, 7], np.int32)
    with jax.disable_jit():
        lj, cj = japi.decode_step_paged(
            jp, jcfg, {"tokens": jnp.asarray(nt), "cache": jpages,
                       "cache_len": jnp.asarray(cl),
                       "block_tables": jnp.asarray(tables)})
    lt, ct = api.decode_step_paged(
        tp, tcfg, {"tokens": torch.from_numpy(nt).long(), "cache": tpages,
                   "cache_len": torch.from_numpy(cl).long(),
                   "block_tables": torch.from_numpy(tables)})
    assert tuple(lt.shape) == (3, 256) and ct is tpages
    _assert_close(lt, lj, "logits")
    for name in cj:
        _assert_close(ct[name][:, 1:], cj[name][:, 1:], name)


@pytest.mark.parametrize("mode,int8kv", MODES, ids=MODE_IDS)
def test_verify_step_paged_matches_op_by_op(jax_params, mode, int8kv):
    jcfg, tcfg, jp, tp, jpages, tpages, tables = _paged_state(
        jax_params, mode, int8kv)
    nt = np.random.default_rng(5).integers(2, 128, (3, 3)).astype(np.int32)
    cl = np.asarray([8, 14, 7], np.int32)   # slot 1 overhangs its table
    with jax.disable_jit():
        lj, cj = japi.verify_step_paged(
            jp, jcfg, {"tokens": jnp.asarray(nt), "cache": jpages,
                       "cache_len": jnp.asarray(cl),
                       "block_tables": jnp.asarray(tables)})
    lt, ct = api.verify_step_paged(
        tp, tcfg, {"tokens": torch.from_numpy(nt).long(), "cache": tpages,
                   "cache_len": torch.from_numpy(cl).long(),
                   "block_tables": torch.from_numpy(tables)})
    assert tuple(lt.shape) == (3, 3, 256)
    _assert_close(lt, lj, "logits")
    for name in cj:
        _assert_close(ct[name][:, 1:], cj[name][:, 1:], name)


def test_paged_decode_equals_slab_decode_on_the_same_content():
    """Block paging is a storage transform inside the port: the paged decode
    step over scattered pages gives the slab step's logits."""
    _, cfg = _cfgs("bp_exact", False)
    params = layers.quantize_dense_params(api.init(cfg, seed=1,
                                                   device="cpu"))
    toks = torch.from_numpy(np.random.default_rng(9).integers(
        2, 128, (2, 6)).astype(np.int64))
    _, slab = api.prefill(params, cfg, {"tokens": toks}, BS * P)
    pages = api.zeros_paged_cache(cfg, 9, BS, "cpu")
    tables = np.asarray([[4, 1, 0, 0], [8, 3, 6, 0]], np.int32)
    for b in range(2):
        api.paged_insert(cfg, pages, slab, torch.from_numpy(tables[b]), b)
    nt = torch.tensor([[3], [11]])
    cl = torch.tensor([6, 6])
    ls, _ = api.decode_step(params, cfg, {"tokens": nt, "cache": slab,
                                          "cache_len": cl})
    lp, _ = api.decode_step_paged(params, cfg, {
        "tokens": nt, "cache": pages, "cache_len": cl,
        "block_tables": torch.from_numpy(tables)})
    np.testing.assert_allclose(lp.float().numpy(), ls.float().numpy(),
                               rtol=1e-2, atol=1e-2)
    assert torch.equal(lp.argmax(-1), ls.argmax(-1))
