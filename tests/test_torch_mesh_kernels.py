"""Mesh serving's kernels and specs in the PyTorch port against the JAX
package, on meshes of ``cpu`` shards (one controller, as on the card).

  * K2s, the paged-attention kernel's state variant: its plain version
    (``paged_attention_state_plain``, what the wrapper runs for CPU tensors
    and what the CUDA kernel is held against on the card) against the
    reference's ``paged_attention_kernel(..., interpret=True,
    return_state=True)`` on the ragged shapes of
    ``test_kernel_paged_attention.py``, on negative lengths and on all-trash
    tables, within 1e-5; a masked row's m is exactly -0.7 FLT_MAX.
  * The sharded paged attention on the four cases of
    ``test_mesh_kernels.py::test_mesh_paged_attention_kernel_parity`` (split
    KV, a ragged page count, B % 4 != 0) on meshes (2, 4), (1, 2) and
    (1, 4), against the reference's gather oracle ``paged_attention_xla``
    within rtol 1e-5, atol 1e-6.  The reference's own sharded kernel
    cannot run on this JAX (its ``shard_map`` over an abstract mesh raises),
    so the oracle stands in for it, as that test meant.
  * ``_matmul_strategy`` equal to the reference's on that file's five
    matmul shapes, and ``bp_matmul_sharded`` bit-identical to the
    reference's unsharded Pallas kernel in interpret mode on raw int32
    products, for all three strategies and both modes; with scales,
    bit-identical to the port's unsharded matmul and to the reference's
    plain epilogue ``float(acc) * (scale_a * scale_w)``, and within the
    reference kernel's own 1e-6 (it rounds ``(acc * scale_a) * scale_w``).
  * ``param_specs`` and ``cache_pspecs`` equal to the reference's, leaf by
    leaf, on the reduced qwen2 and granite-moe trees and a (2, 4) mesh.

Inputs are made with numpy from fixed seeds and handed to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jax_get_arch
from repro.core import bp_matmul as jbpm
from repro.distributed import sharding as jshd
from repro.kernels.bitparticle_matmul import ops as jbp_ops
from repro.kernels.paged_attention.kernel import paged_attention_kernel
from repro.kernels.paged_attention.ref import paged_attention_xla
from repro.models import api as japi
from repro_torch.configs.base import get_arch
from repro_torch.distributed import sharding
from repro_torch.kernels.bitparticle_matmul import ops as bp_ops
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.kernels.paged_attention import ref as pa_ref
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import api

NEG_INF_F32 = np.float32(-0.7 * np.finfo(np.float32).max)
TOL = dict(atol=1e-5, rtol=1e-5)

RAGGED = [
    # B, H, KH, D, n_blocks, bs, pages_per_seq, T_hi
    (1, 2, 1, 8, 6, 4, 4, 16),
    (3, 4, 2, 16, 12, 4, 5, 20),
    (5, 6, 3, 32, 20, 8, 3, 24),
    (2, 8, 8, 16, 10, 2, 7, 14),     # MHA (G = 1), tiny blocks
    (4, 4, 1, 64, 16, 16, 2, 32),    # MQA-style, one kv head
]
# the reference's mesh cases: B, H, KH, D, bs, P (P % 4 == 0: KV split)
MESH_CASES = [(4, 4, 2, 16, 4, 8),
              (4, 8, 4, 16, 2, 12),
              (4, 4, 2, 16, 4, 5),     # ragged page count: no KV split
              (6, 2, 2, 8, 4, 4)]      # B % 2 == 0 but B % 4 != 0
MESHES = [(2, 4), (1, 2), (1, 4)]
# (B, S, K, N) and the reference's strategy on a (2, 4) mesh
MATMUL_CASES = [((4, 1, 33, 128), "col"),
                ((4, 4, 33, 128), "col"),
                ((4, 1, 128, 130), "splitk"),
                ((4, 4, 128, 130), "splitk"),
                ((5, 1, 33, 17), "rep")]
AXES = {"data": 2, "model": 4}


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _mesh(shape):
    return make_local_mesh(*shape, devices=["cpu"] * (shape[0] * shape[1]))


def _ragged_case(seed, B, H, KH, D, n_blocks, bs, pps, T_hi):
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


def _state_cases():
    cases = {f"ragged{i}": _ragged_case(100 + i, *c)
             for i, c in enumerate(RAGGED)}
    # a far shard's rebased lengths: negative, so every position is masked;
    # one row keeps valid positions beside them
    q, kp, vp, bt, _ = _ragged_case(7, 4, 4, 2, 16, 12, 4, 3, 12)
    cases["negative lengths"] = (q, kp, vp, bt,
                                 np.asarray([-5, -1, -12, 6], np.int32))
    q, kp, vp, bt, _ = _ragged_case(8, 3, 6, 3, 32, 10, 8, 4, 30)
    cases["all-trash tables"] = (q, kp, vp, np.zeros_like(bt),
                                 np.asarray([0, -3, 17], np.int32))
    return cases


STATE_CASES = _state_cases()


@pytest.mark.parametrize("name", list(STATE_CASES))
def test_state_plain_matches_reference_interpret_kernel(name):
    q, kp, vp, bt, lens = STATE_CASES[name]
    want = paged_attention_kernel(*[jnp.asarray(a) for a in
                                    (q, kp, vp, bt, lens)],
                                  interpret=True, return_state=True)
    got = pa_ops.paged_attention_state(*_t(q, kp, vp, bt, lens))
    for g, w, label in zip(got, want, ("acc", "m", "l")):
        g, w = g.numpy(), np.asarray(w)
        assert g.dtype == np.float32 and g.shape == w.shape, label
        np.testing.assert_allclose(g, w, err_msg=label, **TOL)
    acc, m, l = (t.numpy() for t in got)
    masked = lens < 0
    assert (m[masked] == NEG_INF_F32).all()
    assert (np.asarray(want[1])[masked] == NEG_INF_F32).all()
    assert (l[masked] == 0).all() and (acc[masked] == 0).all()
    assert np.isfinite(acc).all() and np.isfinite(m).all()


def test_state_normalizes_to_the_output():
    """acc / l is the plain attention output wherever a position is
    valid, so the state variant is the same walk without its epilogue."""
    q, kp, vp, bt, lens = STATE_CASES["ragged1"]
    acc, _, l = pa_ref.paged_attention_state_plain(*_t(q, kp, vp, bt, lens))
    out = pa_ref.paged_attention_plain(*_t(q, kp, vp, bt, lens))
    np.testing.assert_allclose((acc / l).reshape(out.shape).numpy(),
                               out.numpy(), **TOL)


def _mesh_case(seed, B, H, KH, D, bs, P):
    rng = np.random.default_rng(seed)
    N = P * B + 1
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kp = rng.standard_normal((N, bs, KH, D)).astype(np.float32)
    vp = rng.standard_normal((N, bs, KH, D)).astype(np.float32)
    bt = rng.integers(1, N, size=(B, P)).astype(np.int32)
    ln = rng.integers(0, P * bs, size=(B,)).astype(np.int32)
    ln[0] = 0                      # only the just-written token valid
    return q, kp, vp, bt, ln


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("case", MESH_CASES, ids=lambda c: "B{}H{}KH{}D{}"
                         "bs{}P{}".format(*c))
def test_sharded_paged_attention_matches_oracle(case, shape, monkeypatch):
    B, H, KH, D, bs, P = case
    q, kp, vp, bt, ln = _mesh_case(sum(case), *case)
    want = np.asarray(paged_attention_xla(
        *[jnp.asarray(a) for a in (q, kp, vp, bt, ln)]))
    calls = []
    state = pa_ops.paged_attention_state

    def spy(q_s, *args, **kw):
        calls.append((q_s.shape[0], args[2].shape[1], int(args[3].min())))
        return state(q_s, *args, **kw)

    monkeypatch.setattr(pa_ops, "paged_attention_state", spy)
    got = pa_ops.paged_attention(*_t(q, kp, vp, bt, ln), mesh=_mesh(shape))
    assert got.shape == (B, H, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    data, model = shape
    n_data = data if B % data == 0 else 1
    if model > 1 and P % model == 0:
        # one state call per (data shard, model shard) on its table slice,
        # with lengths rebased: the last shard's first row is negative
        assert len(calls) == n_data * model
        assert {c[:2] for c in calls} == {(B // n_data, P // model)}
        assert calls[model - 1][2] < 0
    else:
        assert not calls


@pytest.mark.parametrize("case", MATMUL_CASES,
                         ids=lambda c: "B{}S{}K{}N{}".format(*c[0]))
def test_matmul_strategy_matches_reference(case):
    (b, s, k, n), want = case
    for axes in (AXES, {"data": 1, "model": 2}, {"data": 8, "model": 1}):
        got = bp_ops._matmul_strategy([b, s], k, n, axes)
        assert got == jbp_ops._matmul_strategy([b, s], k, n, axes)
    assert bp_ops._matmul_strategy([b, s], k, n, AXES)[1] == want


@pytest.mark.parametrize("approx", [False, True], ids=["exact", "approx"])
@pytest.mark.parametrize("case", MATMUL_CASES,
                         ids=lambda c: "{}-B{}S{}K{}N{}".format(c[1], *c[0]))
def test_bp_matmul_sharded_bit_identical(case, approx):
    (b, s, k, n), strategy = case
    rng = np.random.default_rng(b * 1000 + s * 100 + n)
    xq = rng.integers(-127, 128, size=(b, s, k)).astype(np.int8)
    wq = rng.integers(-127, 128, size=(k, n)).astype(np.int8)
    sa = rng.random((b, s, 1)).astype(np.float32)
    sw = rng.random((n,)).astype(np.float32)
    xt, wt, sat, swt = _t(xq, wq, sa, sw)
    w_placed = bp_ops.place_weight(bp_ops.kmajor(wt), swt, _mesh((2, 4)))
    assert w_placed.strategy == strategy
    mode = "bp_approx" if approx else "bp_exact"

    # raw int32 products: bit-identical to the reference's Pallas kernel
    got_int = bp_ops.bp_matmul_sharded(xt, w_placed, approx=approx)
    want_int = np.asarray(jbp_ops.bp_matmul(jnp.asarray(xq), jnp.asarray(wq),
                                            approx=approx, interpret=True))
    assert got_int.dtype == torch.int32
    np.testing.assert_array_equal(got_int.numpy(), want_int)

    # the fused epilogue: the unsharded wrapper's bits, the reference's
    # plain epilogue's bits, and its kernel's within its own 1e-6
    got = bp_ops.bp_matmul_sharded(xt, w_placed, sat, approx=approx)
    single = bp_ops.bp_matmul(xt, bp_ops.kmajor(wt), sat, swt, approx=approx)
    np.testing.assert_array_equal(got.numpy(), single.numpy())
    acc = jbpm.bp_matmul_int(jnp.asarray(xq), jnp.asarray(wq), mode)
    want_plain = np.asarray(acc.astype(jnp.float32)
                            * (jnp.asarray(sa) * jnp.asarray(sw)))
    np.testing.assert_array_equal(got.numpy(), want_plain)
    want_kernel = np.asarray(jbp_ops.bp_matmul(
        jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(sa), jnp.asarray(sw),
        approx=approx, interpret=True))
    np.testing.assert_allclose(got.numpy(), want_kernel, rtol=1e-6)


def _tree_pairs(a, b, path=()):
    if isinstance(a, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            yield from _tree_pairs(a[k], b[k], path + (k,))
    else:
        yield path, a, b


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "granite-moe-1b-a400m"])
def test_param_specs_match_reference(arch):
    jcfg = jax_get_arch(arch).reduced()
    jparams = jax.eval_shape(lambda: japi.init(jax.random.PRNGKey(0), jcfg))
    want = jshd.param_specs(jparams, "decode", AXES)
    params = api.init(get_arch(arch).reduced(), device="cpu")
    got = api.param_pspecs(params, AXES)
    pairs = list(_tree_pairs(got, jax.tree.map(
        tuple, want, is_leaf=lambda x: isinstance(x, jax.sharding
                                                  .PartitionSpec))))
    assert len(pairs) > 10
    for path, g, w in pairs:
        assert g == w, (path, g, w)
    # the executor's placement cuts columns exactly where the serve
    # recipe splits a weight's last dim (every other weight is whole, or
    # cut along K by the matmul's split-K)
    mesh = _mesh((2, 4))
    for path, spec, leaf in _tree_pairs(got, params):
        if path[-1] == "w":
            k, n = leaf.shape[-2:]
            placed = bp_ops.place_weight(bp_ops.kmajor(leaf.to(torch.int8)),
                                         torch.ones(leaf.shape[:-2] + (n,)),
                                         mesh)
            assert (placed.strategy == "col") == (spec[-1] == "model"), path


@pytest.mark.parametrize("arch,int8kv", [("qwen2-1.5b", False),
                                         ("qwen2-1.5b", True),
                                         ("rwkv6-7b", False),
                                         ("zamba2-2.7b", False),
                                         ("seamless-m4t-medium", False)])
def test_cache_pspecs_match_reference(arch, int8kv):
    jcfg = jax_get_arch(arch).reduced().replace(kv_cache_int8=int8kv)
    cfg = get_arch(arch).reduced().replace(kv_cache_int8=int8kv)
    want = japi.cache_pspecs(jcfg, 4, 64, AXES)
    got = api.cache_pspecs(cfg, 4, 64, AXES)
    for name, spec in want.items():
        assert got[name] == tuple(spec), (name, got[name], spec)
    paged = api.cache_pspec_tree(cfg, api.zeros_cache(cfg, 2, 8, "cpu"),
                                 AXES, paged=True)
    assert all(s == (None,) * len(s) for s in paged.values())


def test_combine_softmax_state_of_neutral_shards_is_zero():
    acc = torch.zeros(2, 1, 3, 4)
    m = torch.full((2, 1, 3, 1), float(NEG_INF_F32))
    l = torch.zeros(2, 1, 3, 1)
    out = sharding.combine_softmax_state([acc, acc], [m, m], [l, l])
    assert torch.equal(out, torch.zeros_like(acc))
    parts = [torch.tensor([2 ** 30, -5], dtype=torch.int32),
             torch.tensor([2 ** 30 - 1, 7], dtype=torch.int32)]
    total = sharding.combine_matmul_partials(parts)
    assert total.dtype == torch.int32
    assert total.tolist() == [2 ** 31 - 1, 2]
