"""The workload shapes, the dry run and its op counter in the PyTorch port
(``repro_torch.configs.base``, ``models/api.py::input_specs /
model_flops``, ``launch/op_analysis.py``, ``launch/dryrun.py``) against
the JAX package's.

  * ``runnable_cells()``, ``param_count`` (full and active),
    ``is_attention_free``, ``sub_quadratic`` and ``model_flops`` equal to
    the reference's for every architecture and runnable cell, exactly;
    ``input_specs`` of every cell with the reference's shapes and dtypes.
  * ``op_analysis`` on a reduced dense model: a forward, and a loss with
    its backward, equal the closed form (the backward 2 x the forward for
    every product; recomputation adds one forward of the layers); a CPU
    run and a meta run of one step count the same.
  * One meta dry-run cell of each kind (train, prefill, decode) on a
    (2, 4) meta mesh: the argument bytes exactly the placed shards',
    the work of the (1, 1) cell, split where the mesh splits it, the
    cross-shard traffic counted; the reduced granite-moe-1b-a400m train
    cell at 4 x 128 tokens on (2, 4) (``test_multidevice.py``'s dry-run
    cell); the record's keys the reference's.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import base as jbase
from repro.models import api as japi
from repro_torch.configs import base as tbase
from repro_torch.configs.base import ShapeConfig, get_arch
from repro_torch.distributed import sharding
from repro_torch.launch import dryrun, op_analysis
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import api

_DTYPES = {jnp.int32: torch.int32, jnp.bfloat16: torch.bfloat16,
           jnp.float32: torch.float32, jnp.int8: torch.int8,
           jnp.bool_: torch.bool}


def test_shapes_and_cells_equal_reference():
    assert list(tbase.runnable_cells()) == list(jbase.runnable_cells())
    assert {k: dataclasses.asdict(v) for k, v in tbase.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jbase.SHAPES.items()}
    for aid in jbase.ARCH_IDS:
        j, t = jbase.get_arch(aid), tbase.get_arch(aid)
        for cfg_j, cfg_t in ((j, t), (j.reduced(), t.reduced())):
            assert cfg_t.param_count() == cfg_j.param_count(), aid
            assert cfg_t.param_count(active_only=True) == \
                cfg_j.param_count(active_only=True), aid
            assert cfg_t.is_attention_free == cfg_j.is_attention_free
            assert cfg_t.sub_quadratic == cfg_j.sub_quadratic
        for sname, shape in jbase.SHAPES.items():
            assert tbase.shape_applicable(t, tbase.SHAPES[sname]) == \
                jbase.shape_applicable(j, shape)


@pytest.mark.parametrize("aid", jbase.ARCH_IDS)
def test_model_flops_and_input_specs_equal_reference(aid):
    j, t = jbase.get_arch(aid), tbase.get_arch(aid)
    for _, sname in (c for c in jbase.runnable_cells() if c[0] == aid):
        jshape, tshape = jbase.SHAPES[sname], tbase.SHAPES[sname]
        assert api.model_flops(t, tshape) == japi.model_flops(j, jshape)
        want = jax.tree_util.tree_flatten_with_path(
            japi.input_specs(j, jshape))[0]
        got = dict(_flat(api.input_specs(t, tshape)))
        # the audio family's cache has the port's cross_len leaf beside
        # the reference's (models/encdec.py)
        extra = {"cache/cross_len"} if (
            t.family == "audio" and tshape.kind == "decode") else set()
        assert len(got) == len(want) + len(extra)
        assert extra <= set(got)
        for path, spec in want:
            key = "/".join(str(getattr(k, "key", k)) for k in path)
            leaf = got[key]
            assert tuple(leaf.shape) == tuple(spec.shape), (sname, key)
            assert leaf.dtype == _DTYPES[spec.dtype.type], (sname, key)
            assert leaf.device.type == "meta"


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], path + (k,))
    else:
        yield "/".join(path), tree


def _closed_form_forward(cfg, B, S):
    """Dot FLOPs of the dense causal LM's forward (every layer's seven
    projections and attention over S keys, the tied unembedding)."""
    d, hd, H, KH = cfg.d_model, cfg.resolved_head_dim, cfg.num_heads, \
        cfg.num_kv_heads
    N = B * S
    proj = 2 * N * d * (H * hd + 2 * KH * hd) + 2 * N * H * hd * d \
        + 3 * 2 * N * d * cfg.d_ff
    attn = 2 * 2 * B * S * S * H * hd
    return cfg.num_layers * (proj + attn), 2 * N * d * cfg.vocab_padded


def test_op_analysis_closed_form():
    cfg = get_arch("qwen2-1.5b").reduced()
    B, S = 2, 32
    params = api.init(cfg, seed=0, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (B, S), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(0))
    layers_f, head_f = _closed_form_forward(cfg, B, S)
    with torch.no_grad(), op_analysis.OpAnalysis() as oa:
        api.prefill(params, cfg, {"tokens": tokens}, S)
    # prefill unembeds the last position only
    assert oa.result()["dot_flops_per_device"] == layers_f + head_f / S
    flat = [t for _, t in _flat(params) if t.is_floating_point()]
    for remat, extra in ((False, 0), (True, layers_f)):
        with op_analysis.OpAnalysis() as oa:
            for t in flat:
                t.requires_grad_(True)
            loss, _ = api.loss_fn(params, cfg, {"tokens": tokens},
                                  remat=remat)
            torch.autograd.grad(loss, flat, allow_unused=True)
        res = oa.result()
        assert res["dot_flops_per_device"] == \
            3 * (layers_f + head_f) + extra, remat
        assert res["dot_flops_int_per_device"] == 0
        assert res["while_loops"] == 0
        assert res["peak_bytes_per_device"] > 0


def test_bp_matmul_counted_once_at_its_wrapper():
    """K1's plain version (three products in approx mode) counts as one
    kernel call, int, whether its ops run or not."""
    from repro_torch.kernels.bitparticle_matmul import ops as bp
    a = torch.randint(-127, 128, (6, 64), dtype=torch.int8)
    w = torch.randint(-127, 128, (64, 24), dtype=torch.int8)
    for approx, n in ((False, 1), (True, 3)):
        with op_analysis.OpAnalysis() as oa:
            bp.bp_matmul(a, w, approx=approx)
        res = oa.result()
        assert res["dot_flops_int_per_device"] == n * 2.0 * 6 * 24 * 64
        assert res["dot_flops_per_device"] == 0
        assert res["kernel_calls"] == {"bp_matmul": 1}


def _placed_bytes(tree, mesh):
    """{mesh index: bytes} of a cell's arguments, counted here from the
    placed shards directly."""
    out = {}

    def rec(node):
        if isinstance(node, dict):
            for v in node.values():
                rec(v)
        elif isinstance(node, sharding.Placed):
            for idx, t in node.shards.items():
                out[idx] = out.get(idx, 0) + t.numel() * t.element_size()
        elif isinstance(node, torch.Tensor):
            home = (0,) * mesh.devices.ndim
            out[home] = out.get(home, 0) + node.numel() * node.element_size()
    rec(tree)
    return out


REF_KEYS = {"arch", "shape", "mesh", "base_arch", "variant", "ok", "recipe",
            "lower_s", "compile_s", "n_devices", "xla_cost_flops_per_device",
            "xla_cost_bytes_per_device", "dot_flops_per_device",
            "dot_flops_int_per_device", "while_loops", "memory_analysis",
            "collective_bytes", "collective_counts", "top_collectives",
            "model_flops_global", "total_s"}


def test_meta_cells_of_each_kind(tmp_path):
    cfg = get_arch("qwen2-1.5b").reduced()
    wide = make_mesh((2, 4), ("data", "model"), "meta")
    one = make_mesh((1, 1), ("data", "model"), "meta")
    recs = {}
    for kind, variant in (("train", ""), ("prefill", "int8"),
                          ("decode", "int8")):
        shape = ShapeConfig(kind, 64, 4, kind)
        for mesh in (one, wide):
            rec = dryrun.run_cell("qwen2-1.5b", shape, out_dir=str(tmp_path),
                                  verbose=False, variant=variant, mesh=mesh,
                                  cfg=cfg)
            assert rec["ok"], rec.get("traceback")
            recs[kind, mesh.size] = rec
        cell = dryrun.build_cell("qwen2-1.5b", shape, wide, variant, cfg=cfg)
        if kind == "train":
            want = max(_placed_bytes(cell.arguments, wide).values())
            assert recs[kind, 8]["memory_analysis"]["argument_size"] == want
    # train: the work of one controller on the home shard, the FSDP
    # gather and gradient cut counted
    t1, t8 = recs["train", 1], recs["train", 8]
    assert t8["dot_flops_per_device"] == t1["dot_flops_per_device"] > 0
    assert t8["collective_counts"]["all-gather"] > 0
    assert t8["collective_counts"]["reduce-scatter"] == \
        t8["collective_counts"]["all-gather"]
    assert t1["collective_counts"]["all-gather"] == 0
    assert t8["memory_analysis"]["argument_size"] < \
        t1["memory_analysis"]["argument_size"]
    # serving: K1 once per shard, the same int work split over the shards
    for kind in ("prefill", "decode"):
        r1, r8 = recs[kind, 1], recs[kind, 8]
        assert r8["dot_flops_int_per_device"] < r1["dot_flops_int_per_device"]
        assert r8["kernel_calls"]["bp_matmul"] > \
            r1["kernel_calls"]["bp_matmul"]
        assert sum(r8["collective_counts"].values()) > 0
        assert r8["recipe"] == ("train" if kind == "prefill" else "decode")
    files = sorted(p.name for p in tmp_path.iterdir())
    assert "qwen2-1.5b@int8__decode__mesh2x4.json" in files
    rec = json.loads((tmp_path / files[0]).read_text())
    assert REF_KEYS <= set(rec)


def test_meta_and_cpu_runs_count_alike():
    cfg = get_arch("qwen2-1.5b").reduced().replace(matmul_mode="bp_exact")
    shape = ShapeConfig("t", 32, 2, "train")
    recs = [dryrun.run_cell("qwen2-1.5b", shape, out_dir=None, verbose=False,
                            mesh=make_mesh((1, 1), ("data", "model"), dev),
                            cfg=cfg) for dev in ("meta", "cpu")]
    assert all(r["ok"] for r in recs)
    for key in ("dot_flops_per_device", "dot_flops_int_per_device",
                "kernel_calls", "collective_bytes"):
        assert recs[0][key] == recs[1][key], key
    assert recs[0]["dot_flops_int_per_device"] > 0
    assert recs[0]["memory_analysis"]["argument_size"] == \
        recs[1]["memory_analysis"]["argument_size"]


def test_reduced_moe_train_cell_on_2x4():
    """``test_multidevice.py::test_dryrun_cell_on_virtual_devices``'s
    cell: the reduced granite-moe-1b-a400m, 4 x 128 tokens, (2, 4)."""
    cfg = get_arch("granite-moe-1b-a400m").reduced()
    mesh = make_mesh((2, 4), ("data", "model"), "meta")
    rec = dryrun.run_cell("granite-moe-1b-a400m",
                          ShapeConfig("mini", 128, 4, "train"), out_dir=None,
                          verbose=False, mesh=mesh, cfg=cfg)
    assert rec["ok"], rec.get("traceback")
    assert rec["dot_flops_per_device"] > 0
    assert rec["memory_analysis"]["peak_memory"] > \
        rec["memory_analysis"]["argument_size"] > 0
    assert rec["n_devices"] == 8 and rec["while_loops"] == 0
    assert rec["model_flops_global"] == 6.0 * cfg.param_count(
        active_only=True) * 4 * 128


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_reduced_vlm_cell_on_meta(kind):
    """M-RoPE builds on meta: ``mrope_angles``' ``repeat_interleave`` is
    given its output size, so the qwen2-vl cells run on the meta device."""
    cfg = get_arch("qwen2-vl-7b").reduced()
    rec = dryrun.run_cell("qwen2-vl-7b", ShapeConfig(kind, 32, 2, kind),
                          out_dir=None, verbose=False,
                          mesh=make_mesh((1, 1), ("data", "model"), "meta"),
                          cfg=cfg)
    assert rec["ok"], rec.get("traceback")
    assert rec["controller"] == "single"
    assert rec["dot_flops_per_device"] > 0


def test_mrope_angles_unchanged_on_cpu():
    """The meta fix leaves the values bit for bit: each band takes its
    section's row of ``rope_angles``, as without the output size, and
    stays within a float32 unit of the reference."""
    from repro.models import layers as jlayers
    from repro_torch.models import layers
    import numpy as np
    cfg = get_arch("qwen2-vl-7b").reduced()
    hd, sec = cfg.resolved_head_dim, cfg.mrope_sections
    rng = np.random.default_rng(0)
    pos = np.stack([np.broadcast_to(np.arange(11), (2, 11)),
                    rng.integers(0, 8, (2, 11)),
                    rng.integers(0, 8, (2, 11))]).astype(np.int32)
    got = layers.mrope_angles(torch.from_numpy(pos), hd, cfg.rope_theta, sec)
    cos, sin = layers.rope_angles(torch.from_numpy(pos), hd, cfg.rope_theta)
    sec_id = torch.repeat_interleave(torch.arange(3), torch.tensor(sec))
    band = torch.arange(hd // 2)
    for g, full in zip(got, (cos, sin)):
        assert torch.equal(g, full[sec_id, ..., band].movedim(0, -1))
    want = jlayers.mrope_angles(jnp.asarray(pos), hd, cfg.rope_theta, sec)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2.5e-7,
                                   atol=1.2e-7)


def test_single_controller_accounting_on_2x2():
    """A reduced train cell on a (2, 2) meta mesh names its accounting:
    ``per_shard`` holds every index, its argument bytes sum to the placed
    state's, and the home shard's dot FLOPs are the record's per-device
    figure (one controller runs the step there)."""
    cfg = get_arch("qwen2-1.5b").reduced()
    mesh = make_mesh((2, 2), ("data", "model"), "meta")
    shape = ShapeConfig("train", 32, 2, "train")
    rec = dryrun.run_cell("qwen2-1.5b", shape, out_dir=None, verbose=False,
                          mesh=mesh, cfg=cfg)
    assert rec["ok"], rec.get("traceback")
    assert rec["controller"] == "single"
    per = rec["per_shard"]
    assert sorted(per) == ["0,0", "0,1", "1,0", "1,1"]
    placed = _placed_bytes(dryrun.build_cell("qwen2-1.5b", shape, mesh,
                                             cfg=cfg).arguments, mesh)
    assert sum(s["argument_bytes"] for s in per.values()) == \
        sum(placed.values())
    for idx, n in placed.items():
        assert per[",".join(map(str, idx))]["argument_bytes"] == n
    assert per["0,0"]["dot_flops"] == rec["dot_flops_per_device"] > 0
    assert per["0,0"]["peak_bytes"] == rec["memory_analysis"]["peak_memory"]
    assert all(s["dot_flops"] < per["0,0"]["dot_flops"]
               for k, s in per.items() if k != "0,0")
