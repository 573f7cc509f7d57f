"""Hygiene of the PyTorch port: it stands alone, defaults to the GPU, and
refuses what it does not implement yet.

  * every module of ``repro_torch`` imports in a process whose import hook
    blocks ``jax`` and ``repro``, and no source file of the package (nor
    ``chip_smoke.py``) names either in an import statement;
  * the entry points, the examples of ``examples_torch/`` among them,
    default to ``device="cuda"`` and raise where CUDA is absent, instead of
    running on the CPU unasked; no example imports ``jax`` or ``repro``;
  * every ``ServeConfig`` feature (the paged store, speculative decoding,
    chunked prefill, the sparsity probe, the telemetry sinks, fault
    injection) builds and serves on the CPU, but a ``mesh_shape``, whose
    default shards are CUDA devices: without a GPU the engine refuses it
    instead of running the mesh on the CPU;
  * the kernel wrappers refuse what their kernels do not take instead of
    falling back;
  * ``chip_smoke.py`` exits nonzero and prints no result without a GPU or
    outside a checkout;
  * the dry run (``launch/dryrun.py``) never initializes CUDA: it runs on
    the meta device, from its command line too.
"""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

from repro_torch import serving
from repro_torch.configs.base import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.models import api, layers

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")

BLOCKED_IMPORT = r"""
import importlib.abc, pkgutil, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {forbidden!r}:
            raise ImportError(f"blocked import of {{name}}")
        return None

sys.meta_path.insert(0, Block())
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    __import__(name)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in {forbidden!r})
assert not leaked, leaked
print(" ".join(names))
print(len(names))
"""


def _small_cfg(**kw):
    return get_arch("qwen2-1.5b").reduced().replace(
        num_layers=1, d_model=32, d_ff=64, vocab_size=64, head_dim=8, **kw)


def test_every_module_imports_with_jax_and_repro_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", BLOCKED_IMPORT.format(forbidden=FORBIDDEN)],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert int(proc.stdout.split()[-1]) >= 20   # every module was walked
    walked = set(proc.stdout.split()[:-1])
    for name in ("repro_torch.kernels.wkv6.ops",
                 "repro_torch.kernels.wkv6.ref",
                 "repro_torch.kernels.wkv6.build", "repro_torch.models.rwkv6",
                 "repro_torch.models.rwkv_model",
                 "repro_torch.configs.rwkv6_7b",
                 "repro_torch.core.bitparticle", "repro_torch.core.sparsity",
                 "repro_torch.core.cost_model", "repro_torch.core.array_sim",
                 "repro_torch.core.dataflow", "repro_torch.core.probe",
                 "repro_torch.serving.probe",
                 "repro_torch.serving.telemetry",
                 "repro_torch.serving.faults",
                 "repro_torch.serving.frontdoor",
                 "repro_torch.serving.frontdoor.replica",
                 "repro_torch.serving.frontdoor.router",
                 "repro_torch.serving.frontdoor.server",
                 "repro_torch.serving.frontdoor.client",
                 "repro_torch.models.mamba2",
                 "repro_torch.models.zamba_model",
                 "repro_torch.models.encdec",
                 "repro_torch.configs.qwen2_vl_7b",
                 "repro_torch.configs.zamba2_2_7b",
                 "repro_torch.configs.seamless_m4t_medium",
                 "repro_torch.models.remat", "repro_torch.tree",
                 "repro_torch.train.optimizer",
                 "repro_torch.train.train_loop",
                 "repro_torch.data.pipeline",
                 "repro_torch.checkpoint.checkpoint",
                 "repro_torch.runtime.fault_tolerance",
                 "repro_torch.distributed.compression",
                 "repro_torch.distributed.quasi_sync",
                 "repro_torch.distributed.pipeline",
                 "repro_torch.distributed.sharding",
                 "repro_torch.runtime.elastic",
                 "repro_torch.launch.dryrun",
                 "repro_torch.launch.op_analysis",
                 "repro_torch.launch.mesh",
                 "repro_torch.configs.cnn_zoo"):
        assert name in walked, name


def _imported_roots(path: pathlib.Path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


EXAMPLES = sorted((ROOT / "examples_torch").glob("*.py"))


@pytest.mark.parametrize(
    "path", sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"] + EXAMPLES,
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax_or_repro(path):
    # statically, so that imports inside functions are caught too
    assert not _imported_roots(path) & set(FORBIDDEN)


def test_dryrun_never_initializes_cuda(monkeypatch, tmp_path):
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh

    def refuse(*args, **kwargs):
        raise AssertionError("the dry run touched CUDA")

    for name in ("_lazy_init", "init", "current_device", "device_count",
                 "is_available", "synchronize"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    mesh = make_mesh((2, 4), ("data", "model"), "meta")
    cfg = get_arch("qwen2-1.5b").reduced()
    for kind in ("train", "prefill", "decode"):
        rec = dryrun.run_cell("qwen2-1.5b", ShapeConfig(kind, 64, 32, kind),
                              out_dir=None, verbose=False, mesh=mesh,
                              cfg=cfg, variant="" if kind == "train"
                              else "int8")
        assert rec["ok"], rec.get("traceback")
        assert rec["n_devices"] == 8
    # the command line, on a full-size cell of the production mesh
    with pytest.raises(SystemExit) as done:
        dryrun.main(["--arch", "qwen2-1.5b", "--shape", "decode_32k",
                     "--out", str(tmp_path)])
    assert done.value.code == 0
    assert (tmp_path / "qwen2-1.5b__decode_32k__pod16x16.json").exists()
    assert not torch.cuda.is_initialized()


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")


@pytest.mark.parametrize("path", EXAMPLES, ids=lambda p: p.name)
def test_examples_default_to_cuda_and_raise_without_it(no_cuda, path,
                                                        tmp_path,
                                                        monkeypatch):
    """Each example's ``main`` with no ``--device`` asks for CUDA and raises
    where it is absent, before any work."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(f"example_{path.stem}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    monkeypatch.setitem(sys.modules, spec.name, mod)   # for its dataclasses
    spec.loader.exec_module(mod)
    argv = (["--ckpt-dir", str(tmp_path / "ck")] if path.stem == "train_lm"
            else [])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main(argv)
    assert mod.build_parser().parse_args(argv).device == "cuda"
    assert not (tmp_path / "ck").exists()


def test_entry_points_default_to_cuda_and_raise_without_it(no_cuda):
    cfg = _small_cfg()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.init(cfg)
    params = api.init(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serving.ServingEngine(cfg, params)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serving.SingleDeviceExecutor(cfg, params)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_from_numpy({"w": params["final_norm"]["scale"].numpy()})
    engine = serving.ServingEngine(cfg, params, device="cpu")
    assert engine.device.type == "cpu"


@pytest.mark.parametrize("field,value,outcome", [
    ("draft", "prompt_lookup", "serves"),
    ("draft", "model", "needs a draft model"),
    ("prefill_chunk", 16, "serves"),
    ("mesh_shape", (1, 2), "needs 2 CUDA devices"),
    ("probe", serving.SparsityProbe(probe_every=1, n_mc=2000), "serves"),
    ("faults", serving.FaultInjector(schedule=[("step", 0)]), "serves"),
])
def test_serve_features_build_or_raise(field, value, outcome):
    cfg = _small_cfg(matmul_mode="bp_exact", kv_cache_int8=True)
    params = api.init(cfg, device="cpu")
    scfg = serving.ServeConfig(max_new_tokens=3, **{field: value})
    if field == "mesh_shape":
        if torch.cuda.is_available():
            pytest.skip("checks the behaviour on a machine without CUDA")
        with pytest.raises(ValueError, match=outcome):
            serving.ServingEngine(cfg, params, scfg, device="cpu")
        return
    engine = serving.ServingEngine(cfg, params, scfg, device="cpu")
    # two 20-token prompts: longer than the 16-token chunk
    reqs = [serving.Request(prompt=torch.arange(2, 22, dtype=torch.int32)
                            .numpy() + i, max_new_tokens=3)
            for i in range(2)]
    if outcome != "serves":
        with pytest.raises(ValueError, match=outcome):
            engine.serve(reqs, n_slots=2)
        return
    rep = engine.serve(reqs, n_slots=2)
    assert [len(r.tokens) for r in rep.results] == [3, 3]
    assert rep.draft == scfg.draft
    assert rep.chunk_tokens == (8 if field == "prefill_chunk" else 0)
    # a probed serve samples its prefill and each of its 2 decode steps
    assert (rep.hw_measured is not None and rep.hw_measured["n_samples"]
            == 3) == (field == "probe")
    # the injector's one scheduled step fault is retried once
    assert rep.n_retries == rep.n_injected_faults == (field == "faults")


@pytest.mark.parametrize("int8kv", [False, True], ids=["bf16kv", "int8kv"])
def test_paged_backend_builds_and_serves_on_cpu(int8kv):
    cfg = _small_cfg(matmul_mode="bp_exact", kv_cache_int8=int8kv)
    params = api.init(cfg, device="cpu")
    engine = serving.ServingEngine(
        cfg, params, serving.ServeConfig(cache_backend="paged", block_size=4,
                                         max_new_tokens=3), device="cpu")
    prompts = [torch.arange(2, 9, dtype=torch.int32).numpy()] * 2
    rep = engine.serve([serving.Request(prompt=p, max_new_tokens=3)
                        for p in prompts], n_slots=2)
    assert rep.cache_backend == "paged"
    assert [len(r.tokens) for r in rep.results] == [3, 3]
    assert rep.prefix_hit_blocks > 0          # the shared prompt's block


def test_make_cache_manager_rejects_unknown_backend():
    cfg = _small_cfg()
    with pytest.raises(ValueError, match="unknown cache_backend"):
        serving.make_cache_manager(
            cfg, 2, 8, backend="bogus",
            executor=serving.SingleDeviceExecutor(cfg, device="cpu"))


@pytest.mark.parametrize("case", ["cpu_tensors", "int8_scale_pages"])
def test_paged_attention_kernel_backend_refuses(case):
    q = torch.zeros(2, 4, 8)
    pages = torch.zeros(5, 4, 2, 8)
    tables = torch.zeros(2, 3, dtype=torch.int32)
    lengths = torch.zeros(2, dtype=torch.int32)
    kw = {}
    match = "needs CUDA tensors"
    if case == "int8_scale_pages":
        pages = pages.to(torch.int8)
        kw = dict(k_scale_pages=torch.ones(5, 4, 2),
                  v_scale_pages=torch.ones(5, 4, 2))
        match = "float pages only"
    with pytest.raises(ValueError, match=match):
        pa_ops.paged_attention(q, pages, pages, tables, lengths,
                               backend="kernel", **kw)
    with pytest.raises(ValueError, match="unknown paged-attention backend"):
        pa_ops.paged_attention(q, pages, pages, tables, lengths,
                               backend="xla", **kw)


def test_unported_families_and_sinks_raise(tmp_path):
    """Every architecture of ``ARCH_IDS`` is ported and returned; a family
    outside them raises; the telemetry sinks write a metrics file that
    parses back into the served records; float weights in a bp_* mode are
    quantized on every call, as weights quantized once are."""
    from repro_torch.configs.base import ARCH_IDS, PORTED_ARCHS
    assert set(PORTED_ARCHS) == set(ARCH_IDS)
    for name in ARCH_IDS:
        assert get_arch(name).name == name
    with pytest.raises(ValueError, match="unknown architecture"):
        get_arch("retnet-7b")
    with pytest.raises(NotImplementedError, match="not ported"):
        api.init(_small_cfg(family="retnet"), device="cpu")
    cfg = _small_cfg(matmul_mode="bp_exact")
    path = tmp_path / "metrics.jsonl"
    with serving.Telemetry(metrics_path=str(path)) as tel:
        engine = serving.ServingEngine(
            cfg, api.init(cfg, device="cpu"),
            serving.ServeConfig(max_new_tokens=2, telemetry=tel),
            device="cpu")
        engine.serve([serving.Request(
            prompt=torch.arange(2, 8, dtype=torch.int32).numpy(),
            max_new_tokens=2)], n_slots=1)
    kinds = [r["kind"] for r in serving.read_jsonl(str(path))]
    assert kinds == ["run", "prefill", "decode", "request"]
    # the bp_* modes take float weights too (training's path): quantized
    # on every call, they give what weights quantized once give
    cfg = _small_cfg(matmul_mode="bp_exact")
    tokens = torch.arange(2, 6, dtype=torch.long)[None]
    params = api.init(cfg, device="cpu")
    got, _ = api.prefill(params, cfg, {"tokens": tokens}, 8)
    want, _ = api.prefill(layers.quantize_dense_params(params), cfg,
                          {"tokens": tokens}, 8)
    assert torch.equal(got, want)


def test_chip_smoke_refuses_to_run_without_gpu_or_checkout(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
