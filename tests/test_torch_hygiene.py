"""Hygiene of the PyTorch port: it stands alone, defaults to the GPU, and
refuses what it does not implement yet.

  * every module of ``repro_torch`` imports in a process whose import hook
    blocks ``jax`` and ``repro``, and no source file of the package (nor
    ``chip_smoke.py``) names either in an import statement;
  * the entry points default to ``device="cuda"`` and raise where CUDA is
    absent, instead of running on the CPU unasked;
  * every ``ServeConfig`` feature that is not ported (mesh serving) raises
    ``NotImplementedError`` when the engine is built, and what is ported
    (the paged store, speculative decoding, chunked prefill, the sparsity
    probe, the telemetry sinks, fault injection) builds and serves on the
    CPU;
  * the kernel wrappers refuse what their kernels do not take instead of
    falling back;
  * ``chip_smoke.py`` exits nonzero and prints no result without a GPU or
    outside a checkout.
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
from repro_torch.models import api

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
                 "repro_torch.serving.frontdoor.client"):
        assert name in walked, name


def _imported_roots(path: pathlib.Path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize(
    "path", sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax_or_repro(path):
    # statically, so that imports inside functions are caught too
    assert not _imported_roots(path) & set(FORBIDDEN)


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")


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
    ("mesh_shape", (1, 2), "not ported"),
    ("probe", serving.SparsityProbe(probe_every=1, n_mc=2000), "serves"),
    ("faults", serving.FaultInjector(schedule=[("step", 0)]), "serves"),
])
def test_serve_features_build_or_raise(field, value, outcome):
    cfg = _small_cfg(matmul_mode="bp_exact", kv_cache_int8=True)
    params = api.init(cfg, device="cpu")
    scfg = serving.ServeConfig(max_new_tokens=3, **{field: value})
    if outcome == "not ported":
        with pytest.raises(NotImplementedError, match=outcome):
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
    """Unported families raise; the telemetry sinks, ported now, write a
    metrics file that parses back into the served records."""
    with pytest.raises(NotImplementedError, match="not ported"):
        get_arch("zamba2-2.7b")
    with pytest.raises(NotImplementedError, match="not ported"):
        api.init(_small_cfg(family="moe"), device="cpu")
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
    # the bp_* modes take weights quantized once, not float weights
    cfg = _small_cfg(matmul_mode="bp_exact")
    tokens = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(NotImplementedError, match="quantize the weights"):
        api.prefill(api.init(cfg, device="cpu"), cfg, {"tokens": tokens}, 8)


def test_chip_smoke_refuses_to_run_without_gpu_or_checkout(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
