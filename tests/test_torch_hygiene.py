"""Hygiene of the PyTorch port: it stands alone, defaults to the GPU, and
refuses what it does not implement yet.

  * every module of ``repro_torch`` imports in a process whose import hook
    blocks ``jax`` and ``repro``, and no source file of the package (nor
    ``chip_smoke.py``) names either in an import statement;
  * the entry points default to ``device="cuda"`` and raise where CUDA is
    absent, instead of running on the CPU unasked;
  * every ``ServeConfig`` feature that is not ported raises
    ``NotImplementedError`` when the engine is built;
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


@pytest.mark.parametrize("field,value", [
    ("cache_backend", "paged"),
    ("draft", "prompt_lookup"),
    ("draft", "model"),
    ("prefill_chunk", 16),
    ("mesh_shape", (1, 2)),
    ("probe", object()),
    ("faults", object()),
])
def test_unported_serve_features_raise(field, value):
    cfg = _small_cfg(matmul_mode="bp_exact", kv_cache_int8=True)
    params = api.init(cfg, device="cpu")
    scfg = serving.ServeConfig(**{field: value})
    with pytest.raises(NotImplementedError, match="not ported"):
        serving.ServingEngine(cfg, params, scfg, device="cpu")


def test_unported_families_and_sinks_raise():
    with pytest.raises(NotImplementedError, match="not ported"):
        get_arch("rwkv6-7b")
    with pytest.raises(NotImplementedError, match="not ported"):
        api.init(_small_cfg(family="moe"), device="cpu")
    with pytest.raises(NotImplementedError, match="not ported"):
        serving.Telemetry(metrics_path="metrics.jsonl")
    with pytest.raises(NotImplementedError, match="not ported"):
        serving.make_cache_manager(_small_cfg(), 2, 8, backend="paged",
                                   executor=None)
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
