"""Shared plumbing of the serving parity tests that hold the PyTorch port
against the JAX package (``test_torch_speculative.py``,
``test_torch_chunked_prefill.py``, ``test_torch_vlm.py``,
``test_torch_hybrid.py``, ``test_torch_encdec.py``).

The reference engine runs jitted in a subprocess started with
``XLA_FLAGS=--xla_allow_excess_precision=false``, so that every bf16
operation rounds as the program says and as PyTorch's eager operations do
(``test_torch_serving.py`` gives the reason).  The subprocess writes its
summaries as JSON and its weights (``api.init`` with ``PRNGKey(0)``) as
.npz; the port gets the same weights through
``repro_torch.convert.params_from_numpy``.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import torch

from repro_torch.convert import params_from_numpy

HERE = pathlib.Path(__file__).resolve().parent
SMALL = dict(num_layers=2, d_model=64, d_ff=128, vocab_size=128, head_dim=16)


def tokens(seed, shape):
    return np.random.default_rng(seed).integers(
        2, SMALL["vocab_size"], shape).astype(np.int32)


def save_reference(out_dir, summaries: dict, params) -> None:
    """Write the reference's summaries and weights (called in the
    subprocess)."""
    import jax
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    summaries = dict(summaries, dtypes={
        "/".join(str(k.key) for k in path): str(leaf.dtype)
        for path, leaf in flat})
    np.savez(pathlib.Path(out_dir) / "params.npz", **{
        "/".join(str(k.key) for k in path): np.asarray(leaf, np.float32)
        for path, leaf in flat})
    (pathlib.Path(out_dir) / "reference.json").write_text(
        json.dumps(summaries))


def run_reference(module: str, out_dir: pathlib.Path) -> dict:
    """Run ``module.write_reference(out_dir)`` in a subprocess and load what
    it wrote: the summaries, with ``params`` the port's parameter tree (on
    the CPU, each leaf in the reference's dtype) and, where the subprocess
    wrote them (:func:`save_arrays`), ``arrays`` its named float32 arrays."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_allow_excess_precision=false").strip(),
               PYTHONPATH=os.pathsep.join(
                   [str(HERE.parent / "src"), str(HERE),
                    os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, "-c",
         f"import {module} as t; t.write_reference({str(out_dir)!r})"],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    ref = json.loads((out_dir / "reference.json").read_text())
    tree = {}
    with np.load(out_dir / "params.npz") as z:
        for path in z.files:
            *parents, name = path.split("/")
            node = tree
            for k in parents:
                node = node.setdefault(k, {})
            node[name] = z[path]

    def cast(node, path=""):
        if isinstance(node, dict):
            return {k: cast(v, f"{path}/{k}".lstrip("/"))
                    for k, v in node.items()}
        return node.to(getattr(torch, ref["dtypes"][path]))

    ref["params"] = cast(params_from_numpy(tree, device="cpu"))
    arrays = out_dir / "arrays.npz"
    if arrays.exists():
        with np.load(arrays) as z:
            ref["arrays"] = {k: z[k] for k in z.files}
    return ref


def save_arrays(out_dir, **arrays) -> None:
    """Write named arrays of the reference (bf16 ones widened to float32,
    exactly) for :func:`run_reference` to hand back."""
    np.savez(pathlib.Path(out_dir) / "arrays.npz",
             **{k: np.asarray(v).astype(np.float32)
                if np.asarray(v).dtype.name == "bfloat16" else np.asarray(v)
                for k, v in arrays.items()})


def summary(report, fields) -> dict:
    """Per-request tokens and finish reasons, and the report's ``fields``
    (JSON-ready on both sides)."""
    return {"tokens": {str(r.request_id): np.asarray(r.tokens).tolist()
                       for r in report.results},
            "finish": {str(r.request_id): r.finish_reason
                       for r in report.results},
            "report": {f: getattr(report, f) for f in fields}}


def flip_report(engine, prompts, got, want) -> str:
    """One line per differing stream: where it parts, both tokens, and the
    top-2 margin of the port's logits there (prompt plus the shared prefix,
    one fresh prefill), so a flip at a near-tie shows as one."""
    lines = []
    for rid in sorted(want, key=int):
        g, w = got.get(rid, []), want[rid]
        if g == w:
            continue
        j = next((k for k in range(min(len(g), len(w))) if g[k] != w[k]),
                 min(len(g), len(w)))
        seq = np.concatenate([np.asarray(prompts[int(rid)], np.int32),
                              np.asarray(w[:j], np.int32)])
        logits, _ = engine.executor.prefill({"tokens": seq[None]},
                                            len(seq) + 1)
        top = torch.topk(logits[0].float(), 2)
        lines.append(
            f"request {rid}: first differs at token {j} (port {g[j:j + 1]}, "
            f"reference {w[j:j + 1]}); port top-2 {top.indices.tolist()} "
            f"margin {float(top.values[0] - top.values[1]):.6g}")
    return "\n".join(lines)
