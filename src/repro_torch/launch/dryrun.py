"""Dry run: every (architecture x shape) cell on the production mesh, on
the meta device, with no card (port of ``repro/launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--out DIR]

Per cell this writes ``experiments/dryrun_torch/<arch>__<shape>__<mesh>.json``
with the reference's record keys:

  * ``memory_analysis``: the busiest shard's bytes.  ``argument_size`` is
    the placed state's bytes on that shard, exactly; ``peak_memory`` the
    high-water mark of live bytes (``op_analysis``); ``temp_size`` their
    difference;
  * dot FLOPs (float and int) of the busiest shard, cross-shard traffic by
    kind, and MODEL_FLOPS (``models/api.py::model_flops``).

The reference's ``*_per_device`` keys and ``memory_analysis`` mean one
device's share of an SPMD program.  Here they mean the busiest shard under
ONE controller (``"controller": "single"`` in every record): the home
shard runs everything that is not a sharded kernel call, so on a mesh
wider than one shard they are not a per-device share and nothing should
read them as one (the printout labels them ``/home``).  ``per_shard`` maps
each mesh index (``"i,j"``) to its own dot FLOPs (float and int), argument
bytes and peak bytes, as ``op_analysis`` attributes them.

The reference lowers and compiles a jitted step; the port runs its eager
step once on meta tensors (shapes and dtypes, no storage) under
``launch/op_analysis.py``, so ``lower_s`` is the time to build and place
the state and ``compile_s`` the time of that run.  Full-size parameters,
optimizer state and caches are meta tensors placed on
``make_production_mesh(device="meta")`` by the recipe's specs:

  train    params and AdamW state placed by the train recipe (FSDP x TP).
           The step gathers the params on the home shard (the FSDP
           all-gather), runs the loss and its backward there, cuts the
           gradients back into the shards (the reduce-scatter) and runs
           AdamW shard by shard.  That is what the port's one controller
           does; the batch stays whole on the home shard.
  prefill  the model's prefill (the train recipe, as the reference's);
  decode   one decode step on the slab cache (``decode_long`` at batch 1,
           else ``decode``), the scalar ``cache_len`` handed to every
           slot as the serving executor hands it (per slot).

On a mesh wider than one shard, prefill and decode go through the serving
mesh path (``serving/executor.py::MeshExecutor``): quantized weights
placed over "model" by the serve recipe, K1 once per shard; activations
and caches whole on the home shard.

A cell that fails (a host read on meta, a mesh the serving path refuses)
is recorded with ``ok: false`` and its error, as the reference records
failures.  Nothing here touches CUDA: the dry run needs no card.
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Optional

import torch

from repro_torch.configs.base import (ARCH_IDS, SHAPES, get_arch,
                                      shape_applicable)
from repro_torch.distributed import sharding as shd
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import op_analysis
from repro_torch.models import api, layers
from repro_torch.train import optimizer as opt_lib
from repro_torch.tree import leaf_paths, leaves, unflatten

DEFAULT_OUT = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "experiments", "dryrun_torch")

VARIANTS = ("", "int8", "int8kv", "q8gather")


class Cell:
    """One cell ready to run: ``run()`` executes its step once;
    ``arguments`` is the placed state it starts from."""

    def __init__(self, run, arguments, recipe: str):
        self.run, self.arguments, self.recipe = run, arguments, recipe


def abstract_params(cfg, device="meta"):
    """Full-size parameters as tensors on ``device`` (meta: no storage),
    through the families' own ``init`` with a CPU generator (on meta
    nothing is drawn)."""
    return api.init(cfg, generator=torch.Generator(), device=device)


def _variant_cfg(cfg, variant: str):
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; expected one of "
                         f"{VARIANTS}")
    if variant == "q8gather":
        cfg = cfg.replace(matmul_mode=cfg.matmul_mode + "+q8gather")
    if variant == "int8kv":
        cfg = cfg.replace(kv_cache_int8=True)
    return cfg


def _train_cell(cfg, shape, mesh) -> Cell:
    params = abstract_params(cfg, mesh.home)
    opt = opt_lib.init_state(params)
    # the step counter is read on the host (the lr schedule runs on the
    # CPU), so it is a host scalar here as the card's step reads it back
    step = torch.zeros((), dtype=torch.int32)
    specs = shd.param_specs(params, "train", mesh)
    placed = shd.place_tree(params, "train", mesh, specs)
    placed_opt = {k: shd.place_tree(opt[k], "train", mesh, specs)
                  for k in ("m", "v", "master")}
    del params, opt
    batch = api.input_specs(cfg, shape, device=mesh.home)
    opt_cfg = opt_lib.OptimizerConfig()

    def run():
        with shd.recipe("train"), shd.activate_mesh(mesh):
            whole = shd.gather_tree(placed, "params")
            flat = leaves(whole)
            for p in flat:
                if p.is_floating_point():
                    p.requires_grad_(True)
            trained = [p for p in flat if p.requires_grad]
            with torch.enable_grad():
                loss, _ = api.loss_fn(whole, cfg, batch)
                got = iter(torch.autograd.grad(loss, trained,
                                               allow_unused=True))
            grads = []
            for p in flat:
                g = next(got) if p.requires_grad else None
                grads.append(torch.zeros_like(p) if g is None else g)
            grads = unflatten(whole, grads)
            del whole, flat, trained
            state = {"step": step}
            lr, _, scale = opt_lib.update_metrics(opt_cfg, state, grads)
            bc1, bc2 = opt_lib.bias_corrections(opt_cfg, state)
            m_l, v_l, w_l = (leaves(placed_opt[k])
                             for k in ("m", "v", "master"))
            for (path, g), p, spec, m, v, w in zip(
                    leaf_paths(grads), leaves(placed), leaves(specs),
                    m_l, v_l, w_l):
                g_sh = shd.place(g, spec, mesh, f"grads/{path}",
                                 count="reduce-scatter")
                del g
                for idx, g_i in g_sh.shards.items():
                    with op_analysis.on_shard(idx):
                        opt_lib.adamw_leaf(
                            opt_cfg, path, p.shards[idx], g_i,
                            m.shards[idx], v.shards[idx], w.shards[idx],
                            scale, float(lr), bc1, bc2)
            step.add_(1)
            return loss

    args = {"params": placed, "opt": {**placed_opt, "step": step},
            "batch": batch}
    return Cell(run, args, "train")


def _serve_params(cfg, params, mesh):
    """The serving params: a mesh wider than one shard places them through
    ``MeshExecutor`` (the serve recipe's quantized weights over "model")."""
    if mesh.size == 1:
        return params
    from repro_torch.serving.executor import MeshExecutor
    return MeshExecutor(cfg, params, mesh=mesh)._params


def _serve_cell(cfg, shape, mesh, variant: str) -> Cell:
    params = abstract_params(cfg, mesh.home)
    if variant in ("int8", "int8kv"):
        params = layers.quantize_dense_params(params)
        cfg = cfg.replace(matmul_mode="bp_exact")
    run_params = _serve_params(cfg, params, mesh)
    batch = api.input_specs(cfg, shape, device=mesh.home)
    if shape.kind == "prefill":
        def run():
            with shd.recipe("train"), shd.activate_mesh(mesh):
                with torch.no_grad():
                    return api.prefill(run_params, cfg, batch,
                                       shape.seq_len)
        return Cell(run, {"params": run_params, "batch": batch}, "train")
    recipe = "decode_long" if shape.global_batch == 1 else "decode"
    # the serving executor hands the model one length per slot: the
    # scalar broadcast to every slot (a view, no bytes)
    step_batch = dict(batch, cache_len=batch["cache_len"].expand(
        shape.global_batch))
    if mesh.size > 1:
        step_batch["mesh"] = mesh

    def run():
        with shd.recipe(recipe), shd.activate_mesh(mesh):
            with torch.no_grad():
                return api.decode_step(run_params, cfg, step_batch)
    return Cell(run, {"params": run_params, "batch": batch}, recipe)


def build_cell(arch_id: str, shape, mesh, variant: str = "", cfg=None
               ) -> Cell:
    """The cell of ``arch_id`` (or the given ``cfg``) at ``shape`` (a name
    of ``SHAPES`` or a ``ShapeConfig``) on ``mesh``.

    Variants: ``int8`` serves pre-quantized int8 dense weights
    (bp_exact), ``int8kv`` also an int8 KV cache, ``q8gather`` trains with
    int8-quantized weight gathers (STE)."""
    cfg = _variant_cfg(cfg if cfg is not None else get_arch(arch_id),
                       variant)
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    if shape.kind == "train":
        return _train_cell(cfg, shape, mesh)
    if shape.kind in ("prefill", "decode"):
        return _serve_cell(cfg, shape, mesh, variant)
    raise ValueError(f"unknown shape kind {shape.kind!r}")


def mesh_name(mesh) -> str:
    return "mesh" + "x".join(str(d) for d in mesh.devices.shape)


def run_cell(arch_id: str, shape_name, multi_pod: bool = False,
             out_dir: Optional[str] = DEFAULT_OUT, verbose: bool = True,
             variant: str = "", *, mesh=None, cfg=None) -> dict:
    """Build and run one cell under ``op_analysis`` and write its record
    (``out_dir`` None: write nothing).  ``mesh`` replaces the production
    mesh, ``cfg`` the architecture's config, ``shape_name`` may be a
    ``ShapeConfig``."""
    shape = (SHAPES[shape_name] if isinstance(shape_name, str)
             else shape_name)
    if mesh is None:
        mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod,
                                             device="meta")
        name = "pod2x16x16" if multi_pod else "pod16x16"
    else:
        name = mesh_name(mesh)
    arch_tag = f"{arch_id}@{variant}" if variant else arch_id
    tag = f"{arch_tag}__{shape.name}__{name}"
    base = cfg if cfg is not None else get_arch(arch_id)
    record = {"arch": arch_tag, "shape": shape.name, "mesh": name,
              "base_arch": arch_id, "variant": variant, "ok": False,
              "controller": "single", "device": str(mesh.home)}
    t0 = time.time()
    try:
        cell = build_cell(arch_id, shape, mesh, variant, cfg=cfg)
        t_build = time.time()
        with op_analysis.OpAnalysis(mesh, cell.arguments) as oa:
            out = cell.run()
            del out
        t_run = time.time()
        res = oa.result()
        arg = res["argument_bytes_per_device"]
        peak = res["peak_bytes_per_device"]
        record.update({
            "ok": True,
            "recipe": cell.recipe,
            "lower_s": round(t_build - t0, 2),
            "compile_s": round(t_run - t_build, 2),
            "n_devices": mesh.size,
            # the reference's XLA cost analysis has no counterpart here
            "xla_cost_flops_per_device": None,
            "xla_cost_bytes_per_device": None,
            "dot_flops_per_device": res["dot_flops_per_device"],
            "dot_flops_int_per_device": res["dot_flops_int_per_device"],
            "dot_flops_total": res["dot_flops_total"],
            "dot_flops_int_total": res["dot_flops_int_total"],
            "kernel_calls": res["kernel_calls"],
            "n_ops": res["n_ops"],
            "while_loops": res["while_loops"],
            "memory_analysis": {
                "argument_size": arg,
                "output_size": None,
                "temp_size": peak - arg,
                "generated_code_size": 0,
                "peak_memory": peak,
            },
            "collective_bytes": res["collective_bytes"],
            "collective_counts": res["collective_counts"],
            "top_collectives": res["top_collectives"],
            "model_flops_global": api.model_flops(base, shape),
            "per_shard": res["per_shard"],
        })
    except Exception as e:  # noqa: BLE001 — record failures as artifacts
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-4000:]
    record["total_s"] = round(time.time() - t0, 2)
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, tag + ".json"), "w") as f:
            json.dump(record, f, indent=1)
    if verbose:
        status = "OK " if record["ok"] else "FAIL"
        print(f"[{status}] {tag}  ({record['total_s']}s)", flush=True)
        if record["ok"]:
            ma = record["memory_analysis"]
            per = "home" if mesh.size > 1 else "dev"
            print(f"       dot_flops/{per}="
                  f"{record['dot_flops_per_device']:.3e}"
                  f"  int/{per}={record['dot_flops_int_per_device']:.3e}"
                  f"  peak_mem/{per}={ma['peak_memory'] / 2 ** 30:.2f}GiB  "
                  f"coll_bytes="
                  f"{sum(record['collective_bytes'].values()):.3e}",
                  flush=True)
        else:
            print("       " + record["error"].splitlines()[0], flush=True)
    return record


def all_cells():
    for aid in ARCH_IDS:
        arch = get_arch(aid)
        for sname in SHAPES:
            if shape_applicable(arch, SHAPES[sname]):
                yield aid, sname


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--variant", default="", choices=VARIANTS)
    ap.add_argument("--out", default=os.path.abspath(DEFAULT_OUT))
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    cells = list(all_cells()) if args.all else [(args.arch, args.shape)]
    n_fail = 0
    for aid, sname in cells:
        for mp in meshes:
            name = "pod2x16x16" if mp else "pod16x16"
            arch_tag = f"{aid}@{args.variant}" if args.variant else aid
            path = os.path.join(args.out, f"{arch_tag}__{sname}__{name}.json")
            if args.skip_existing and os.path.exists(path):
                with open(path) as f:
                    if json.load(f).get("ok"):
                        print(f"[SKIP] {arch_tag}__{sname}__{name}",
                              flush=True)
                        continue
            rec = run_cell(aid, sname, mp, args.out, variant=args.variant)
            n_fail += 0 if rec["ok"] else 1
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
