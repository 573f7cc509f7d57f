"""End-to-end serving example on the PyTorch port: a stream of requests with
Poisson arrivals against a small qwen2-family model with BitParticle W8A8
weights and an int8 KV cache, served by the quasi-sync continuous-batching
engine (``repro_torch.serving``), on the GPU by default.

    PYTHONPATH=src python examples_torch/serve_lm.py [--tokens 24] [--requests 8]
    PYTHONPATH=src python examples_torch/serve_lm.py --mode bf16 --lead-window 0
    PYTHONPATH=src python examples_torch/serve_lm.py --mesh 2x2   # shards on one card
    PYTHONPATH=src python examples_torch/serve_lm.py --draft prompt_lookup
    PYTHONPATH=src python examples_torch/serve_lm.py --draft model \\
        --num-draft-tokens 4                  # speculative decoding
    PYTHONPATH=src python examples_torch/serve_lm.py \\
        --metrics run.jsonl --trace trace.json   # observability sinks
    PYTHONPATH=src python examples_torch/serve_lm.py --probe 2 \\
        --metrics run.jsonl   # measured bit-sparsity -> hw_estimate records
    PYTHONPATH=src python examples_torch/serve_lm.py --device cpu   # plain versions

The flags, defaults and report are those of ``examples/serve_lm.py``.  The
prompts come from ``numpy.random.default_rng(1)`` and the output lengths
and arrivals from ``default_rng(0)``; the weights from ``api.init`` with a
``torch.Generator`` seeded 0 (the draft model's 7).  ``jax.random``'s
streams cannot be reproduced here, so the numbers differ from the JAX
example's.  Without CUDA the default ``--device cuda`` raises: nothing
falls back to the CPU, and on the card no kernel falls back to its plain
version.

``main`` is thin over :func:`parse_args`, :func:`model_config`,
:func:`init_params`, :func:`build_engine`, :func:`make_workload`,
:func:`warm_up`, :func:`run` and :func:`print_report`, which take any
width.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import List

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import get_arch
from repro_torch.models import api
from repro_torch.models.layers import quantize_dense_params
from repro_torch.serving import (Request, SchedulerConfig, ServeConfig,
                                 ServingEngine, SparsityProbe, Telemetry,
                                 make_executor, make_serving_mesh)


def _mesh_shape(text: str):
    parts = text.lower().split("x")
    if len(parts) != 2 or not all(p.isdigit() and int(p) > 0 for p in parts):
        raise argparse.ArgumentTypeError(
            f"--mesh expects DATAxMODEL (e.g. 2x4), got {text!r}")
    return tuple(int(p) for p in parts)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0],
                                 allow_abbrev=False)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=24,
                    help="max new tokens per request")
    ap.add_argument("--rate", type=float, default=0.3,
                    help="Poisson arrivals per decode step")
    ap.add_argument("--lead-window", type=int, default=4,
                    help="admission lead window E (0 = sync every step)")
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--mode", default="bp_exact",
                    choices=["bf16", "bp_exact", "bp_approx"])
    ap.add_argument("--cache-backend", default="slab",
                    choices=["slab", "paged"],
                    help="decode-cache store: worst-case slab slots or "
                         "on-demand KV blocks with prefix sharing")
    ap.add_argument("--block-size", type=int, default=16,
                    help="tokens per KV block (paged backend)")
    ap.add_argument("--mesh", default=None, metavar="DxM", type=_mesh_shape,
                    help="serve tensor-parallel over a (data, model) mesh, "
                         "e.g. 2x2, every shard on the one device")
    ap.add_argument("--draft", default="none",
                    choices=["none", "prompt_lookup", "model"],
                    help="speculative decoding drafter: weight-free n-gram "
                         "prompt lookup, or a half-size same-family draft "
                         "model (greedy only: forces temperature 0)")
    ap.add_argument("--num-draft-tokens", type=int, default=4,
                    help="K: draft tokens verified per decode step")
    ap.add_argument("--metrics", default=None, metavar="PATH",
                    help="append one JSONL record per serving step "
                         "(docs/observability.md)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write a Chrome-trace JSON of serving spans; "
                         "load it in https://ui.perfetto.dev")
    ap.add_argument("--profile-dir", default=None, metavar="DIR",
                    help="capture a torch.profiler trace of the serve into "
                         "DIR (view with perfetto)")
    ap.add_argument("--probe", type=int, default=0, metavar="K",
                    help="sample measured activation bit sparsity every "
                         "K-th decode step (0 = off) and fold it through "
                         "the paper's cost models (needs a bp_* --mode); "
                         "emits hw_estimate records when --metrics is set")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without it)")
    return ap


def parse_args(argv=None) -> argparse.Namespace:
    """The flags, with the reference's two adjustments: a drafter forces
    temperature 0, and the probe needs a bp_* mode."""
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.probe > 0 and args.mode == "bf16":
        ap.error("--probe taps int8 operands; use a bp_* --mode")
    if args.draft != "none" and args.temperature > 0:
        print(f"--draft {args.draft}: speculative decoding is greedy-only, "
              f"forcing --temperature 0")
        args.temperature = 0.0
    return args


def model_config():
    """The example's model: reduced qwen2-1.5b, 4 layers of width 256."""
    return get_arch("qwen2-1.5b").reduced().replace(
        num_layers=4, d_model=256, d_ff=512, vocab_size=2048, head_dim=32)


def init_params(cfg, device, seed: int = 0):
    """Random-init weights on ``device`` from a generator seeded ``seed``."""
    dev = resolve_device(device)
    return api.init(cfg, generator=torch.Generator(device=dev).manual_seed(
        seed), device=dev)


def build_engine(cfg, params, args) -> ServingEngine:
    """The engine ``args`` ask for, on ``args.device``: in a bp_* mode the
    dense weights are quantized once here (int8 weights pass through) and
    the KV cache is int8; ``--mesh`` places the weights over a mesh of
    shards on that one device."""
    device = resolve_device(args.device)
    cfg = cfg.replace(matmul_mode=args.mode,
                      kv_cache_int8=args.mode != "bf16")
    if args.mode != "bf16":
        with torch.no_grad():
            params = quantize_dense_params(params)
    draft_cfg = draft_params = None
    if args.draft == "model":
        # a half-size same-family drafter; random-init weights give modest
        # acceptance, the machinery and accounting are what this shows
        draft_cfg = cfg.replace(num_layers=2, d_model=128, d_ff=256,
                                head_dim=32)
        draft_params = init_params(draft_cfg, device, seed=7)
    probe = SparsityProbe(probe_every=args.probe) if args.probe > 0 else None
    scfg = ServeConfig(max_new_tokens=args.tokens,
                       temperature=args.temperature,
                       cache_backend=args.cache_backend,
                       block_size=args.block_size, mesh_shape=args.mesh,
                       draft=args.draft,
                       num_draft_tokens=args.num_draft_tokens, probe=probe)
    executor = None
    if args.mesh is not None:
        mesh = make_serving_mesh(args.mesh,
                                 devices=[device] * (args.mesh[0]
                                                     * args.mesh[1]))
        executor = make_executor(cfg, params, mesh=mesh)
    return ServingEngine(cfg, params, scfg, executor=executor,
                         draft_cfg=draft_cfg, draft_params=draft_params,
                         device=device)


@dataclasses.dataclass
class Workload:
    """The request stream: prompts, output lengths and arrival times (on
    the decode-step clock), and the cache length that fits them."""
    prompts: np.ndarray          # (n, prompt_len) int32
    max_new: np.ndarray          # (n,)
    arrivals: np.ndarray         # (n,) float
    cache_T: int

    def requests(self) -> List[Request]:
        """Fresh requests (a serve consumes them), ids 0..n-1, so that a
        sampled serve draws the same per-request seeds every time."""
        return [Request(prompt=self.prompts[i].copy(),
                        max_new_tokens=int(self.max_new[i]),
                        arrival_time=float(self.arrivals[i]), request_id=i)
                for i in range(len(self.prompts))]


def make_workload(cfg, args) -> Workload:
    """``args.requests`` prompts of ``args.prompt_len`` tokens, output
    lengths in [tokens/4, tokens], Poisson arrivals at ``args.rate`` per
    decode step; the cache fits a prompt, its tokens and the engine's
    default margin."""
    prompts = np.random.default_rng(1).integers(
        2, cfg.vocab_size, (args.requests, args.prompt_len)).astype(np.int32)
    rng = np.random.default_rng(0)
    lo = min(max(1, args.tokens // 4), args.tokens)
    max_new = rng.integers(lo, args.tokens + 1, size=args.requests)
    arrivals = np.cumsum(rng.exponential(1.0 / args.rate, args.requests))
    return Workload(prompts, max_new, arrivals,
                    args.prompt_len + args.tokens + ServeConfig.cache_margin)


def warm_up(engine: ServingEngine, workload: Workload, args) -> None:
    """A two-token serve of the first prompt (allocator, kernel builds),
    which the sinks do not see."""
    engine.serve([Request(prompt=workload.prompts[0].copy(),
                          max_new_tokens=2)],
                 n_slots=args.slots, cache_T=workload.cache_T)


def run(engine: ServingEngine, workload: Workload, args, *,
        warmup: bool = True):
    """:func:`warm_up` (unless ``warmup`` is false), then the measured
    serve of the workload with the sinks ``args`` name.  Returns its
    report and step stream."""
    sched = SchedulerConfig(lead_window=args.lead_window)
    if warmup:
        warm_up(engine, workload, args)
    tel = None
    base_cfg = engine.serve_cfg
    if args.metrics or args.trace or args.profile_dir:
        tel = Telemetry(metrics_path=args.metrics, trace_path=args.trace,
                        profile_dir=args.profile_dir)
        engine.serve_cfg = dataclasses.replace(base_cfg, telemetry=tel)
    try:
        loop = engine.make_loop(workload.requests(), n_slots=args.slots,
                                cache_T=workload.cache_T, sched_cfg=sched)
        report = loop.run()
    finally:
        engine.serve_cfg = base_cfg
        if tel is not None:
            tel.close()
    return report, loop.stream


def print_report(report, args) -> None:
    sinks = [p for p in (args.metrics, args.trace, args.profile_dir) if p]
    if sinks:
        print(f"telemetry: {', '.join(sinks)}")
    print(f"\nserved {args.requests} requests on {args.slots} slots "
          f"(E={args.lead_window}, Poisson rate {args.rate}/step)")
    print(f"prefill: {report.prefill_s*1e3:.1f} ms across "
          f"{report.n_syncs} admission syncs")
    print(f"decode:  {report.steps} batched steps, "
          f"{report.decode_tokens_per_s:.1f} tokens/s, "
          f"{report.slot_utilization*100:.0f}% slot utilization, "
          f"max position divergence {report.max_divergence}")
    if report.cache_backend == "paged":
        print(f"paged:   peak {report.peak_blocks_in_use} blocks in use, "
              f"{report.prefix_hit_blocks} prefix-hit blocks, "
              f"{report.cow_blocks} copy-on-writes, "
              f"{report.n_preemptions} preemptions")
    if report.draft != "none":
        print(f"spec:    drafter={report.draft} "
              f"K={args.num_draft_tokens}: "
              f"{report.accepted_tokens}/{report.drafted_tokens} drafts "
              f"accepted ({report.acceptance_rate*100:.0f}%), "
              f"{report.committed_tokens_per_step:.2f} committed "
              f"tokens/step")
    if report.ttft_wall is not None:
        itl = (f", itl p50 {report.itl_wall['p50']*1e3:.1f} ms "
               f"p99 {report.itl_wall['p99']*1e3:.1f} ms"
               if report.itl_wall else "")
        print(f"latency: ttft p50 {report.ttft_wall['p50']*1e3:.1f} ms "
              f"p99 {report.ttft_wall['p99']*1e3:.1f} ms{itl}")
    for r in report.results[:4]:
        print(f"  req {r.request_id}: {len(r.tokens)} tokens "
              f"(ttft {r.ttft_steps:.0f} steps, "
              f"latency {r.latency_steps:.0f} steps, {r.finish_reason}) "
              f"head: {np.asarray(r.tokens[:8]).tolist()}")

    # ---- BitParticle deployment estimate ----------------------------------
    if report.deployment is not None:
        d = report.deployment
        print(f"\nBitParticle deployment estimate (modeled 45nm array, "
              f"{d['mode']}):")
        print(f"  mean weight bit sparsity (sign-magnitude): "
              f"{d['mean_bit_sparsity']:.3f}")
        print(f"  mean cycles/MAC: {d['mean_cycles_per_mac']:.2f}   "
              f"mean energy/MAC: {d['mean_mac_energy_pj']:.2f} pJ")
        for e in d["per_layer"][:6]:
            name = f"layer {e['layer']}" if e["layer"] >= 0 else "unstacked"
            print(f"    {name}: bs={e['bit_sparsity']:.3f} "
                  f"cycles={e['avg_cycles_per_mac']:.2f} "
                  f"energy={e['mac_energy_pj']:.2f} pJ")

    # ---- measured-traffic hardware estimate (--probe) ---------------------
    if report.hw_measured is not None:
        hw = report.hw_measured
        print(f"\nmeasured-traffic hardware estimate "
              f"({hw['n_samples']} sampled steps, every "
              f"{hw['probe_every']}):")
        print(f"  activation bit sparsity {hw['act_bit_sparsity']:.3f} "
              f"(value {hw['act_value_sparsity']:.3f}), weight bit "
              f"sparsity {hw['weight_bit_sparsity']:.3f}")
        print(f"  modeled array utilization "
              f"{hw['array_utilization']:.3f}")
        for m in sorted(hw["cycles"]):
            print(f"    {m}: {hw['cycles'][m]:.2f} cycles/MAC, "
                  f"{hw['mac_energy_pj'][m]:.2f} pJ/MAC")


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = model_config()
    print(f"arch: qwen2-family reduced ({cfg.param_count()/1e6:.1f}M "
          f"params), mode={args.mode}, device={device}")
    params = init_params(cfg, device)
    if args.mode != "bf16":
        print("weights quantized to int8 (per-channel), KV cache int8")
    engine = build_engine(cfg, params, args)
    if args.mesh is not None:
        print(f"mesh executor: {args.mesh[0]}x{args.mesh[1]} (data, model), "
              f"every shard on {device}: weights TP-sharded, KV cache "
              f"split per the decode recipe")
    report, _ = run(engine, make_workload(cfg, args), args)
    print_report(report, args)
    return report


if __name__ == "__main__":
    main()
