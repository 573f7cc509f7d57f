#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--details PATH]

Runs from the root of a checkout and needs one CUDA device; it exits
nonzero, printing no result, when CUDA is unavailable or the port's sources
are missing.  Phases, one JSON line each:

  device       card name and power limit, torch/CUDA versions, and the
               build of every kernel from the checkout's sources (nvcc,
               sm_90a), with the compiler's register report;
  kernels      each CUDA kernel held against its plain PyTorch version on
               the card at the shapes the main path gives it, plus ragged
               shapes: bit-exact on raw int32 and on the fused float32
               epilogue, in exact and approximate modes;
  kernel_time  each kernel's median time (CUDA events, L2 flushed before
               each launch) beside its bound, its plain version's time and,
               where one exists, a PyTorch library call's time;
  serve        the main path: ``ServingEngine.serve()`` on full-width,
               full-depth qwen2-1.5b (random weights from a seed) in
               bp_exact with an int8 KV cache on the slab store, greedy.
               The launch counts are zeroed just before and read just
               after; tokens must equal a serve with the plain-version
               backend and ``generate()`` on the same prompts.

Then one ``{"kernels": [...]}`` line, the ``nvidia-smi`` name/power-limit
line, and last ``{"ok": true, "device": {...}}``.  Any failed check exits 1.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12

# (K, N) of qwen2-1.5b's dense projections: wq/wo, wk/wv, gate/up, down
QWEN_KN = ((1536, 1536), (1536, 256), (1536, 8960), (8960, 1536))
# ragged shapes of the reference's kernel tests
RAGGED_MKN = ((8, 128, 128), (16, 256, 384), (256, 256, 256), (5, 33, 17),
              (1, 128, 1), (300, 520, 260))
MODES = (("exact", False), ("approx", True))


class CheckFailed(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# timing helpers
# ---------------------------------------------------------------------------

class Flusher:
    """Writes a buffer larger than the 50 MB L2 so the next launch finds its
    operands in device memory, as the main path does (it streams 1.3 GB of
    weights per decode step)."""

    def __init__(self, torch):
        self.buf = torch.empty(128 * 2 ** 20, dtype=torch.int8,
                               device="cuda")

    def __call__(self):
        self.buf.zero_()


#: clock cycles of the spin kernel queued ahead of each timed launch: a few
#: milliseconds, longer than the host takes to enqueue the timed work
SPIN_CYCLES = 10_000_000


def time_ms(torch, fn, flush, iters: int = 30, warmup: int = 3) -> float:
    """Median device time of ``fn`` over ``iters`` launches: CUDA events
    around each launch, the L2 flushed before each.  A spin kernel keeps
    the device busy while the host enqueues the events and ``fn``'s
    kernels, so the events bracket device work only, not the wrapper's
    host overhead."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush()
        torch.cuda._sleep(SPIN_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def matmul_bound(m: int, k: int, n: int, approx: bool):
    """(bound_ms, bound_by): the larger of bytes over HBM rate (A, W and
    both scale vectors read once, the float32 output written once) and int8
    ops over the tensor-core rate (one contraction exact, three approx)."""
    nbytes = m * k + k * n + 4 * m + 4 * n + 4 * m * n
    ops = 2 * m * n * k * (3 if approx else 1)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT8_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device(torch, gpu):
    from repro_torch.kernels.bitparticle_matmul import build
    t0 = time.perf_counter()
    build.library()
    build_s = time.perf_counter() - t0
    ptxas = sorted({ln.split(":", 1)[1].strip()
                    for ln in build.last_build_log.splitlines()
                    if "Used" in ln and ":" in ln})
    emit({"phase": "device", "gpu": gpu, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "kernel_builds": [{"name": "bp_matmul",
                             "source": "src/repro_torch/kernels/"
                                       "bitparticle_matmul/csrc/bp_matmul.cu",
                             "nvcc_s": build.last_build_s,
                             "build_and_load_s": build_s}],
          "ptxas": ptxas})


def _rand_case(torch, gen, m, k, n):
    from repro_torch.kernels.bitparticle_matmul.ops import kmajor
    a = torch.randint(-127, 128, (m, k), generator=gen, device="cuda",
                      dtype=torch.int32).to(torch.int8)
    w = kmajor(torch.randint(-127, 128, (k, n), generator=gen,
                             device="cuda",
                             dtype=torch.int32).to(torch.int8))
    sa = torch.rand(m, generator=gen, device="cuda") * 0.1 + 1e-3
    sw = torch.rand(n, generator=gen, device="cuda") * 0.01 + 1e-4
    return a, w, sa, sw


def phase_kernels(torch, gpu):
    from repro_torch.kernels.bitparticle_matmul.ops import bp_matmul
    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = [(m, k, n) for m in (1, 4, 8, 256) for k, n in QWEN_KN]
    shapes += list(RAGGED_MKN)
    n_cases, max_err, failures = 0, 0.0, []
    for m, k, n in shapes:
        a, w, sa, sw = _rand_case(torch, gen, m, k, n)
        for name, approx in MODES:
            got_i = bp_matmul(a, w, approx=approx, backend="kernel")
            want_i = bp_matmul(a, w, approx=approx, backend="plain")
            got_f = bp_matmul(a, w, sa, sw, approx=approx, backend="kernel")
            want_f = bp_matmul(a, w, sa, sw, approx=approx, backend="plain")
            torch.cuda.synchronize()
            err_i = (got_i.long() - want_i.long()).abs().max().item()
            err_f = (got_f - want_f).abs().max().item()
            max_err = max(max_err, float(err_i), err_f)
            n_cases += 2
            if not (torch.equal(got_i, want_i) and torch.equal(got_f,
                                                              want_f)):
                failures.append({"m": m, "k": k, "n": n, "mode": name,
                                 "int_err": err_i, "f32_err": err_f})
    emit({"phase": "kernels", "gpu": gpu,
          "kernels": [{"name": "bp_matmul", "cases": n_cases,
                       "tolerance": "bit-exact (int32 and float32)",
                       "max_abs_err": max_err,
                       "parity": "ok" if not failures else "FAILED",
                       "failures": failures[:10]}]})
    check(not failures, f"bp_matmul disagrees with its plain version on "
                        f"{len(failures)} cases: {failures[:3]}")


def _library_int_mm(torch, a, w):
    """torch._int_mm (cuBLAS int8 GEMM) on the same operands, or None
    where its shape rules refuse them (it needs M > 16 and K, N multiples
    of 8).  Timed only; the port never calls it."""
    m, k = a.shape
    n = w.shape[1]
    if m <= 16 or k % 8 or n % 8:
        return None
    wc = w.contiguous()
    return lambda: torch._int_mm(a, wc)


def time_case(torch, flush, gen, m, k, n, approx):
    from repro_torch.kernels.bitparticle_matmul.ops import bp_matmul
    a, w, sa, sw = _rand_case(torch, gen, m, k, n)
    row = {"m": m, "k": k, "n": n, "mode": "approx" if approx else "exact"}
    row["ms"] = time_ms(torch, lambda: bp_matmul(
        a, w, sa, sw, approx=approx, backend="kernel"), flush)
    row["plain_ms"] = time_ms(torch, lambda: bp_matmul(
        a, w, sa, sw, approx=approx, backend="plain"), flush, iters=10)
    lib = None if approx else _library_int_mm(torch, a, w)
    row["library_ms"] = None if lib is None else time_ms(torch, lib, flush)
    row["bound_ms"], row["bound_by"] = matmul_bound(m, k, n, approx)
    return row


def phase_kernel_time(torch, gpu, flush):
    from repro_torch.kernels.bitparticle_matmul import ops
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for m in (8, 256):
        for k, n in QWEN_KN:
            for _, approx in MODES:
                rows.append(time_case(torch, flush, gen, m, k, n, approx))
    ops.reset_launches()
    emit({"phase": "kernel_time", "gpu": gpu, "kernel": "bp_matmul",
          "library": "torch._int_mm (exact mode, M > 16 only)",
          "rows": rows})
    return rows


def _requests(serving, rng, vocab: int, n: int):
    reqs = []
    for i in range(n):
        plen = int(rng.integers(16, 129))
        reqs.append(serving.Request(
            prompt=rng.integers(2, vocab, size=plen).astype("int32"),
            max_new_tokens=int(rng.integers(8, 33)),
            arrival_time=float(2 * i)))
    return reqs


def phase_serve(torch, gpu, n_requests=8, n_slots=4, lead_window=4):
    import numpy as np

    from repro_torch import serving
    from repro_torch.configs.base import get_arch
    from repro_torch.kernels.bitparticle_matmul import ops
    from repro_torch.models import api
    from repro_torch.models.layers import quantize_dense_params

    cfg = get_arch("qwen2-1.5b").replace(matmul_mode="bp_exact",
                                         kv_cache_int8=True)
    t0 = time.perf_counter()
    with torch.no_grad():
        params = quantize_dense_params(api.init(cfg, seed=0, device="cuda"))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    init_s = time.perf_counter() - t0
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in _leaves(params))
    scfg = serving.ServeConfig(max_new_tokens=32, temperature=0.0)
    engine = serving.ServingEngine(cfg, params, scfg, device="cuda")
    sched = serving.SchedulerConfig(lead_window=lead_window)
    rng = np.random.default_rng(0)
    prompts = _requests(serving, rng, cfg.vocab_size, n_requests)

    def fresh():
        return [serving.Request(prompt=r.prompt.copy(),
                                max_new_tokens=r.max_new_tokens,
                                arrival_time=r.arrival_time,
                                request_id=i)
                for i, r in enumerate(prompts)]

    cache_T = max(r.prompt_len + r.max_new_tokens for r in prompts) + 8
    # warm-up serve (allocator, cuBLAS handles): not measured
    engine.serve(fresh()[:2], n_slots=n_slots, cache_T=cache_T,
                 sched_cfg=sched)
    torch.cuda.synchronize()

    # -- the measured main-path run: counts zeroed just before, read after
    ops.reset_launches()
    loop = engine.make_loop(fresh(), n_slots=n_slots, cache_T=cache_T,
                            sched_cfg=sched)
    report = loop.run()
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    n_prefill = sum(1 for r in loop.stream if r["kind"] == "prefill")
    expected = 7 * cfg.num_layers * (n_prefill + report.steps)
    step_ms = [1e3 * r["wall_s"] for r in loop.stream
               if r["kind"] == "decode"]
    toks = {r.request_id: r.tokens.tolist() for r in report.results}
    finite = all(r.finish_reason == "length" for r in report.results)
    in_vocab = all(0 <= t < cfg.vocab_padded for ts in toks.values()
                   for t in ts)

    # -- A/B: the same weights through the plain-version backend
    ops.reset_launches()
    plain = serving.ServingEngine(cfg.replace(matmul_backend="plain"),
                                  params, scfg, device="cuda")
    rep_plain = plain.serve(fresh(), n_slots=n_slots, cache_T=cache_T,
                            sched_cfg=sched)
    plain_launches = ops.LAUNCHES["bp_matmul"]
    toks_plain = {r.request_id: r.tokens.tolist() for r in rep_plain.results}

    # -- the static path on the same prompts, one request at a time.  Its
    # float reductions (bf16 GEMMs at batch 1, unpadded prefill) run in
    # another order than the batched serve's, so a stream may flip where
    # two logits tie to within bf16 rounding: each flip is reported with
    # its top-2 margin, and any flip that is not such a near-tie fails.
    flips = []
    for i, r in enumerate(prompts):
        g = engine.generate({"tokens": r.prompt[None]},
                            max_new_tokens=r.max_new_tokens,
                            cache_T=cache_T).tokens[0].tolist()
        if g != toks[i]:
            flips.append(_flip(torch, np, engine, r.prompt, toks[i], g,
                               cache_T, i))
    ops.reset_launches()
    # a short profiled serve (2 requests, 8 new tokens each): the
    # profiler's post-processing grows with the ~5,000 kernels of a step
    profile = _profile_serve(
        torch, engine, [serving.Request(prompt=r.prompt.copy(),
                                        max_new_tokens=8,
                                        arrival_time=r.arrival_time)
                        for r in prompts[:2]], n_slots, cache_T, sched)
    ops.reset_launches()

    decode_tok_s = report.decode_tokens_per_s
    p = serving.percentiles(step_ms, qs=(50, 90))
    result = {
        "phase": "serve", "gpu": gpu, "model": cfg.name,
        "layers": cfg.num_layers, "d_model": cfg.d_model,
        "mode": cfg.matmul_mode, "kv_cache_int8": cfg.kv_cache_int8,
        "cache_backend": scfg.cache_backend, "n_requests": n_requests,
        "n_slots": n_slots, "lead_window": lead_window, "cache_T": cache_T,
        "init_and_quantize_s": init_s, "param_bytes": weight_bytes,
        "prefill_calls": n_prefill, "decode_steps": report.steps,
        "total_new_tokens": report.total_new_tokens,
        "bp_matmul_launches": launches["bp_matmul"],
        "expected_launches": expected,
        "plain_backend_launches": plain_launches,
        "tokens_equal_plain_backend": toks == toks_plain,
        "generate_equal_serve": not flips,
        "generate_flips": flips,
        "decode_tokens_per_s": decode_tok_s,
        "decode_step_ms_p50": p["p50"] if p else None,
        "decode_step_ms_p90": p["p90"] if p else None,
        "prefill_s": report.prefill_s, "decode_s": report.decode_s,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
        "first_tokens": toks[0][:8],
        "profile": profile,
    }
    emit(result)
    check(finite, "a request finished for another reason than length")
    check(in_vocab, "a generated token lies outside the padded vocabulary")
    check(launches["bp_matmul"] == expected,
          f"bp_matmul launched {launches['bp_matmul']} times on the main "
          f"path, expected {expected}")
    check(plain_launches == 0, "the plain backend launched the kernel")
    check(toks == toks_plain, "kernel and plain-version serves disagree")
    bad = [f for f in flips if not f["near_tie"]]
    check(not bad, f"generate() differs from serve() beyond a near-tie: "
                   f"{bad}")
    return result, launches


def _profile_serve(torch, engine, requests, n_slots, cache_T, sched):
    """Where a serve's time goes: one more serve of ``requests`` under
    ``torch.profiler``, reduced to device-busy time against wall time, the
    number of kernels launched, and the kernels that take the most device
    time.  The profiler slows the host, so ``idle_share`` is an
    upper bound on the unprofiled run's."""
    from torch.profiler import ProfilerActivity, profile

    def device_us(ev):
        return getattr(ev, "self_device_time_total",
                       getattr(ev, "self_cuda_time_total", 0.0))

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rep = engine.serve(requests, n_slots=n_slots, cache_T=cache_T,
                           sched_cfg=sched)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA")
               and device_us(e) > 0]
    busy_ms = sum(device_us(e) for e in kernels) / 1e3
    n_kernels = sum(e.count for e in kernels)
    bp = [e for e in kernels if "bp_gemv" in e.key or "bp_tile" in e.key]
    top = sorted(kernels, key=device_us, reverse=True)[:6]
    return {"requests": len(requests), "decode_steps": rep.steps,
            "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / wall_ms,
            "kernels": n_kernels,
            "bp_matmul_device_ms": sum(device_us(e) for e in bp) / 1e3,
            "top_kernels": [{"name": e.key[:60], "count": e.count,
                             "device_ms": device_us(e) / 1e3}
                            for e in top]}


def _flip(torch, np, engine, prompt, serve_toks, gen_toks, cache_T, rid):
    """Where two token streams first part: the position, both tokens, and
    the top-2 margin of a fresh single-request prefill of the prompt plus
    the shared prefix.  It is a near-tie when both tokens' logits lie
    within 4 bf16 units in the last place (at the top logit's magnitude)
    of the top logit."""
    j = next(k for k in range(min(len(serve_toks), len(gen_toks)))
             if serve_toks[k] != gen_toks[k])
    seq = np.concatenate([prompt, np.asarray(serve_toks[:j], np.int32)])
    logits, _ = engine.executor.prefill({"tokens": seq[None]}, cache_T)
    lg = logits[0].float()
    top = torch.topk(lg, 2).values.tolist()
    ulp = 2.0 ** (int(np.floor(np.log2(abs(top[0]) + 1e-30))) - 7)
    margin = top[0] - top[1]
    l_s, l_g = lg[serve_toks[j]].item(), lg[gen_toks[j]].item()
    return {"request": rid, "position": j, "serve_token": serve_toks[j],
            "generate_token": gen_toks[j],
            "logit_serve_token": l_s, "logit_generate_token": l_g,
            "top2_margin": margin, "bf16_ulp": ulp,
            "near_tie": top[0] - min(l_s, l_g) <= 4 * ulp}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def decode_layer_summary(torch, flush, n_slots, launches):
    """The kernels line's numbers for bp_matmul: the seven projections of
    one decoder layer at the main path's decode shape (M = n_slots), timed
    back to back in this run, beside the plain version and the bound."""
    from repro_torch.kernels.bitparticle_matmul.ops import bp_matmul
    gen = torch.Generator(device="cuda").manual_seed(2)
    kn = [(1536, 1536), (1536, 256), (1536, 256), (1536, 1536),
          (1536, 8960), (1536, 8960), (8960, 1536)]
    cases = [_rand_case(torch, gen, n_slots, k, n) for k, n in kn]
    err = 0.0
    for a, w, sa, sw in cases:
        d = bp_matmul(a, w, sa, sw, backend="kernel") - bp_matmul(
            a, w, sa, sw, backend="plain")
        err = max(err, d.abs().max().item())

    def run(backend):
        return lambda: [bp_matmul(a, w, sa, sw, backend=backend)
                        for a, w, sa, sw in cases]

    ms = time_ms(torch, run("kernel"), flush)
    plain_ms = time_ms(torch, run("plain"), flush, iters=10)
    bounds = [matmul_bound(n_slots, k, n, False)[0] for k, n in kn]
    # the seven calls are one dependent chain on the main path, so their
    # bound is the sum; all are byte-bound at this M
    bound_by = {matmul_bound(n_slots, k, n, False)[1] for k, n in kn}
    return {"name": "bp_matmul", "route": "cuda",
            "source": "src/repro_torch/kernels/bitparticle_matmul/csrc/"
                      "bp_matmul.cu",
            "replaces": "src/repro/kernels/bitparticle_matmul/kernel.py:93",
            "launches": launches["bp_matmul"], "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": sum(bounds),
            "bound_by": "bytes" if bound_by == {"bytes"} else "operations",
            "library_ms": None,
            "shape": f"one decoder layer's 7 projections at M={n_slots} "
                     f"(decode), exact mode; torch._int_mm refuses M <= 16"}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--details", default=None, metavar="PATH",
                    help="also write every phase's record to this JSON file")
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke test needs a "
              "GPU", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it "
              f"from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))

    smi = nvidia_smi_line()
    gpu = {"name": torch.cuda.get_device_name(0), "nvidia_smi": smi}
    records = []
    t0 = time.perf_counter()
    try:
        phase_device(torch, gpu)
        phase_kernels(torch, gpu)
        flush = Flusher(torch)
        records.append({"kernel_time": phase_kernel_time(torch, gpu, flush)})
        serve, launches = phase_serve(torch, gpu)
        records.append({"serve": serve})
        summary = decode_layer_summary(torch, flush, serve["n_slots"],
                                       launches)
        check(summary["launches"] > 0,
              "bp_matmul was never launched on the main path")
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    emit({"phase": "done", "gpu": gpu,
          "total_s": time.perf_counter() - t0})
    if args.details:
        pathlib.Path(args.details).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.details).write_text(json.dumps(
            {"gpu": gpu, "records": records, "kernels": [summary]},
            indent=1))
    emit({"kernels": [summary]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
