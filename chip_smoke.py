#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--details PATH]
    python3 chip_smoke.py --tile-sweep PATH
    python3 chip_smoke.py --wkv-time PATH

Runs from the root of a checkout and needs one CUDA device; it exits
nonzero, printing no result, when CUDA is unavailable or the port's sources
are missing.  Phases, one JSON line each:

  device       card name and power limit, torch/CUDA versions, and the
               build of every kernel from the checkout's sources (one nvcc
               per kernel, all started together; sm_90a), with the
               compiler's register report;
  kernels      each CUDA kernel held against its plain PyTorch version on
               the card at the shapes the main paths give it, plus ragged
               shapes: the BitParticle matmul bit-exact (raw int32 and the
               fused float32 epilogue, exact and approximate modes) on its
               decode GEMV at qwen2-1.5b's and rwkv6-7b's projections and
               lm_head (M 1, 4, 8) and on its prefill tile kernel at both
               models' projections (M 9 to 2048, the verify steps' 20 and
               256 among them), the reference's ragged
               shapes and ragged prefill ones (K % 16 != 0, N 17 and 260),
               an A one byte off alignment (the byte loads), inputs with
               -128, and plans that split K (the GEMV's workspace must be
               zero again after them); paged attention within 1e-5 in float32 on the
               reference's ragged shapes and within one bf16 unit in the
               last place at qwen2-1.5b's decode shape, at 1, 8 and 12
               query rows per kv head (float32 and bf16), at 32 sequences
               of 8192 positions, at lengths either side of a ring stage and
               a split, on pages shared across sequences, plus a length-0
               all-trash case;
               the chunked WKV6 recurrence (its two kernels, state chain
               and chunk outputs) on the reference's kernel-test shapes
               (float32 within 2e-4, bf16 r/k/v within 3e-2), at rwkv6-7b's
               prefill shapes and one 4096-step row set (bf16, the model's
               decay range), R 64 x T 256 in float32 with that range,
               one-chunk rows, a single 4096-step row, the plan's largest
               row split, and through the model-layout wrapper with a
               padded tail, each case with its maximum error;
  kernel_time  each kernel's median time (CUDA events, L2 flushed before
               each launch) beside its bound, its plain version's time and,
               where one exists, a PyTorch library call's time; the
               BitParticle matmul's GEMV at M 4 and 8 on both models'
               decode shapes, its tile kernel at the serves' prefill rows
               (qwen2-1.5b M 64-2048, rwkv6-7b M 64, 100, 256) beside
               ``torch._int_mm`` in both weight layouts, and one qwen2-1.5b
               layer's seven projections at the verify steps' rows (M 20
               and 256) beside the same chain of ``torch._int_mm`` calls
               in both weight layouts; WKV6 at rwkv6-7b's
               prefill shapes with its plan and achieved HBM rate; and the
               time the same harness gives the smallest kernel
               (``event_floor_ms``);
  serve        the first main path: ``ServingEngine.serve()`` on
               full-width, full-depth qwen2-1.5b (random weights from a
               seed) in bp_exact with an int8 KV cache on the slab store,
               greedy.  The launch counts are zeroed just before and read
               just after; tokens must equal a serve with the plain-version
               backend and ``generate()`` on the same prompts;
  serve_paged  the second main path: the same model in bp_exact with a
               bf16 KV cache on the paged store (block size 16, a pool
               small enough to preempt), requests sharing a 256-token
               system prompt.  Paged attention must launch once per layer
               per decode step and the matmul 7 per layer per forward;
               tokens must equal the plain-version serve and the slab serve
               except for flips at argmax near-ties, each reported;
  serve_spec   speculative decoding on the ``serve`` workload (slab, int8
               KV) with ``draft="model"``, K = 4, the draft model being the
               target's own config and weights (a self-draft), then a
               shorter ``draft="prompt_lookup"`` serve of four prompts that
               repeat a 16-token phrase to 64-128 tokens.  Every verify
               step runs each projection once at 4 x 5 rows (K1's tiles),
               every proposal K+1 draft decode steps at 4 rows (K1's
               GEMV), every admission a draft prefill (the tiles): the
               counts must match the step stream and the drafter's spans
               exactly, and paged attention never runs.  Tokens must equal
               the ``serve`` phase's, a plain-version speculative serve's
               and (prompt lookup) a non-speculative serve's except for
               near-tie flips, each reported; the self-draft must take
               fewer steps than ``serve`` and commit more than one token
               per step.  Reports acceptance, steps, committed tokens per
               step, decode tokens/s and TTFT beside ``serve``'s;
  serve_chunked chunked prefill (``prefill_chunk=64``, no drafter) on the
               ``serve_paged`` workload and pool.  Chunk steps run each
               projection at 4 x 64 rows (the tiles) and attention as the
               dense gather; steps without a chunk are classic paged
               decodes, so paged attention must launch exactly once per
               layer per such step.  Tokens must equal ``serve_paged``'s
               one-shot tokens and a plain-version chunked serve's except
               for near-tie flips, each reported; reports chunk tokens,
               preemptions and TTFT per request beside ``serve_paged``'s;
  serve_probe  the hardware-cost probe on the paged main path: the
               ``serve_paged`` workload and pool with
               ``SparsityProbe(probe_every=1)`` and a ``Telemetry`` writing
               the metrics JSONL and the Chrome trace.  Tokens and K1's
               (per route) and K2's launches must equal ``serve_paged``'s
               exactly (the probe's reductions are plain PyTorch
               operations, no kernel); one ``hw_estimate`` record per
               prefill and per step; every record must carry the golden
               schema's keys, the report must equal the fold of the written
               file, the trace's spans must nest, every rate must lie in
               [0, 1].  Prints the measured activation and weight bit and
               value sparsity, the modeled cycles per MAC and energy of the
               four methods, the array utilization, the cost hint, the
               step p50/p90 beside ``serve_paged``'s, and the host time of
               a fold, of ``deployment_estimate`` and of the weight
               profile.  A one-request serve with ``profile_dir`` must
               write a ``torch.profiler`` trace naming K1's kernel;
  serve_chaos  fault injection and the recovery ladder on the paged main
               path (the ``serve_paged`` workload and pool), three runs:
               the reference chaos benchmark's seeded injector (step,
               prefill, pool, OOM, NaN, drafter and cancel faults, at most
               10) under ``draft="prompt_lookup"``, K 3, whose survivors
               must equal a fault-free prompt-lookup serve and whose
               cancelled or failed streams a prefix of it, except near-tie
               flips, each reported, with every injection in the stream as
               a ``fault`` record, no block left live, K1 launching on the
               last step and K2 once per layer per classic decode; two
               scheduled step faults without retry, whose second recovery
               takes the kernel rung (one ``plain_fallback`` degrade, then
               K1 and K2 never launch again in that serve, while the
               engine's executor keeps its backend); one 3 s latency spike
               against a 1.5 s watchdog (one ``StepTimeout``, one recovery, the
               abandoned step joined before the phase ends).  The last two
               run without a drafter and must give ``serve_paged``'s
               tokens except near-tie flips.  Prints every run's record
               counts and the recoveries' wall times.  This is the only
               phase where the kernel rung may fire: every other serve of
               this script must show no fault, retry, recovery, failed
               request or degrade record but the pool-pressure rung's;
  serve_frontdoor  the HTTP/SSE front door on the paged main path: two
               replicas, each its own engine over the same quantized
               weights and its own 36-block pool, behind
               ``FrontDoor(policy="affinity")`` on 127.0.0.1; the
               ``serve_paged`` requests and four sharing a second system
               prompt, from client threads, half streamed over SSE, one
               client hanging up after 4 tokens.  ``/healthz`` and
               ``/v1/stats`` must answer, the hung-up request end
               cancelled and both pools drain, every other stream equal a
               direct serve except near-tie flips, each system prompt stay
               on one replica (prefix hits), every replica worker launch on
               the loop's stream, and K1's (per route) and K2's launches
               equal what both replicas' step streams predict.  Reports
               the TTFT and inter-token gaps the clients see over HTTP,
               the door's added latency per token (client receipt against
               the engine's commit stamp), and each replica's step p50
               beside ``serve_paged``'s;
  serve_rwkv   the third main path, after the qwen2 weights are freed:
               full-width, full-depth rwkv6-7b (random weights from a seed)
               in bp_exact on the slab store, greedy; prompts of 64-256
               tokens (the WKV6 kernel) and one of 100 (the step
               recurrence).  The matmul must launch 7 times per layer plus
               once for the lm_head per forward, the WKV6 kernel once per
               layer per prefill whose length is a multiple of 64, paged
               attention never; tokens must equal the plain-version serve
               and ``generate()`` except for near-tie flips, each reported.
               A near-tie here is measured in the run: two exact plain
               evaluations of one prefill (the chunked form, and the step
               recurrence over all but the last token plus a decode step)
               part by tenths of a logit on this random-init model (the
               JAX reference parts as far: tests/test_torch_rwkv_depth.py),
               and a flip whose two logits lie within that gap of the top
               logit is a near-tie; the kernel's prefill logits must lie
               within twice that gap of the plain version's.  Where no
               layer can amplify the kernel's rounding yet, the check is
               strict: layer 0's WKV state after every kernel-route
               prefill of the serve within 3e-2 of the plain serve's.

Then one ``{"kernels": [...]}`` line, the ``nvidia-smi`` name/power-limit
line, and last ``{"ok": true, "device": {...}}``.  Any failed check exits 1.

``--wkv-time PATH`` runs none of that either: it builds the WKV6 library
alone and times it at rwkv6-7b's prefill shapes (``kernel_time``'s WKV6
rows), writing them to PATH; copied into an older checkout it times that
checkout's kernel with the same harness, for an A/B within one call.

``--tile-sweep PATH`` runs none of that: it times every tile x K split of
the BitParticle matmul's prefill tile kernels at the serves' prefill
shapes, each held bit-exact against the plain version, beside the host
plan's own choice (``ops.tile_plan``, whose thresholds were fitted to this
sweep), and writes them to PATH.
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
# (K, N) of rwkv6-7b's decode projections: r/k/v/g/o, the channel mix's
# key and value, and the untied lm_head
RWKV_KN = ((4096, 4096), (4096, 14336), (14336, 4096), (4096, 65536))
# (M, [(K, N)]) of the prefill timing rows: the serves' prefill row counts
# (qwen2: group x pow2 bucket, up to 2048 in the paged serve; rwkv6-7b:
# exact prompt lengths, one request per group) on the projections prefill
# takes through the tile kernel
PREFILL_TIME = tuple((m, QWEN_KN) for m in (64, 256, 512, 2048)) + tuple(
    (m, RWKV_KN[:3]) for m in (64, 100, 256))
# one decoder layer's seven projections, in the order the model calls them
QWEN_LAYER_KN = ((1536, 1536), (1536, 256), (1536, 256), (1536, 1536),
                 (1536, 8960), (1536, 8960), (8960, 1536))
RWKV_LAYER_KN = ((4096, 4096),) * 5 + ((4096, 14336), (14336, 4096))
# ragged shapes of the reference's kernel tests, and ragged prefill shapes:
# K not a multiple of 16 (byte loads), N 17 and 260
RAGGED_MKN = ((8, 128, 128), (16, 256, 384), (256, 256, 256), (5, 33, 17),
              (1, 128, 1), (300, 520, 260), (17, 520, 17), (9, 4096, 260),
              (2048, 520, 17), (100, 1000, 260), (512, 1000, 8960))
# prefill row counts held against the plain version on both models'
# projections: a 9-row group up to a 2048-row paged prefill, with the
# verify steps' 20 rows (4 slots x 5 positions) and 256 (4 x a 64-token
# chunk)
PREFILL_CHECK_M = (9, 16, 17, 20, 64, 100, 256, 512, 2048)
# rows of the verify steps' projections: 4 slots x (K + 1 = 5) positions
# under speculation, 4 slots x a 64-token chunk under chunked prefill
VERIFY_M = (20, 256)
MODES = (("exact", False), ("approx", True))
BF16_OPS_PER_S = 989e12
# the tensor cores' dense TF32 rate
TF32_OPS_PER_S = 495e12
# exponentials per clock per SM on the special-function units
SFU_PER_CLOCK_SM = 16

# paged attention: the reference's ragged kernel-test shapes
# (B, H, KH, D, n_blocks, block_size, pages_per_seq, lengths below)
PA_RAGGED = ((1, 2, 1, 8, 6, 4, 4, 16), (3, 4, 2, 16, 12, 4, 5, 20),
             (5, 6, 3, 32, 20, 8, 3, 24), (2, 8, 8, 16, 10, 2, 7, 14),
             (4, 4, 1, 64, 16, 16, 2, 32))
# qwen2-1.5b's decode attention: 12 query heads on 2 kv heads, head dim 128,
# with the serve's block size
QWEN_ATTN = {"H": 12, "KH": 2, "D": 128, "bs": 16}
#: paged serve: pages in the pool, the trash page included.  Its requests
#: hold up to 37 blocks at once with an unbounded pool (16 shared + up to 6
#: private blocks per slot), so 35 allocatable blocks run dry and preempt
#: (4 times on a CPU rehearsal of the same lengths and arrivals: the pool's
#: decisions depend on them only); one request alone always fits.
PAGED_NUM_BLOCKS = 36

# WKV6 (R, T, N, chunk): the reference's kernel-test shapes
WKV_REF_SHAPES = ((2, 64, 16, 16), (1, 32, 32, 32), (4, 128, 64, 64),
                  (3, 96, 8, 32))
# rwkv6-7b prefills (R = 64 heads x requests, T steps; N 64, chunk 64):
# one 128-token request (the rwkv serve's most frequent call; the plan
# splits each chunk's rows over two blocks there), one and four
# 256-token requests, and one 4096-token request
WKV_SERVE_SHAPES = ((64, 128), (64, 256), (256, 256))
WKV_LONG_SHAPE = (64, 4096)


class CheckFailed(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


#: perf_counter() when main() started: each phase line carries the
#: seconds since then
_START = [time.perf_counter()]


def emit(obj: dict) -> None:
    if "phase" in obj:
        obj = {**obj, "elapsed_s": time.perf_counter() - _START[0]}
    print(json.dumps(obj), flush=True)


def nvidia_smi(query: str, *fmt: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}",
         "--format=" + ",".join(("csv", "noheader") + fmt)],
        capture_output=True,
        text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def nvidia_smi_line() -> str:
    return nvidia_smi("name,power.limit")


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


def event_floor_ms(torch, flush) -> float:
    """``time_ms`` of the smallest kernel (one add on 16 floats): what the
    events, the launch and a cold start add to every timed call, whatever
    the kernel does.  Printed beside the times so that a short kernel's
    time can be read against it."""
    x = torch.zeros(16, device="cuda")
    return time_ms(torch, lambda: x.add_(1), flush)


def matmul_bound(m: int, k: int, n: int, approx: bool):
    """(bound_ms, bound_by): the larger of bytes over HBM rate (A, W and
    both scale vectors read once, the float32 output written once) and int8
    ops over the tensor-core rate (one contraction exact, three approx)."""
    nbytes = m * k + k * n + 4 * m + 4 * n + 4 * m * n
    ops = 2 * m * n * k * (3 if approx else 1)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT8_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attention_bound(lengths, n_heads: int, kv_heads: int, head_dim: int,
                    block_size: int, pages_per_seq: int, esize: int = 2):
    """(bound_ms, bound_by) of paged decode attention: the larger of bytes
    over HBM rate (the valid K and V rows of every sequence, q, the output,
    the tables and lengths, each once) and its flops (q.k and p.v, two per
    multiply-add) over the bf16 tensor-core rate."""
    B = len(lengths)
    tokens = sum(min(int(n) + 1, pages_per_seq * block_size)
                 for n in lengths)
    nbytes = (2 * tokens * kv_heads * head_dim * esize
              + 2 * B * n_heads * head_dim * esize
              + 4 * B * pages_per_seq + 4 * B)
    ops = 4 * tokens * n_heads * head_dim
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / BF16_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def wkv_bound(R: int, T: int, N: int, chunk: int, esize: int, sms: int,
              sm_mhz: float):
    """(bound_ms, bound_by) of the WKV6 recurrence: the largest of three
    times, each for the work itself, not for how a kernel does it.

      bytes        r/k/v in ``esize`` bytes, log_w, u, the state in and
                   out and the float32 output, each once, over HBM rate;
      products     the chunked form's multiply-adds (two operations each)
                   over the dense TF32 tensor-core rate, one pass: per row
                   and chunk of L steps the pair matrix A and A v
                   (L (L - 1) / 2 N each), the cross-chunk product and the
                   state update (L N^2 each);
      exponentials one per input decay (R T N, the fewest any exact form
                   takes) over the special-function units' 16 per clock
                   per SM at the card's SM clock ``sm_mhz``.

    A kernel's split-TF32 passes and its per-pair exponentials are its own
    cost, so a tensor-core kernel cannot beat this bound.  ``bound_by`` is
    "bytes" or "operations" (products or exponentials)."""
    L = chunk
    per_chunk = L * (L - 1) * N + 2 * L * N * N
    flops = 2 * R * (T // L) * per_chunk
    exps = R * T * N
    nbytes = (3 * R * T * N * esize + 4 * R * T * N + 4 * R * N
              + 2 * 4 * R * N * N + 4 * R * T * N)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(flops / TF32_OPS_PER_S,
                exps / (SFU_PER_CLOCK_SM * sms * sm_mhz * 1e6)) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bf16_ulp(torch, x):
    """One bf16 unit in the last place at each element's magnitude, not
    below the unit at 2^-8: an output near zero is an average of O(1)
    values that cancel, and there float32 summation order alone moves it by
    more than a bf16 unit of its own tiny magnitude."""
    e = torch.floor(torch.log2(x.float().abs().clamp_min(2.0 ** -8)))
    return torch.pow(2.0, e - 7)


def paged_case(torch, gen, B, H, KH, D, n_blocks, bs, pps, lengths, dtype):
    """Random q and pages on the card, and per-sequence block tables over
    random pages (distinct across sequences where the pool holds enough;
    unused entries point at the trash page 0)."""
    dev = "cuda"
    q = torch.randn((B, H, D), generator=gen, device=dev).to(dtype)
    kp = torch.randn((n_blocks, bs, KH, D), generator=gen,
                     device=dev).to(dtype)
    vp = torch.randn((n_blocks, bs, KH, D), generator=gen,
                     device=dev).to(dtype)
    tables = torch.zeros((B, pps), dtype=torch.int32, device=dev)
    distinct = B * pps <= n_blocks - 1
    perm = torch.randperm(n_blocks - 1, generator=gen, device=dev) + 1
    for b, n in enumerate(lengths):
        used = min(int(n) // bs + 1, pps)
        if not distinct:
            perm = torch.randperm(n_blocks - 1, generator=gen,
                                  device=dev) + 1
        start = b * pps if distinct else 0
        tables[b, :used] = perm[start:start + used].to(torch.int32)
    lens = torch.tensor([int(n) for n in lengths], dtype=torch.int32,
                        device=dev)
    return q, kp, vp, tables, lens


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

KERNEL_SOURCES = {
    "bp_matmul": "src/repro_torch/kernels/bitparticle_matmul/csrc/"
                 "bp_matmul.cu",
    "paged_attention": "src/repro_torch/kernels/paged_attention/csrc/"
                       "paged_attention.cu",
    "wkv6": "src/repro_torch/kernels/wkv6/csrc/wkv6.cu",
}


def phase_device(torch, gpu):
    """Build every kernel library from the checkout, one nvcc each, all
    started together."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels.bitparticle_matmul import build as bp_build
    from repro_torch.kernels.paged_attention import build as pa_build
    from repro_torch.kernels.wkv6 import build as wkv_build
    libs = {"bp_matmul": bp_build.LIBRARY,
            "paged_attention": pa_build.LIBRARY,
            "wkv6": wkv_build.LIBRARY}

    def load(lib):
        t0 = time.perf_counter()
        lib.load()
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as pool:
        secs = dict(zip(libs, pool.map(load, libs.values())))
    builds = []
    for name, lib in libs.items():
        builds.append({
            "name": name, "source": KERNEL_SOURCES[name],
            "nvcc_s": lib.last_build_s, "build_and_load_s": secs[name],
            "ptxas": sorted({ln.split(":", 1)[1].strip()
                             for ln in lib.last_build_log.splitlines()
                             if "Used" in ln and ":" in ln})})
    emit({"phase": "device", "gpu": gpu, "torch": torch.__version__,
          "cuda": torch.version.cuda, "kernel_builds": builds,
          "all_builds_s": time.perf_counter() - t0})


def _rand_case(torch, gen, m, k, n, low=-127):
    from repro_torch.kernels.bitparticle_matmul.ops import kmajor
    a = torch.randint(low, 128, (m, k), generator=gen, device="cuda",
                      dtype=torch.int32).to(torch.int8)
    w = kmajor(torch.randint(low, 128, (k, n), generator=gen,
                             device="cuda",
                             dtype=torch.int32).to(torch.int8))
    sa = torch.rand(m, generator=gen, device="cuda") * 0.1 + 1e-3
    sw = torch.rand(n, generator=gen, device="cuda") * 0.01 + 1e-4
    return a, w, sa, sw


def phase_kernels(torch, gpu):
    entries = [check_bp_matmul(torch), check_paged_attention(torch),
               check_wkv6(torch)]
    emit({"phase": "kernels", "gpu": gpu, "kernels": entries})
    for e in entries:
        check(not e["failures"], f"{e['name']} disagrees with its plain "
                                 f"version on {len(e['failures'])} cases: "
                                 f"{e['failures'][:3]}")


def check_bp_matmul(torch):
    """The BitParticle matmul bit-exact against its plain version (raw
    int32 and fused float32, both modes), on each route: the decode GEMV
    (M <= 8) and the prefill tile kernels (M > 8: ``mma.sync``, and
    ``wgmma`` for exact mode's larger tiles), each route's cases and error
    kept apart; plans that split K are counted (the tiles' slices sum in a
    cluster's shared memory, the GEMV's in a workspace, which must be zero
    again after them)."""
    from repro_torch.kernels.bitparticle_matmul import ops
    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = [(m, k, n) for m in (1, 4, 8) for k, n in QWEN_KN + RWKV_KN]
    shapes += [(m, k, n) for m in PREFILL_CHECK_M
               for k, n in QWEN_KN + RWKV_KN[:3]]
    shapes += list(RAGGED_MKN)
    # A one byte off 16-byte alignment (K a multiple of 16): the kernels'
    # byte loads
    shapes += [(4, 8960, 256, "misaligned"), (100, 4096, 4096, "misaligned"),
               (256, 4096, 4096, "misaligned")]
    # every int8 value, -128 included (no particles: rem4 = rem16 = 0)
    shapes += [(8, 4096, 512, "minus128"), (256, 1536, 264, "minus128")]
    routes = ("gemv", "mma", "wgmma")
    cases, max_err = dict.fromkeys(routes, 0), dict.fromkeys(routes, 0.0)
    failures, split_plans = [], 0
    for m, k, n, *variant in shapes:
        a, w, sa, sw = _rand_case(torch, gen, m, k, n,
                                  low=-128 if variant == ["minus128"]
                                  else -127)
        if variant == ["misaligned"]:
            buf = torch.empty(m * k + 1, dtype=torch.int8, device="cuda")
            a = buf[1:].view(m, k).copy_(a)
        sms = ops._sm_count(a.device)
        for name, approx in MODES:
            if m <= ops.GEMV_MAX_M:
                route, plan = "gemv", ops.gemv_plan(sms, m, n, k, approx)
                split_plans += plan[1] > 1
            else:
                plan = ops.tile_plan(sms, m, n, k, approx)
                route = ("wgmma" if ops.tile_uses_wgmma(plan[0], plan[1],
                                                        approx) else "mma")
                split_plans += plan[2] > 1
            got_i = ops.bp_matmul(a, w, approx=approx, backend="kernel")
            want_i = ops.bp_matmul(a, w, approx=approx, backend="plain")
            got_f = ops.bp_matmul(a, w, sa, sw, approx=approx,
                                  backend="kernel")
            want_f = ops.bp_matmul(a, w, sa, sw, approx=approx,
                                   backend="plain")
            torch.cuda.synchronize()
            err_i = (got_i.long() - want_i.long()).abs().max().item()
            err_f = (got_f - want_f).abs().max().item()
            max_err[route] = max(max_err[route], float(err_i), err_f)
            cases[route] += 2
            if not (torch.equal(got_i, want_i) and torch.equal(got_f,
                                                              want_f)):
                failures.append({"m": m, "k": k, "n": n, "mode": name,
                                 "route": route, "variant": variant,
                                 "plan": plan, "int_err": err_i,
                                 "f32_err": err_f})
    torch.cuda.synchronize()
    ws, cnt = ops._WORKSPACE[torch.device("cuda", 0)]
    ws_left = int(ws.abs().sum()) + int(cnt.abs().sum())
    if split_plans == 0 or ws_left:
        failures.append({"split_plans": split_plans,
                         "workspace_left_nonzero": ws_left})
    ops.reset_launches()
    return {"name": "bp_matmul", "cases": sum(cases.values()),
            "cases_by_route": cases,
            "tolerance": "bit-exact (int32 and float32)",
            "max_abs_err": max(max_err.values()),
            "max_abs_err_by_route": max_err,
            "split_plans": split_plans, "workspace_left_nonzero": ws_left,
            "parity": "ok" if not failures else "FAILED",
            "failures": failures[:10]}


def check_paged_attention(torch):
    """The paged-attention kernel against its plain version: float32 on the
    reference's ragged shapes (atol = rtol = 1e-5, that test's own), bf16 at
    qwen2-1.5b's decode shape (one bf16 unit in the last place, see
    ``bf16_ulp``), and length-0 slots whose tables are all trash."""
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.paged_attention.ops import paged_attention
    gen = torch.Generator(device="cuda").manual_seed(3)
    H, KH, D, bs = (QWEN_ATTN[k] for k in ("H", "KH", "D", "bs"))
    cases = []
    for B, h, kh, d, nb, b_s, pps, t_hi in PA_RAGGED:
        lengths = torch.randint(0, t_hi, (B,), generator=gen,
                                device="cuda").tolist()
        cases.append((f"ragged B{B} H{h} KH{kh} D{d} bs{b_s}", "float32",
                      paged_case(torch, gen, B, h, kh, d, nb, b_s, pps,
                                 lengths, torch.float32)))
    pps = 32
    for B in (1, 4, 32):
        lengths = torch.randint(0, bs * pps, (B,), generator=gen,
                                device="cuda").tolist()
        cases.append((f"qwen2 decode B{B}", "bfloat16",
                      paged_case(torch, gen, B, H, KH, D, B * pps + 1, bs,
                                 pps, lengths, torch.bfloat16)))
    # 1, 8 and 12 query rows per kv head (12: two groups of 6), both dtypes
    for G in (1, 8, 12):
        for dtype, name in ((torch.float32, "float32"),
                            (torch.bfloat16, "bfloat16")):
            lengths = torch.randint(0, bs * pps, (4,), generator=gen,
                                    device="cuda").tolist()
            cases.append((f"G{G} B4 {name}", name,
                          paged_case(torch, gen, 4, 2 * G, 2, D,
                                     4 * pps + 1, bs, pps, lengths, dtype)))
    # 32 sequences of 8192 positions (lengths 8191), and lengths either
    # side of a ring stage and of a split of a 512-page table
    long_pps = 512
    cases.append(("qwen2 decode B32 L8192", "bfloat16",
                  paged_case(torch, gen, 32, H, KH, D, 32 * long_pps + 1, bs,
                             long_pps, [8191] * 32, torch.bfloat16)))
    stage = pa_ops.STAGE_ROWS
    _, rps = pa_ops.split_plan(
        torch.cuda.get_device_properties(0).multi_processor_count,
        8 * KH, long_pps * bs, bs)
    edges = [stage - 1, stage, stage + 1, 2 * stage, rps - 1, rps, rps + 1,
             rps + stage]
    cases.append(("stage and split edges", "bfloat16",
                  paged_case(torch, gen, len(edges), H, KH, D,
                             len(edges) * long_pps + 1, bs, long_pps, edges,
                             torch.bfloat16)))
    # every sequence on the same pages (a shared prompt), at other lengths
    q, kp, vp, tables, _ = paged_case(torch, gen, 6, H, KH, D, 40, bs, pps,
                                      [bs * pps - 1] * 6, torch.bfloat16)
    tables[:] = tables[0].clone()
    lens = torch.tensor([0, 5, 100, 256, 300, bs * pps - 1],
                        dtype=torch.int32, device="cuda")
    cases.append(("shared pages", "bfloat16", (q, kp, vp, tables, lens)))
    for dtype, name in ((torch.float32, "float32"),
                        (torch.bfloat16, "bfloat16")):
        # a 16-page table: the kernel splits it over several blocks, and
        # all but the first have no valid position
        q, kp, vp, tables, lens = paged_case(torch, gen, 4, H, KH, D, 9, bs,
                                             16, [0] * 4, dtype)
        cases.append((f"length 0, all-trash tables, {name}", name,
                      (q, kp, vp, torch.zeros_like(tables), lens)))
    max_err, failures = 0.0, []
    for label, kind, args in cases:
        got = paged_attention(*args, backend="kernel")
        want = paged_attention(*args, backend="plain")
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        max_err = max(max_err, err.max().item())
        if kind == "float32":
            ok = torch.allclose(got, want, atol=1e-5, rtol=1e-5)
        else:
            ok = bool((err <= bf16_ulp(torch, want)).all())
        ok = ok and bool(torch.isfinite(got).all())
        if not ok:
            failures.append({"case": label, "max_abs_err": err.max().item()})
    return {"name": "paged_attention", "cases": len(cases),
            "tolerance": "float32: atol = rtol = 1e-5; bfloat16: one bf16 "
                         "unit in the last place (at magnitudes >= 2^-8)",
            "max_abs_err": max_err,
            "parity": "ok" if not failures else "FAILED",
            "failures": failures[:10]}


def wkv_inputs(torch, gen, R, T, N, dtype, model_decay=False):
    """Random WKV6 inputs on the card in kernel layout: normal r/k/v (in
    ``dtype``), u and state * 0.2, and log_w = -exp(normal - 1) as the
    reference's kernel tests draw it, or, with ``model_decay``, spread over
    the model's whole range -exp([-8, 2])."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    r, k, v = (randn(R, T, N).to(dtype) for _ in range(3))
    if model_decay:
        log_w = -torch.exp(torch.rand((R, T, N), generator=gen,
                                      device="cuda") * 10.0 - 8.0)
    else:
        log_w = -torch.exp(randn(R, T, N) - 1.0)
    return r, k, v, log_w, randn(R, N), randn(R, N, N) * 0.2


def _wkv_split(torch, R, T, N, chunk):
    """The host plan's row split for one call on this card."""
    from repro_torch.kernels.wkv6 import ops
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return ops.wkv6_plan(sms, R, T, N, chunk).row_split


def check_wkv6(torch):
    """The WKV6 kernels against their plain version: the reference's
    kernel-test shapes in float32 (atol = rtol = 2e-4) and with bf16 r/k/v
    (3e-2), the tolerances of ``test_kernel_wkv6.py``; rwkv6-7b's prefill
    shapes and a 4096-step row set in bf16 with the model's decay range;
    the same range in float32 at R 64 x T 256; one-chunk rows (T = chunk);
    a single 4096-step row (one row's state chain walking 64 chunks); the
    plan's largest row split (R 64 x T 128, each chunk's rows over two
    blocks); and the model-layout wrapper with a sequence that is not a
    multiple of the chunk (float32).  Outputs and states alike."""
    from repro_torch.kernels.wkv6 import ops
    gen = torch.Generator(device="cuda").manual_seed(5)
    cases = []

    def add(label, kind, R, T, N, chunk, dtype, model_decay=False):
        a = wkv_inputs(torch, gen, R, T, N, dtype, model_decay)
        cases.append((label, kind, _wkv_split(torch, R, T, N, chunk),
                      lambda b: ops.wkv6_rows(*a, chunk=chunk, backend=b)))

    for R, T, N, chunk in WKV_REF_SHAPES:
        for dtype, name in ((torch.float32, "float32"),
                            (torch.bfloat16, "bfloat16")):
            add(f"R{R} T{T} N{N} chunk{chunk}", name, R, T, N, chunk, dtype)
    for R, T in WKV_SERVE_SHAPES + (WKV_LONG_SHAPE,):
        add(f"rwkv6-7b prefill R{R} T{T} N64 chunk64", "bfloat16", R, T, 64,
            64, torch.bfloat16, model_decay=True)
    add("rwkv6-7b prefill R64 T256 N64 chunk64, model decay", "float32", 64,
        256, 64, 64, torch.float32, model_decay=True)
    add("one-chunk rows R64 T64 N64 chunk64", "float32", 64, 64, 64, 64,
        torch.float32, model_decay=True)
    add("one-chunk rows R5 T16 N16 chunk16", "bfloat16", 5, 16, 16, 16,
        torch.bfloat16)
    add("one row R1 T4096 N64 chunk64", "bfloat16", 1, 4096, 64, 64,
        torch.bfloat16, model_decay=True)
    add("largest row split R64 T128 N64 chunk64", "float32", 64, 128, 64,
        64, torch.float32, model_decay=True)
    check(cases[-1][2] == 2, "the plan no longer splits R64 T128's chunks: "
                             "the largest-split case tests nothing")
    # model layout (B, S, H, N) = (2, 50, 3, 16): the tail padded to 64
    B, S, H, N = 2, 50, 3, 16
    r, k, v, log_w, _, _ = wkv_inputs(torch, gen, B, S, H * N,
                                      torch.float32)
    lay = [t.reshape(B, S, H, N) for t in (r, k, v, log_w)]
    u = torch.randn((H, N), generator=gen, device="cuda")
    s0 = torch.randn((B, H, N, N), generator=gen, device="cuda") * 0.1
    cases.append(("model layout B2 S50 H3 N16 chunk32 (padded tail)",
                  "float32", 1, lambda b: ops.wkv6(*lay, u, s0, chunk=32,
                                                   backend=b)))
    rows, failures = [], []
    for label, kind, split, run in cases:
        got, want = run("kernel"), run("plain")
        torch.cuda.synchronize()
        tol = 2e-4 if kind == "float32" else 3e-2
        errs = [(g - w).abs().max().item() for g, w in zip(got, want)]
        ok = all(torch.allclose(g, w, atol=tol, rtol=tol)
                 and bool(torch.isfinite(g).all())
                 for g, w in zip(got, want))
        rows.append({"case": label, "dtype": kind, "row_split": split,
                     "tolerance": tol, "max_abs_err_out": errs[0],
                     "max_abs_err_state": errs[1], "ok": ok})
        if not ok:
            failures.append(rows[-1])
    return {"name": "wkv6", "cases": len(rows),
            "tolerance": "float32: atol = rtol = 2e-4; bf16 r/k/v: atol = "
                         "rtol = 3e-2 (test_kernel_wkv6.py's own)",
            "max_abs_err": max(max(r["max_abs_err_out"],
                                   r["max_abs_err_state"]) for r in rows),
            "parity": "ok" if not failures else "FAILED",
            "failures": failures[:10], "rows": rows}


def time_wkv_case(torch, flush, gen, gpu, R, T, N=64, chunk=64):
    """Median times of the WKV6 kernels (one call: the state chain and the
    chunk outputs) and of their plain version at one shape (bf16 r/k/v,
    the model's decay range), beside the bound, the plan and the achieved
    HBM rate of the call's own bytes."""
    from repro_torch.kernels.wkv6 import ops
    args = wkv_inputs(torch, gen, R, T, N, torch.bfloat16, model_decay=True)
    got = ops.wkv6_rows(*args, chunk=chunk, backend="kernel")
    want = ops.wkv6_rows(*args, chunk=chunk, backend="plain")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    row = {"R": R, "T": T, "N": N, "chunk": chunk,
           "max_abs_err": max((g - w).abs().max().item()
                              for g, w in zip(got, want))}
    if hasattr(ops, "wkv6_plan"):   # absent in a checkout before the plan
        plan = ops.wkv6_plan(sms, R, T, N, chunk)
        row["plan"] = {
            "state_blocks": plan.state_grid[0] * plan.state_grid[1],
            "col_blocks": plan.col_blocks,
            "chunk_blocks": plan.chunk_grid[0] * plan.chunk_grid[1],
            "row_split": plan.row_split, "smem_state": plan.smem_state,
            "smem_chunk": plan.smem_chunk,
            "workspace_bytes": plan.workspace_bytes}
    row["ms"] = time_ms(torch, lambda: ops.wkv6_rows(
        *args, chunk=chunk, backend="kernel"), flush)
    row["plain_ms"] = time_ms(torch, lambda: ops.wkv6_rows(
        *args, chunk=chunk, backend="plain"), flush, iters=10)
    row["library_ms"] = None
    row["bound_ms"], row["bound_by"] = wkv_bound(
        R, T, N, chunk, 2, sms, gpu["sm_clock_mhz"])
    nbytes = (3 * R * T * N * 2 + 8 * R * T * N + 4 * R * N
              + 8 * R * N * N)
    row["hbm_tb_per_s"] = nbytes / (row["ms"] * 1e-3) / 1e12
    return row


def _library_int_mm(torch, a, w):
    """torch._int_mm (cuBLAS int8 GEMM) on the same operands, one call per
    weight layout: ``row_major`` the (K, N) weight made contiguous, and
    ``k_major`` the weight as the port stores it (column-major (K, N), the
    "TN" form cuBLASLt's int8 GEMM is built for).  Empty where its shape
    rules refuse them (M > 16, K and N multiples of 8).  Timed only; the
    port never calls it."""
    m, k = a.shape
    n = w.shape[1]
    if m <= 16 or k % 8 or n % 8:
        return {}
    wc = w.contiguous()
    return {"row_major": lambda: torch._int_mm(a, wc),
            "k_major": lambda: torch._int_mm(a, w)}


def library_times(torch, flush, a, w):
    """{layout: ms or an error string} of ``_library_int_mm``, and the
    faster layout's time (None where no layout ran)."""
    times = {}
    for layout, fn in _library_int_mm(torch, a, w).items():
        try:
            fn()
            torch.cuda.synchronize()
            times[layout] = time_ms(torch, fn, flush)
        except RuntimeError as e:   # a layout cuBLAS refuses
            times[layout] = f"refused: {str(e).splitlines()[0][:120]}"
    ok = [t for t in times.values() if isinstance(t, float)]
    return times, (min(ok) if ok else None)


def time_case(torch, flush, gen, m, k, n, approx, plain_iters=10):
    from repro_torch.kernels.bitparticle_matmul import ops
    a, w, sa, sw = _rand_case(torch, gen, m, k, n)
    row = {"m": m, "k": k, "n": n, "mode": "approx" if approx else "exact"}
    if m > ops.GEMV_MAX_M:
        plan = ops.tile_plan(ops._sm_count(a.device), m, n, k, approx)
        row["tile_plan"] = plan
        row["route"] = ("wgmma" if ops.tile_uses_wgmma(plan[0], plan[1],
                                                       approx) else "mma")
    row["ms"] = time_ms(torch, lambda: ops.bp_matmul(
        a, w, sa, sw, approx=approx, backend="kernel"), flush)
    row["plain_ms"] = time_ms(torch, lambda: ops.bp_matmul(
        a, w, sa, sw, approx=approx, backend="plain"), flush,
        iters=plain_iters)
    row["library_ms_by_layout"], row["library_ms"] = (
        ({}, None) if approx else library_times(torch, flush, a, w))
    row["bound_ms"], row["bound_by"] = matmul_bound(m, k, n, approx)
    return row


def phase_kernel_time(torch, gpu, flush):
    from repro_torch.kernels.bitparticle_matmul import ops
    gen = torch.Generator(device="cuda").manual_seed(1)
    floor = event_floor_ms(torch, flush)
    rows = []
    for m in (4, 8):
        for k, n in QWEN_KN:
            for _, approx in MODES:
                rows.append(time_case(torch, flush, gen, m, k, n, approx))
        for k, n in RWKV_KN:
            for _, approx in MODES:
                rows.append(time_case(torch, flush, gen, m, k, n, approx))
    ops.reset_launches()
    emit({"phase": "kernel_time", "gpu": gpu, "kernel": "bp_matmul",
          "route": "decode GEMV (bp_gemv_kernel, M <= 8)",
          "shape": "qwen2-1.5b's projections and rwkv6-7b's decode "
                   "projections and lm_head at M 4 and 8",
          "library": "none: torch._int_mm refuses M <= 16",
          "event_floor_ms": floor, "rows": rows})
    tile_rows = []
    for m, kns in PREFILL_TIME:
        for k, n in kns:
            for _, approx in MODES:
                # the plain version's float64 products take milliseconds
                # at the largest shapes: fewer of them
                tile_rows.append(time_case(
                    torch, flush, gen, m, k, n, approx,
                    plain_iters=3 if m * k * n > 2 ** 34 else 10))
    ops.reset_launches()
    emit({"phase": "kernel_time", "gpu": gpu, "kernel": "bp_matmul",
          "route": "prefill tiles (M > 8): bp_wgmma_kernel for exact "
                   "mode's larger tiles, bp_tile_kernel (mma.sync) else",
          "shape": "the serves' prefill rows: qwen2-1.5b's projections at "
                   "M 64, 256, 512 and 2048, rwkv6-7b's at M 64, 100 and "
                   "256 (its lm_head takes the last position only, so the "
                   "GEMV)",
          "library": "torch._int_mm (exact mode), both weight layouts; "
                     "library_ms is the faster",
          "event_floor_ms": floor, "rows": tile_rows})
    verify_rows = [verify_layer_row(torch, flush, gen, m)
                   for m in VERIFY_M]
    ops.reset_launches()
    emit({"phase": "kernel_time", "gpu": gpu, "kernel": "bp_matmul",
          "route": "verify tiles (M > 8)",
          "shape": "one qwen2-1.5b layer's 7 projections, exact mode, at "
                   "the verify steps' rows: M 20 (4 slots x K+1 = 5, "
                   "speculation) and 256 (4 slots x a 64-token chunk)",
          "library": "the same chain of torch._int_mm calls in each weight "
                     "layout; library_ms is the faster",
          "event_floor_ms": floor, "rows": verify_rows})
    pa_rows = [time_paged_case(torch, flush, gen, B, [L - 1] * B)
               for B in (4, 32) for L in (128, 512, 2048, 8192)]
    emit({"phase": "kernel_time", "gpu": gpu, "kernel": "paged_attention",
          "shape": "qwen2-1.5b decode: H 12, KH 2, D 128, block size 16, "
                   "bf16; every sequence at the same length",
          "library": "torch.nn.functional.scaled_dot_product_attention "
                     "(enable_gqa) on K/V gathered dense beforehand",
          "event_floor_ms": floor, "rows": pa_rows})
    wkv_rows = [time_wkv_case(torch, flush, gen, gpu, R, T)
                for R, T in WKV_SERVE_SHAPES + (WKV_LONG_SHAPE,)]
    emit({"phase": "kernel_time", "gpu": gpu, "kernel": "wkv6",
          "shape": "rwkv6-7b prefill: R = 64 heads x requests rows of T "
                   "steps, N 64, chunk 64, bf16 r/k/v, the model's decay "
                   "range; one call is two kernels (state chain, chunk "
                   "outputs)",
          "library": "none: no single PyTorch call computes WKV6",
          "rows": wkv_rows})
    return rows + tile_rows + verify_rows + pa_rows + wkv_rows, verify_rows


def verify_layer_row(torch, flush, gen, m):
    """One qwen2-1.5b layer's seven projections at M = ``m`` (a verify
    step's rows), timed as a chain beside the plain version, the bound and
    the same chain of ``torch._int_mm`` calls in both weight layouts."""
    ms, plain_ms, bound_ms, bound_by, err, lib = time_chain(
        torch, flush, gen, m, QWEN_LAYER_KN, library=True)
    return {"m": m, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "max_abs_err": err,
            "library_ms_by_layout": lib,
            "library_ms": min(lib.values()) if lib else None}


def _sdpa_on_gathered(torch, q, kp, vp, tables, lens):
    """One PyTorch call computing the same function on the same inputs, as
    a timed yardstick: scaled_dot_product_attention with GQA over the
    sequences' K/V gathered dense (outside the timed call), masked at each
    sequence's length where they differ.  The port never calls it."""
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention.ref import gather_pages
    kd = gather_pages(kp, tables).transpose(1, 2).contiguous()  # B KH T D
    vd = gather_pages(vp, tables).transpose(1, 2).contiguous()
    qd = q[:, :, None, :]
    T = kd.shape[2]
    mask = None
    if bool((lens != lens[0]).any()) or int(lens[0]) + 1 < T:
        pos = torch.arange(T, device=q.device)
        mask = (pos[None, :] <= lens[:, None].long())[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask,
                                                  enable_gqa=True)


def time_paged_case(torch, flush, gen, B, lengths, pps=None):
    """Median times of paged attention at qwen2-1.5b's decode shape with
    the given lengths (inclusive last positions): the kernel, its plain
    version and the library yardstick, beside the bound."""
    from repro_torch.kernels.paged_attention.ops import paged_attention
    H, KH, D, bs = (QWEN_ATTN[k] for k in ("H", "KH", "D", "bs"))
    if pps is None:
        pps = max(int(n) for n in lengths) // bs + 1
    args = paged_case(torch, gen, B, H, KH, D, B * pps + 1, bs, pps, lengths,
                      torch.bfloat16)
    got = paged_attention(*args, backend="kernel")
    want = paged_attention(*args, backend="plain")
    row = {"B": B, "lengths": [int(n) for n in lengths][:8],
           "pages_per_seq": pps,
           "max_abs_err": (got.float() - want.float()).abs().max().item()}
    row["ms"] = time_ms(torch, lambda: paged_attention(
        *args, backend="kernel"), flush)
    row["plain_ms"] = time_ms(torch, lambda: paged_attention(
        *args, backend="plain"), flush, iters=10)
    row["library_ms"] = time_ms(torch, _sdpa_on_gathered(torch, *args),
                                flush)
    row["bound_ms"], row["bound_by"] = attention_bound(lengths, H, KH, D, bs,
                                                       pps)
    return row


def reset_counts():
    """Zero every kernel's launch counter (and paged attention's count of
    CUDA calls routed to its plain gather)."""
    from repro_torch.kernels.bitparticle_matmul import ops as bp_ops
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.wkv6 import ops as wkv_ops
    for ops in (bp_ops, pa_ops, wkv_ops):
        ops.reset_launches()


def launch_counts():
    """Every kernel's launches since :func:`reset_counts`: K1 in all and
    per route, K2, K2's calls routed to the plain gather (int8 KV pages),
    and K3."""
    from repro_torch.kernels.bitparticle_matmul import ops as bp_ops
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.wkv6 import ops as wkv_ops
    return {"bp_matmul": bp_ops.LAUNCHES["bp_matmul"],
            "bp_matmul_gemv": bp_ops.LAUNCHES["gemv"],
            "bp_matmul_tile": bp_ops.LAUNCHES["tile"],
            "paged_attention": pa_ops.LAUNCHES["paged_attention"],
            "routed_plain_int8_kv": pa_ops.ROUTED_PLAIN["int8_kv"],
            "wkv6": wkv_ops.LAUNCHES["wkv6"]}


def no_fault_guard(report, stream, phase: str) -> None:
    """A serve that injects nothing must show no fault, retry, recovery or
    failed request, and no degrade record but the pool-pressure rung's.
    The engine raises a kernel's own failure and never recovers from it;
    this guard holds every other fault to zero as well, so that no failure
    hides behind the recovery ladder as failed requests."""
    failed = [r.request_id for r in report.results
              if r.finish_reason == "failed"]
    degrades = sorted({r["action"] for r in stream if r["kind"] == "degrade"}
                      - {"shrink_lead_window"})
    check(report.n_faults == report.n_retries == report.n_recoveries == 0
          and not failed and not degrades,
          f"{phase}: a serve without injection saw {report.n_faults} "
          f"faults, {report.n_retries} retries, {report.n_recoveries} "
          f"recoveries, failed requests {failed}, degrades {degrades}: "
          f"{[r for r in stream if r['kind'] == 'fault'][:3]}")


def guarded_serve(engine, requests, **kw):
    """``engine.serve(requests, **kw)`` held to :func:`no_fault_guard`."""
    loop = engine.make_loop(requests, **kw)
    report = loop.run()
    no_fault_guard(report, loop.stream, "a serve")
    return report


def _requests(serving, rng, vocab: int, n: int):
    reqs = []
    for i in range(n):
        plen = int(rng.integers(16, 129))
        reqs.append(serving.Request(
            prompt=rng.integers(2, vocab, size=plen).astype("int32"),
            max_new_tokens=int(rng.integers(8, 33)),
            arrival_time=float(2 * i)))
    return reqs


def matmul_routes(stream, per_forward, head=0, verify_s=0):
    """The launches each of K1's routes should take in a serve, from its
    step stream: a prefill's ``per_forward`` projections take the tile
    kernel where its rows (group x padded length) exceed the GEMV's 8, a
    decode step's (one row per slot) the GEMV, a verify step's (``verify_s``
    rows per slot) the tiles where they exceed 8; an untied lm_head
    (``head`` calls per forward) runs on the last positions only, so the
    GEMV.  Also the most frequent prefill row count (the kernels line's
    shape)."""
    from repro_torch.kernels.bitparticle_matmul.ops import GEMV_MAX_M
    want, rows = {"gemv": 0, "tile": 0}, []
    for r in stream:
        if r["kind"] == "prefill":
            m = r["group_size"] * r["pad_to"]
            rows.append(m)
            want["tile" if m > GEMV_MAX_M else "gemv"] += per_forward
            want["gemv"] += head
        elif r["kind"] == "decode":
            want["gemv"] += per_forward + head
        elif r["kind"] == "verify":
            m = r["n_slots"] * verify_s
            want["tile" if m > GEMV_MAX_M else "gemv"] += per_forward
    common = max(set(rows), key=lambda m: (rows.count(m), m)) if rows else 0
    return want, common


def step_wall_rate(stream):
    """Tokens committed by decode and verify steps over the steps' whole
    host walls (drafting, block preparation and commits included), where
    ``decode_tokens_per_s`` divides by the device dispatch only."""
    steps = [r for r in stream if r["kind"] in ("decode", "verify")]
    wall = sum(r["wall_s"] for r in steps)
    return sum(r["committed_tokens"] for r in steps) / wall if wall else None


def build_model(torch):
    """Full-width, full-depth qwen2-1.5b in bp_exact: random weights from
    seed 0, every dense weight quantized to int8 once.  Both serve phases
    share them (the KV-cache layout is a serving choice, not a weight)."""
    from repro_torch.configs.base import get_arch
    from repro_torch.models import api
    from repro_torch.models.layers import quantize_dense_params

    cfg = get_arch("qwen2-1.5b").replace(matmul_mode="bp_exact")
    t0 = time.perf_counter()
    with torch.no_grad():
        params = quantize_dense_params(api.init(cfg, seed=0, device="cuda"))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return {"cfg": cfg, "params": params,
            "init_and_quantize_s": time.perf_counter() - t0,
            "param_bytes": sum(t.numel() * t.element_size()
                               for t in _leaves(params))}


def phase_serve(torch, gpu, model, n_requests=8, n_slots=4, lead_window=4):
    import numpy as np

    from repro_torch import serving
    from repro_torch.kernels.bitparticle_matmul import ops

    cfg = model["cfg"].replace(kv_cache_int8=True)
    params = model["params"]
    init_s, weight_bytes = model["init_and_quantize_s"], model["param_bytes"]
    scfg = serving.ServeConfig(max_new_tokens=32, temperature=0.0)
    engine = serving.ServingEngine(cfg, params, scfg, device="cuda")
    sched = serving.SchedulerConfig(lead_window=lead_window)
    rng = np.random.default_rng(0)
    prompts = _requests(serving, rng, cfg.vocab_size, n_requests)

    cache_T = max(r.prompt_len + r.max_new_tokens for r in prompts) + 8
    # warm-up serve (allocator, cuBLAS handles): not measured
    guarded_serve(engine, _copies(serving, prompts[:2]), n_slots=n_slots,
                 cache_T=cache_T, sched_cfg=sched)
    torch.cuda.synchronize()

    # -- the measured main-path run: counts zeroed just before, read after
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    loop = engine.make_loop(_copies(serving, prompts), n_slots=n_slots,
                            cache_T=cache_T, sched_cfg=sched)
    report = loop.run()
    no_fault_guard(report, loop.stream, "serve")
    torch.cuda.synchronize()
    launches = {"bp_matmul": ops.LAUNCHES["bp_matmul"],
                "bp_matmul_gemv": ops.LAUNCHES["gemv"],
                "bp_matmul_tile": ops.LAUNCHES["tile"]}
    n_prefill = sum(1 for r in loop.stream if r["kind"] == "prefill")
    expected = 7 * cfg.num_layers * (n_prefill + report.steps)
    routes, prefill_m = matmul_routes(loop.stream, 7 * cfg.num_layers)
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
    rep_plain = guarded_serve(plain, _copies(serving, prompts), n_slots=n_slots,
                            cache_T=cache_T, sched_cfg=sched)
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
        "bp_matmul_launches_by_route": {
            r: launches[f"bp_matmul_{r}"] for r in routes},
        "expected_launches_by_route": routes,
        "common_prefill_rows": prefill_m,
        "plain_backend_launches": plain_launches,
        "tokens_equal_plain_backend": toks == toks_plain,
        "generate_equal_serve": not flips,
        "generate_flips": flips,
        "decode_tokens_per_s": decode_tok_s,
        "step_wall_tokens_per_s": step_wall_rate(loop.stream),
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
    for r, want in routes.items():
        got = launches[f"bp_matmul_{r}"]
        check(got == want, f"bp_matmul's {r} route launched {got} times, "
                           f"expected {want}")
    check(plain_launches == 0, "the plain backend launched the kernel")
    check(toks == toks_plain, "kernel and plain-version serves disagree")
    bad = [f for f in flips if not f["near_tie"]]
    check(not bad, f"generate() differs from serve() beyond a near-tie: "
                   f"{bad}")
    return result, {**launches, "prefill_rows": prefill_m}, toks


def _paged_requests(serving, rng, vocab: int, n: int, system_len=256):
    """``n`` requests sharing one ``system_len``-token system prompt, each
    with 16-128 tokens of its own and 8-32 new tokens, arriving every two
    decode steps."""
    import numpy as np
    system = rng.integers(2, vocab, size=system_len)
    reqs = []
    for i in range(n):
        own = rng.integers(2, vocab, size=int(rng.integers(16, 129)))
        reqs.append(serving.Request(
            prompt=np.concatenate([system, own]).astype("int32"),
            max_new_tokens=int(rng.integers(8, 33)),
            arrival_time=float(2 * i)))
    return reqs


def phase_serve_paged(torch, gpu, model, n_requests=8, n_slots=4,
                      lead_window=4, block_size=16,
                      num_blocks=PAGED_NUM_BLOCKS):
    """The paged main path: bp_exact with a bf16 KV cache (an int8 cache
    would route attention to the plain gather, as the reference does), so
    every decode step's attention runs the paged-attention kernel and every
    projection the BitParticle matmul."""
    import numpy as np

    from repro_torch import serving

    cfg = model["cfg"].replace(kv_cache_int8=False)
    params = model["params"]

    def engine_for(c, backend="paged"):
        return serving.ServingEngine(
            c, params, serving.ServeConfig(max_new_tokens=32,
                                           temperature=0.0,
                                           cache_backend=backend,
                                           block_size=block_size),
            device="cuda")

    engine = engine_for(cfg)
    sched = serving.SchedulerConfig(lead_window=lead_window)
    prompts = _paged_requests(serving, np.random.default_rng(1),
                              cfg.vocab_size, n_requests)

    cache_T = max(r.prompt_len + r.max_new_tokens for r in prompts) + 8
    kw = dict(n_slots=n_slots, cache_T=cache_T, sched_cfg=sched)
    # warm-up serve (allocator): not measured
    guarded_serve(engine, _copies(serving, prompts[:2]),
                  num_blocks=num_blocks, **kw)
    torch.cuda.synchronize()

    # -- the measured main-path run: counts zeroed just before, read after
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    loop = engine.make_loop(_copies(serving, prompts), num_blocks=num_blocks,
                            **kw)
    # per-slot positions at every decode step (the kernels line's shape)
    step_lengths = []
    loop.on_step_end = lambda lp: step_lengths.append(
        lp.cm.cache_len_vector().tolist())
    report = loop.run()
    no_fault_guard(report, loop.stream, "serve_paged")
    torch.cuda.synchronize()
    launches = launch_counts()
    peak_mem_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    n_prefill = sum(1 for r in loop.stream if r["kind"] == "prefill")
    step_ms = [1e3 * r["wall_s"] for r in loop.stream
               if r["kind"] == "decode"]
    toks = {r.request_id: r.tokens.tolist() for r in report.results}
    routes, _ = matmul_routes(loop.stream, 7 * cfg.num_layers)
    expected = {"bp_matmul": 7 * cfg.num_layers * (n_prefill + report.steps),
                "bp_matmul_gemv": routes["gemv"],
                "bp_matmul_tile": routes["tile"],
                "paged_attention": cfg.num_layers * report.steps}

    # -- the same serve through the plain versions of both kernels, and the
    # slab store with the same bf16 KV cache
    reset_counts()
    rep_plain = guarded_serve(
        engine_for(cfg.replace(matmul_backend="plain")),
        _copies(serving, prompts), num_blocks=num_blocks, **kw)
    plain_launches = launch_counts()
    reset_counts()
    rep_slab = guarded_serve(engine_for(cfg, backend="slab"),
                             _copies(serving, prompts), **kw)
    reset_counts()
    flips = {}
    for name, rep in (("plain", rep_plain), ("slab", rep_slab)):
        other = {r.request_id: r.tokens.tolist() for r in rep.results}
        flips[name] = [
            _flip(torch, np, engine, prompts[i].prompt, toks[i], other[i],
                  cache_T, i, names=("paged", name))
            for i in toks if other[i] != toks[i]]
    profile = _profile_serve(
        torch, engine, [serving.Request(prompt=r.prompt.copy(),
                                        max_new_tokens=8,
                                        arrival_time=r.arrival_time)
                        for r in prompts[:2]], n_slots, cache_T, sched,
        num_blocks=num_blocks)
    reset_counts()

    p = serving.percentiles(step_ms, qs=(50, 90))
    result = {
        "phase": "serve_paged", "gpu": gpu, "model": cfg.name,
        "layers": cfg.num_layers, "d_model": cfg.d_model,
        "mode": cfg.matmul_mode, "kv_cache_int8": cfg.kv_cache_int8,
        "cache_backend": "paged", "block_size": block_size,
        "num_blocks": num_blocks,
        "blocks_per_seq": loop.cm.blocks_per_seq,
        "n_requests": n_requests, "system_prompt_tokens": 256,
        "n_slots": n_slots, "lead_window": lead_window, "cache_T": cache_T,
        "prefill_calls": n_prefill, "decode_steps": report.steps,
        "total_new_tokens": report.total_new_tokens,
        "launches": launches, "expected_launches": expected,
        "plain_backend_launches": plain_launches,
        "n_preemptions": report.n_preemptions,
        "prefix_hit_blocks": report.prefix_hit_blocks,
        "cow_blocks": report.cow_blocks,
        "peak_blocks_in_use": report.peak_blocks_in_use,
        "tokens_equal_plain_backend": not flips["plain"],
        "plain_flips": flips["plain"],
        "tokens_equal_slab": not flips["slab"],
        "slab_flips": flips["slab"],
        "decode_tokens_per_s": report.decode_tokens_per_s,
        "step_wall_tokens_per_s": step_wall_rate(loop.stream),
        "decode_step_ms_p50": p["p50"] if p else None,
        "decode_step_ms_p90": p["p90"] if p else None,
        "prefill_s": report.prefill_s, "decode_s": report.decode_s,
        "ttft_wall_s_by_request": [r.ttft_wall_s for r in report.results],
        "itl_wall_s": report.itl_wall,
        "peak_mem_gb": peak_mem_gb,
        "first_tokens": toks[0][:8],
        "profile": profile,
    }
    emit(result)
    check(all(r.finish_reason == "length" for r in report.results),
          "a paged request finished for another reason than length")
    check(all(0 <= t < cfg.vocab_padded for ts in toks.values() for t in ts),
          "a generated token lies outside the padded vocabulary")
    for name, want in expected.items():
        check(launches[name] == want,
              f"{name} launched {launches[name]} times on the paged path, "
              f"expected {want}")
    check(launches["routed_plain_int8_kv"] == 0,
          "paged attention was routed to the plain version")
    check(not any(v for k, v in plain_launches.items()
                  if k != "routed_plain_int8_kv"),
          f"the plain backend launched a kernel: {plain_launches}")
    check(report.prefix_hit_blocks > 0, "no prefix-sharing hit")
    check(report.n_preemptions >= 1, f"the pool of {num_blocks} blocks "
                                     f"never ran dry")
    for name, fl in flips.items():
        bad = [f for f in fl if not f["near_tie"]]
        check(not bad, f"paged and {name} serves differ beyond a near-tie: "
                       f"{bad}")
    # the kernels line's shape: the decode step whose total context is the
    # median of the run's full-batch steps
    full = [ls for ls in step_lengths if min(ls) > 0] or step_lengths
    shape = sorted(full, key=sum)[len(full) // 2]
    return result, launches, {"lengths": shape,
                              "pages_per_seq": loop.cm.blocks_per_seq}, toks


def span_recorder(serving):
    """A serving telemetry handle that records every span's name and
    arguments and otherwise does what the disabled handle does: the
    drafter's spans (``draft_prefill``, ``draft_propose``) say which
    forwards the draft model ran."""

    class SpanRecorder(serving.Telemetry):
        def __init__(self):
            super().__init__()
            self.spans = []

        def span(self, name, **args):
            self.spans.append((name, args))
            return super().span(name, **args)

    return SpanRecorder()


def draft_routes(spans, per_forward, k):
    """K1's launches on each route from the draft model's forwards: a
    ``draft_prefill`` runs its right-padded prompt (``pad_to`` rows) once,
    a ``draft_propose`` runs K+1 decode steps of one row per slot (the
    GEMV while the slots are at most 8)."""
    from repro_torch.kernels.bitparticle_matmul.ops import GEMV_MAX_M
    want = {"gemv": 0, "tile": 0}
    counts = {"draft_prefill": 0, "draft_propose": 0}
    for name, args in spans:
        if name == "draft_prefill":
            counts[name] += 1
            want["tile" if args["pad_to"] > GEMV_MAX_M
                 else "gemv"] += per_forward
        elif name == "draft_propose":
            counts[name] += 1
            want["gemv"] += (k + 1) * per_forward
    return want, counts


def _lookup_requests(serving, rng, vocab: int, n: int, phrase_len=16):
    """``n`` extractive / code-edit requests: a ``phrase_len``-token phrase
    repeated to 64-128 tokens, 16-32 new tokens each, all at once."""
    import numpy as np
    reqs = []
    for i in range(n):
        phrase = rng.integers(2, vocab, size=phrase_len)
        plen = int(rng.integers(64, 129))
        reqs.append(serving.Request(
            prompt=np.resize(phrase, plen).astype("int32"),
            max_new_tokens=int(rng.integers(16, 33)), request_id=i))
    return reqs


def _copies(serving, reqs, max_new_tokens=None):
    """Fresh requests with the prompts, budgets (or ``max_new_tokens``) and
    arrivals of ``reqs``, numbered in order."""
    return [serving.Request(prompt=r.prompt.copy(),
                            max_new_tokens=(max_new_tokens or
                                            r.max_new_tokens),
                            arrival_time=r.arrival_time, request_id=i)
            for i, r in enumerate(reqs)]


def _stream_flips(torch, np, engine, prompts, got, want, cache_T, names,
                  tie=0.0):
    """Every request whose two streams part, as ``_flip`` reports it."""
    return [_flip(torch, np, engine, prompts[i], got[i], want[i], cache_T, i,
                  names=names, tie=tie)
            for i in got if got[i] != want[i]]


def _spans(marks, t0):
    """Seconds between consecutive ``marks`` (name -> perf_counter), from
    ``t0``: where a phase's wall went."""
    out, last = {}, t0
    for name, t in marks.items():
        out[name] = t - last
        last = t
    return out


def phase_serve_spec(torch, gpu, model, base, base_toks, n_requests=8,
                     n_slots=4, lead_window=4, k=4):
    """The speculative main path: the ``serve`` phase's workload (slab
    store, int8 KV) with ``draft="model"``, K = ``k``, the draft being the
    target's own config and weights (a self-draft: the repository has no
    draft checkpoint), then a shorter ``draft="prompt_lookup"`` run on
    repeated-phrase prompts.  Verify steps run K1's tiles (M = slots x
    (K+1)), the draft's decode steps its GEMV (M = slots), and paged
    attention never runs."""
    import numpy as np

    from repro_torch import serving

    cfg = model["cfg"].replace(kv_cache_int8=True)
    params = model["params"]
    per_forward = 7 * cfg.num_layers

    def engine_for(c, draft, telemetry=None):
        kw = (dict(draft_cfg=c, draft_params=params) if draft == "model"
              else {})
        return serving.ServingEngine(
            c, params, serving.ServeConfig(max_new_tokens=32,
                                           temperature=0.0, draft=draft,
                                           num_draft_tokens=k,
                                           telemetry=telemetry),
            device="cuda", **kw)

    def expected(loop, spans):
        routes, _ = matmul_routes(loop.stream, per_forward,
                                  verify_s=k + 1)
        d_routes, d_counts = draft_routes(spans, per_forward, k)
        want = {"bp_matmul_gemv": routes["gemv"] + d_routes["gemv"],
                "bp_matmul_tile": routes["tile"] + d_routes["tile"],
                "paged_attention": 0}
        want["bp_matmul"] = want["bp_matmul_gemv"] + want["bp_matmul_tile"]
        return want, d_counts

    prompts = _requests(serving, np.random.default_rng(0), cfg.vocab_size,
                        n_requests)
    cache_T = max(r.prompt_len + r.max_new_tokens for r in prompts) + 8
    sched = serving.SchedulerConfig(lead_window=lead_window)
    kw = dict(n_slots=n_slots, cache_T=cache_T, sched_cfg=sched)
    t_phase, marks = time.perf_counter(), {}
    tel = span_recorder(serving)
    engine = engine_for(cfg, "model", tel)
    # warm-up serve (allocator): not measured
    guarded_serve(engine, _copies(serving, prompts[:2], 8), **kw)
    torch.cuda.synchronize()
    marks["warm_up"] = time.perf_counter()

    # -- the measured main-path run: counts zeroed just before, read after
    tel.spans.clear()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    loop = engine.make_loop(_copies(serving, prompts), **kw)
    report = loop.run()
    no_fault_guard(report, loop.stream, "serve_spec")
    torch.cuda.synchronize()
    launches = launch_counts()
    want, d_counts = expected(loop, tel.spans)
    peak_mem_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    toks = {r.request_id: r.tokens.tolist() for r in report.results}
    n_prefill = sum(1 for r in loop.stream if r["kind"] == "prefill")
    step_ms = [1e3 * r["wall_s"] for r in loop.stream
               if r["kind"] == "verify"]
    draft_ms = [1e3 * r["phases"]["draft_s"] for r in loop.stream
                if r["kind"] == "verify"]
    marks["main"] = time.perf_counter()

    # -- the same speculative serve through the plain versions
    reset_counts()
    plain = engine_for(cfg.replace(matmul_backend="plain"), "model")
    rep_plain = guarded_serve(plain, _copies(serving, prompts), **kw)
    plain_launches = launch_counts()
    reset_counts()
    raw = [r.prompt for r in prompts]
    flips = {
        "serve": _stream_flips(torch, np, engine, raw, toks, base_toks,
                               cache_T, ("spec", "serve")),
        "plain": _stream_flips(
            torch, np, engine, raw, toks,
            {r.request_id: r.tokens.tolist() for r in rep_plain.results},
            cache_T, ("spec", "plain"))}
    reset_counts()
    marks["plain_and_flips"] = time.perf_counter()
    # a profiled serve of one request and 4 new tokens (one proposal, one
    # verify step): the profiler's post-processing grows with the ~5,000
    # kernels of every forward, and a step here runs K+2 forwards
    profile = _profile_serve(torch, engine, _copies(serving, prompts[:1], 4),
                             n_slots, cache_T, sched)
    reset_counts()
    marks["profile"] = time.perf_counter()

    # -- prompt lookup on repeated-phrase prompts, against a plain decode
    # of the same prompts
    look = _lookup_requests(serving, np.random.default_rng(3),
                            cfg.vocab_size, n_slots)
    l_kw = dict(n_slots=n_slots, sched_cfg=sched,
                cache_T=max(r.prompt_len + r.max_new_tokens
                            for r in look) + 8)
    l_engine = engine_for(cfg, "prompt_lookup")
    reset_counts()
    l_loop = l_engine.make_loop(_copies(serving, look), **l_kw)
    l_rep = l_loop.run()
    no_fault_guard(l_rep, l_loop.stream, "serve_spec")
    torch.cuda.synchronize()
    l_launches = launch_counts()
    l_routes, _ = matmul_routes(l_loop.stream, per_forward, verify_s=k + 1)
    l_want = {"bp_matmul_gemv": l_routes["gemv"],
              "bp_matmul_tile": l_routes["tile"], "paged_attention": 0,
              "bp_matmul": l_routes["gemv"] + l_routes["tile"]}
    reset_counts()
    l_base_loop = engine_for(cfg, "none").make_loop(_copies(serving, look),
                                                    **l_kw)
    l_base = l_base_loop.run()
    no_fault_guard(l_base, l_base_loop.stream, "serve_spec")
    reset_counts()
    l_toks = {r.request_id: r.tokens.tolist() for r in l_rep.results}
    l_flips = _stream_flips(
        torch, np, engine, [r.prompt for r in look], l_toks,
        {r.request_id: r.tokens.tolist() for r in l_base.results},
        l_kw["cache_T"], ("lookup", "serve"))
    marks["prompt_lookup"] = time.perf_counter()

    p = serving.percentiles(step_ms, qs=(50, 90))
    result = {
        "phase": "serve_spec", "gpu": gpu, "model": cfg.name,
        "layers": cfg.num_layers, "d_model": cfg.d_model,
        "mode": cfg.matmul_mode, "kv_cache_int8": cfg.kv_cache_int8,
        "cache_backend": "slab", "draft": report.draft,
        "draft_model": "self-draft (the target's config and weights)",
        "num_draft_tokens": k, "n_requests": n_requests,
        "n_slots": n_slots, "lead_window": lead_window, "cache_T": cache_T,
        "prefill_calls": n_prefill, "verify_steps": report.steps,
        "serve_decode_steps": base["decode_steps"],
        "draft_prefills": d_counts["draft_prefill"],
        "propose_calls": d_counts["draft_propose"],
        "drafted_tokens": report.drafted_tokens,
        "accepted_tokens": report.accepted_tokens,
        "acceptance_rate": report.acceptance_rate,
        "committed_tokens_per_step": report.committed_tokens_per_step,
        "total_new_tokens": report.total_new_tokens,
        "launches": launches, "expected_launches": want,
        "plain_backend_launches": plain_launches,
        "tokens_equal_serve": not flips["serve"],
        "serve_flips": flips["serve"],
        "tokens_equal_plain_backend": not flips["plain"],
        "plain_flips": flips["plain"],
        "decode_tokens_per_s": report.decode_tokens_per_s,
        "serve_decode_tokens_per_s": base["decode_tokens_per_s"],
        "step_wall_tokens_per_s": step_wall_rate(loop.stream),
        "serve_step_wall_tokens_per_s": base["step_wall_tokens_per_s"],
        "verify_step_ms_p50": p["p50"] if p else None,
        "verify_step_ms_p90": p["p90"] if p else None,
        "draft_ms_p50": serving.percentiles(draft_ms, qs=(50,))["p50"],
        "ttft_wall_s_by_request": [r.ttft_wall_s for r in report.results],
        "prefill_s": report.prefill_s, "decode_s": report.decode_s,
        "peak_mem_gb": peak_mem_gb,
        "phase_wall_s": _spans(marks, t_phase),
        "profile": profile,
        "prompt_lookup": {
            "n_requests": len(look), "phrase_tokens": 16,
            "prompt_lens": [r.prompt_len for r in look],
            "verify_steps": l_rep.steps, "decode_steps": l_base.steps,
            "drafted_tokens": l_rep.drafted_tokens,
            "accepted_tokens": l_rep.accepted_tokens,
            "acceptance_rate": l_rep.acceptance_rate,
            "committed_tokens_per_step": l_rep.committed_tokens_per_step,
            "decode_tokens_per_s": l_rep.decode_tokens_per_s,
            "serve_decode_tokens_per_s": l_base.decode_tokens_per_s,
            "step_wall_tokens_per_s": step_wall_rate(l_loop.stream),
            "serve_step_wall_tokens_per_s": step_wall_rate(
                l_base_loop.stream),
            "launches": l_launches, "expected_launches": l_want,
            "tokens_equal_serve": not l_flips, "serve_flips": l_flips},
    }
    emit(result)
    for rep in (report, l_rep):
        check(all(r.finish_reason == "length" for r in rep.results),
              "a speculative request finished for another reason than "
              "length")
    check(all(0 <= t < cfg.vocab_padded for ts in toks.values() for t in ts),
          "a generated token lies outside the padded vocabulary")
    for got, exp, what in ((launches, want, "self-draft"),
                           (l_launches, l_want, "prompt-lookup")):
        for name, n in exp.items():
            check(got[name] == n, f"{name} launched {got[name]} times in "
                                  f"the {what} serve, expected {n}")
    check(d_counts["draft_propose"] > 0, "the draft model never proposed")
    check(not any(plain_launches.values()),
          f"the plain backend launched a kernel: {plain_launches}")
    check(report.steps < base["decode_steps"],
          f"the self-draft took {report.steps} verify steps, not fewer "
          f"than the serve's {base['decode_steps']} decode steps")
    check(report.committed_tokens_per_step > 1.0,
          "the self-draft committed one token per step or fewer")
    for name, fl in (*flips.items(), ("prompt-lookup", l_flips)):
        bad = [f for f in fl if not f["near_tie"]]
        check(not bad, f"speculative and {name} serves differ beyond a "
                       f"near-tie: {bad}")
    return result, launches


def paged_decode_gap(torch, engine, prompts, n_steps=4):
    """How far the paged-attention kernel and its plain version move the
    logits: the same prompts prefilled into two paged stores, then
    ``n_steps`` decode steps on each, one through the kernel and one
    through the plain version (K1 is bit-exact on both, so K2's rounding,
    carried through 28 layers of bf16 and int8 activation quantization, is
    the only difference), each fed the kernel path's argmax.  Returns the
    largest logit difference over every step, row and vocabulary entry:
    how far two correct evaluations of one decode step may part."""
    import numpy as np

    from repro_torch import serving
    from repro_torch.models import api
    cfg = engine.cfg
    ex = engine.executor
    dev = ex.device
    bs = engine.serve_cfg.block_size
    cache_T = max(len(p) for p in prompts) + n_steps + bs
    slots = list(range(len(prompts)))
    cms = []
    for c in (cfg, cfg.replace(matmul_backend="plain")):
        cm = serving.make_cache_manager(cfg, len(prompts), cache_T,
                                        backend="paged", block_size=bs,
                                        executor=ex)
        for p in prompts:
            _, src = ex.prefill({"tokens": p[None]}, cm.prefill_T)
            cm.insert(cm.alloc(), src, len(p), tokens=p)
        cms.append((cm, c))
    feed = np.asarray([p[-1] for p in prompts], np.int64)
    gap = 0.0
    with torch.no_grad():
        for _ in range(n_steps):
            out = []
            for cm, c in cms:
                check(cm.prepare_append(slots) is None,
                      "the gap measurement's pool ran dry")
                batch = {"tokens": torch.as_tensor(feed[:, None],
                                                   device=dev),
                         "cache": cm.pages,
                         "cache_len": torch.as_tensor(
                             cm.lengths.astype(np.int64), device=dev),
                         "block_tables": cm.block_tables_device()}
                logits, _ = api.decode_step_paged(engine.params, c, batch)
                cm.advance(slots)
                out.append(logits.float())
            gap = max(gap, (out[0] - out[1]).abs().max().item())
            feed = out[0].argmax(-1).cpu().numpy()
    return gap


def phase_serve_chunked(torch, gpu, model, base, base_toks, n_requests=8,
                        n_slots=4, lead_window=4, block_size=16,
                        num_blocks=PAGED_NUM_BLOCKS, chunk=64):
    """Chunked prefill on the paged main path: the ``serve_paged`` phase's
    workload and pool with ``prefill_chunk=chunk`` and no drafter.  A
    prompt is admitted on its first ``chunk`` tokens; the rest rides verify
    steps of ``chunk`` rows per slot (K1's tiles); steps that carry no
    chunk are classic paged decodes (K1's GEMV and paged attention)."""
    import numpy as np

    from repro_torch import serving

    cfg = model["cfg"].replace(kv_cache_int8=False)
    params = model["params"]
    per_forward = 7 * cfg.num_layers

    def engine_for(c):
        return serving.ServingEngine(
            c, params, serving.ServeConfig(max_new_tokens=32,
                                           temperature=0.0,
                                           cache_backend="paged",
                                           block_size=block_size,
                                           prefill_chunk=chunk),
            device="cuda")

    prompts = _paged_requests(serving, np.random.default_rng(1),
                              cfg.vocab_size, n_requests)
    cache_T = max(r.prompt_len + r.max_new_tokens for r in prompts) + 8
    kw = dict(n_slots=n_slots, cache_T=cache_T, num_blocks=num_blocks,
              sched_cfg=serving.SchedulerConfig(lead_window=lead_window))
    t_phase, marks = time.perf_counter(), {}
    engine = engine_for(cfg)
    guarded_serve(engine, _copies(serving, prompts[:2], 8), **kw)  # warm-up
    torch.cuda.synchronize()
    marks["warm_up"] = time.perf_counter()

    # -- the measured main-path run: counts zeroed just before, read after
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    loop = engine.make_loop(_copies(serving, prompts), **kw)
    report = loop.run()
    no_fault_guard(report, loop.stream, "serve_chunked")
    torch.cuda.synchronize()
    launches = launch_counts()
    peak_mem_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    toks = {r.request_id: r.tokens.tolist() for r in report.results}
    kinds = [r["kind"] for r in loop.stream]
    n_decode, n_verify = kinds.count("decode"), kinds.count("verify")
    routes, _ = matmul_routes(loop.stream, per_forward, verify_s=chunk)
    want = {"bp_matmul": per_forward * (kinds.count("prefill") + n_decode
                                        + n_verify),
            "bp_matmul_gemv": routes["gemv"],
            "bp_matmul_tile": routes["tile"],
            "paged_attention": cfg.num_layers * n_decode}
    marks["main"] = time.perf_counter()

    # -- the same chunked serve through the plain versions
    reset_counts()
    rep_plain = guarded_serve(
        engine_for(cfg.replace(matmul_backend="plain")),
        _copies(serving, prompts), **kw)
    plain_launches = launch_counts()
    reset_counts()
    raw = [r.prompt for r in prompts]
    # the kernel and plain serves differ only in paged attention's rounding
    # (K1 is bit-exact): a flip between them is a near-tie when its logits
    # lie within the gap two evaluations of a decode step show
    gap = paged_decode_gap(torch, engine, raw[:n_slots])
    reset_counts()
    flips = {
        "serve_paged": _stream_flips(torch, np, engine, raw, toks, base_toks,
                                     cache_T, ("chunked", "one_shot")),
        "plain": _stream_flips(
            torch, np, engine, raw, toks,
            {r.request_id: r.tokens.tolist() for r in rep_plain.results},
            cache_T, ("chunked", "plain"), tie=gap)}
    marks["plain_and_flips"] = time.perf_counter()

    step_ms = {kind: [1e3 * r["wall_s"] for r in loop.stream
                      if r["kind"] == kind] for kind in ("decode", "verify")}
    pct = {kind: serving.percentiles(v, qs=(50, 90))
           for kind, v in step_ms.items()}
    result = {
        "phase": "serve_chunked", "gpu": gpu, "model": cfg.name,
        "layers": cfg.num_layers, "d_model": cfg.d_model,
        "mode": cfg.matmul_mode, "kv_cache_int8": cfg.kv_cache_int8,
        "cache_backend": "paged", "block_size": block_size,
        "num_blocks": num_blocks, "prefill_chunk": chunk,
        "n_requests": n_requests, "n_slots": n_slots,
        "lead_window": lead_window, "cache_T": cache_T,
        "prefill_calls": kinds.count("prefill"),
        "verify_steps": n_verify, "decode_steps": n_decode,
        "steps": report.steps, "serve_paged_steps": base["decode_steps"],
        "chunk_tokens": report.chunk_tokens,
        "total_new_tokens": report.total_new_tokens,
        "n_preemptions": report.n_preemptions,
        "serve_paged_preemptions": base["n_preemptions"],
        "prefix_hit_blocks": report.prefix_hit_blocks,
        "cow_blocks": report.cow_blocks,
        "peak_blocks_in_use": report.peak_blocks_in_use,
        "launches": launches, "expected_launches": want,
        "plain_backend_launches": plain_launches,
        "tokens_equal_serve_paged": not flips["serve_paged"],
        "serve_paged_flips": flips["serve_paged"],
        "tokens_equal_plain_backend": not flips["plain"],
        "plain_flips": flips["plain"],
        "kernel_vs_plain_decode_logit_gap": gap,
        "ttft_wall_s_by_request": [r.ttft_wall_s for r in report.results],
        "serve_paged_ttft_wall_s_by_request":
            base["ttft_wall_s_by_request"],
        "decode_tokens_per_s": report.decode_tokens_per_s,
        "serve_paged_decode_tokens_per_s": base["decode_tokens_per_s"],
        "step_wall_tokens_per_s": step_wall_rate(loop.stream),
        "serve_paged_step_wall_tokens_per_s":
            base["step_wall_tokens_per_s"],
        **{f"{kind}_step_ms_p{q}": (v[f"p{q}"] if v else None)
           for kind, v in pct.items() for q in (50, 90)},
        "prefill_s": report.prefill_s, "decode_s": report.decode_s,
        "peak_mem_gb": peak_mem_gb,
        "phase_wall_s": _spans(marks, t_phase),
    }
    emit(result)
    check(all(r.finish_reason == "length" for r in report.results),
          "a chunked request finished for another reason than length")
    check(all(0 <= t < cfg.vocab_padded for ts in toks.values() for t in ts),
          "a generated token lies outside the padded vocabulary")
    for name, n in want.items():
        check(launches[name] == n, f"{name} launched {launches[name]} times "
                                   f"in the chunked serve, expected {n}")
    check(launches["routed_plain_int8_kv"] == 0,
          "paged attention was routed to the plain version")
    check(n_verify > 0 and report.chunk_tokens > 0,
          "no prompt was fed through a chunk step")
    check(not any(v for k, v in plain_launches.items()
                  if k != "routed_plain_int8_kv"),
          f"the plain backend launched a kernel: {plain_launches}")
    for name, fl in flips.items():
        bad = [f for f in fl if not f["near_tie"]]
        check(not bad, f"chunked and {name} serves differ beyond a "
                       f"near-tie: {bad}")
    return result, launches


def _check_nesting(spans):
    """Every Chrome-trace span lies inside each span it overlaps (one host
    thread): the ``Tracer``'s nesting property, on the written file."""
    spans = sorted(spans, key=lambda e: (e["ts"], -e["dur"]))
    for i, a in enumerate(spans):
        for b in spans[i + 1:]:
            if b["ts"] >= a["ts"] + a["dur"]:
                break
            if b["ts"] + b["dur"] > a["ts"] + a["dur"] + 1e-3:
                return f"{b['name']} at {b['ts']} leaves {a['name']}"
    return None


def phase_serve_probe(torch, gpu, model, base, base_toks, base_launches,
                      n_requests=8, n_slots=4, lead_window=4, block_size=16,
                      num_blocks=PAGED_NUM_BLOCKS):
    """The paged main path with the hardware-cost probe on: the
    ``serve_paged`` workload and pool, ``SparsityProbe(probe_every=1)``
    and a ``Telemetry`` writing the metrics JSONL and the Chrome trace.
    Every admission prefill and every decode step runs its probed variant
    (the stats reductions are plain PyTorch operations beside K1 and K2),
    and each sample is priced through the paper's cost models into an
    ``hw_estimate`` record.  Then a one-request serve with ``profile_dir``
    writes a ``torch.profiler`` trace."""
    import dataclasses
    import tempfile

    import numpy as np

    from repro_torch import serving
    from repro_torch.serving.telemetry import STEP_SCHEMA

    cfg = model["cfg"].replace(kv_cache_int8=False)
    t_phase, marks = time.perf_counter(), {}
    probe = serving.SparsityProbe(probe_every=1)
    t0 = time.perf_counter()
    engine = serving.ServingEngine(
        cfg, model["params"], serving.ServeConfig(
            max_new_tokens=32, temperature=0.0, cache_backend="paged",
            block_size=block_size, probe=probe), device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0          # the weight profile inside
    t0 = time.perf_counter()
    deployment = engine.deployment_estimate()
    deployment_s = time.perf_counter() - t0
    marks["engine"] = time.perf_counter()
    # the host time of every fold (a sampled step's pricing)
    fold_s = []
    fold = probe.fold

    def timed_fold(*a, **kw):
        t = time.perf_counter()
        out = fold(*a, **kw)
        fold_s.append(time.perf_counter() - t)
        return out

    probe.fold = timed_fold
    prompts = _paged_requests(serving, np.random.default_rng(1),
                              cfg.vocab_size, n_requests)
    cache_T = max(r.prompt_len + r.max_new_tokens for r in prompts) + 8
    kw = dict(n_slots=n_slots, cache_T=cache_T, num_blocks=num_blocks,
              sched_cfg=serving.SchedulerConfig(lead_window=lead_window))
    # warm-up serve (allocator; builds the probe's cycle tables): not
    # measured
    guarded_serve(engine, _copies(serving, prompts[:2], 8), **kw)
    torch.cuda.synchronize()
    cold_fold_s = fold_s[0]
    fold_s.clear()
    marks["warm_up"] = time.perf_counter()

    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        tel = serving.Telemetry(metrics_path=str(tmp / "metrics.jsonl"),
                                trace_path=str(tmp / "trace.json"))
        engine.serve_cfg = dataclasses.replace(engine.serve_cfg,
                                               telemetry=tel)
        # -- the measured main-path run: counts zeroed just before, read
        # after
        reset_counts()
        loop = engine.make_loop(_copies(serving, prompts), **kw)
        report = loop.run()
        no_fault_guard(report, loop.stream, "serve_probe")
        torch.cuda.synchronize()
        launches = launch_counts()
        tel.close()
        marks["main"] = time.perf_counter()
        records = serving.read_jsonl(str(tmp / "metrics.jsonl"))
        trace = json.loads((tmp / "trace.json").read_text())
        t0 = time.perf_counter()
        folded = serving.reduce_stream(records)
        reduce_s = time.perf_counter() - t0

        # -- one request under torch.profiler, through profile_dir
        prof_tel = serving.Telemetry(profile_dir=str(tmp / "prof"),
                                     annotate_device=True)
        engine.serve_cfg = dataclasses.replace(engine.serve_cfg,
                                               telemetry=prof_tel)
        # one prefill (K1's tiles) and one decode step (its GEMV)
        guarded_serve(engine, _copies(serving, prompts[:1], 2), **kw)
        reset_counts()
        prof_names = set()
        for path in prof_tel.profile_paths:
            prof_names |= {str(e.get("name", "")) for e in
                           json.loads(pathlib.Path(path).read_text())
                           ["traceEvents"]}
        marks["profile_dir"] = time.perf_counter()

    toks = {r.request_id: r.tokens.tolist() for r in report.results}
    kinds = [r["kind"] for r in loop.stream]
    hw = [r for r in loop.stream if r["kind"] == "hw_estimate"]
    n_prefill = kinds.count("prefill")
    step_ms = [1e3 * r["wall_s"] for r in loop.stream
               if r["kind"] == "decode"]
    # the probe's only device-to-host traffic: one (L, 3) float32 array
    # per sample (qwen2 ties its lm head: no tail row)
    probe_d2h = len(hw) * cfg.num_layers * 3 * 4
    hwm, prof = report.hw_measured, engine.weight_sparsity_profile()
    fold_hw = {"n_samples": folded.n_hw_samples,
               "probe_every": probe.probe_every,
               "act_bit_sparsity": folded.hw_act_bit_sparsity
               / max(folded.n_hw_samples, 1),
               "act_value_sparsity": folded.hw_act_value_sparsity
               / max(folded.n_hw_samples, 1),
               "weight_bit_sparsity": folded.hw_weight_bit_sparsity
               / max(folded.n_hw_samples, 1),
               "array_utilization": folded.hw_array_utilization
               / max(folded.n_hw_samples, 1),
               "cycles": {k: v / max(folded.n_hw_samples, 1)
                          for k, v in folded.hw_cycles.items()},
               "mac_energy_pj": {k: v / max(folded.n_hw_samples, 1)
                                 for k, v in folded.hw_mac_energy_pj.items()}}
    fold_equal = (fold_hw == hwm and all(
        getattr(report, f) == getattr(folded, f)
        for f in ("prefill_s", "decode_s", "steps", "n_syncs",
                  "total_new_tokens", "slot_utilization", "max_divergence",
                  "n_preemptions", "prefix_hit_blocks", "cow_blocks",
                  "peak_blocks_in_use", "n_degrades")))
    bad_schema = [r["kind"] for r in records
                  if not STEP_SCHEMA.get(r["kind"], set()) <= set(r)]
    spans = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    nesting = _check_nesting(spans)
    rates = {"act_bit_sparsity": hwm["act_bit_sparsity"],
             "act_value_sparsity": hwm["act_value_sparsity"],
             "weight_bit_sparsity": hwm["weight_bit_sparsity"],
             "weight_value_sparsity": prof["value_sparsity"],
             "array_utilization": hwm["array_utilization"],
             "deployment_mean_bit_sparsity": deployment["mean_bit_sparsity"]}
    k1_in_profile = sorted({n for n in prof_names for sym in
                            KERNEL_SYMBOLS["bp_matmul_gemv"]
                            + KERNEL_SYMBOLS["bp_matmul_tile"]
                            if sym in n})
    p = serving.percentiles(step_ms, qs=(50, 90))
    pf = serving.percentiles(fold_s, qs=(50, 90))
    compared = ("bp_matmul", "bp_matmul_gemv", "bp_matmul_tile",
                "paged_attention")
    marks["checks"] = time.perf_counter()
    result = {
        "phase": "serve_probe", "gpu": gpu, "model": cfg.name,
        "layers": cfg.num_layers, "d_model": cfg.d_model,
        "mode": cfg.matmul_mode, "kv_cache_int8": cfg.kv_cache_int8,
        "cache_backend": "paged", "block_size": block_size,
        "num_blocks": num_blocks, "n_requests": n_requests,
        "n_slots": n_slots, "probe_every": probe.probe_every,
        "prefill_calls": n_prefill, "decode_steps": report.steps,
        "hw_estimate_records": len(hw),
        "launches": launches,
        "serve_paged_launches": {k: base_launches[k] for k in compared},
        "tokens_equal_serve_paged": toks == base_toks,
        "measured_sparsity": rates,
        "per_layer_act_bit_sparsity_first_prefill":
            hw[0]["per_layer_act_bit_sparsity"] if hw else None,
        "weight_per_layer_bit_sparsity": prof["per_layer_bit_sparsity"],
        "modeled_cycles_per_mac": hwm["cycles"],
        "modeled_mac_energy_pj": hwm["mac_energy_pj"],
        "deployment": {k: deployment[k] for k in (
            "mode", "mean_bit_sparsity", "mean_cycles_per_mac",
            "mean_mac_energy_pj")},
        "array_utilization": hwm["array_utilization"],
        "cost_hint_cycles_per_token": loop.cost_hint_cycles_per_token,
        "decode_step_ms_p50": p["p50"] if p else None,
        "decode_step_ms_p90": p["p90"] if p else None,
        "serve_paged_decode_step_ms_p50": base["decode_step_ms_p50"],
        "serve_paged_decode_step_ms_p90": base["decode_step_ms_p90"],
        "decode_tokens_per_s": report.decode_tokens_per_s,
        "serve_paged_decode_tokens_per_s": base["decode_tokens_per_s"],
        "fold_ms_p50": 1e3 * pf["p50"] if pf else None,
        "fold_ms_p90": 1e3 * pf["p90"] if pf else None,
        "first_fold_s": cold_fold_s,
        "deployment_estimate_s": deployment_s,
        "engine_build_s": build_s,
        "reduce_stream_ms": 1e3 * reduce_s,
        "d2h_bytes": folded.d2h_bytes,
        "probe_d2h_bytes": probe_d2h,
        "records": len(records), "trace_spans": len(spans),
        "report_equals_file_fold": fold_equal,
        "k1_kernels_in_profile": k1_in_profile,
        "profile_files": len(prof_tel.profile_paths),
        "phase_wall_s": _spans(marks, t_phase),
        "phase_total_s": time.perf_counter() - t_phase,
    }
    emit(result)
    check(toks == base_toks, "the probed serve's tokens differ from "
                             "serve_paged's")
    for name in compared:
        check(launches[name] == base_launches[name],
              f"{name} launched {launches[name]} times in the probed serve, "
              f"{base_launches[name]} in serve_paged")
    check(launches["routed_plain_int8_kv"] == 0,
          "paged attention was routed to the plain version")
    check(len(hw) == n_prefill + report.steps,
          f"{len(hw)} hw_estimate records for {n_prefill} prefills and "
          f"{report.steps} steps")
    check(not bad_schema, f"records miss schema keys: {bad_schema}")
    check(records == loop.stream, "the metrics file differs from the "
                                  "live records")
    check(fold_equal, "the report differs from the fold of the written "
                      "JSONL")
    check(nesting is None and spans, f"trace spans do not nest: {nesting}")
    check(report.deployment is not None and hwm is not None,
          "deployment or hw_measured missing from the report")
    check(all(0.0 <= v <= 1.0 for v in rates.values()),
          f"a rate lies outside [0, 1]: {rates}")
    check(all(0.0 <= e["bit_sparsity"] <= 1.0
              for e in deployment["per_layer"]),
          "a layer's weight bit sparsity lies outside [0, 1]")
    check(loop.cost_hint_cycles_per_token > 0, "no cost hint")
    check(bool(k1_in_profile), "K1's kernel is missing from the "
                               "torch.profiler trace")
    return result, launches


#: serve_chaos's seeded run: the reference chaos benchmark's rates
#: (``benchmarks/chaos_smoke.py``), at most 10 faults
CHAOS_RATES = {"step": 0.05, "prefill": 0.05, "pool": 0.05, "oom": 0.03,
               "nan": 0.01, "drafter": 0.10, "cancel": 0.01}
#: serve_chaos's watchdog run: the injected spike and the budget it breaks
CHAOS_SLOW_S = 3.0
CHAOS_STEP_TIMEOUT_S = 1.5


def _stream_parts(torch, np, engine, prompts, got, want, cache_T, names,
                  partial=()):
    """:func:`_stream_flips` where the requests in ``partial`` (cancelled
    or failed early) are held to a prefix of ``want`` only."""
    return [_flip(torch, np, engine, prompts[i], got[i], want[i], cache_T, i,
                  names=names)
            for i in got
            if got[i] != (want[i][:len(got[i])] if i in partial
                          else want[i])]


def _kind_counts(stream):
    out = {}
    for r in stream:
        out[r["kind"]] = out.get(r["kind"], 0) + 1
    return out


def _step_deltas(stream, per_step):
    """Per loop iteration: the kinds of the records it emitted and the
    launches it made (``per_step``: the stream's length and the launch
    counts after each iteration, counted from zero)."""
    out, prev_n, prev = [], 0, None
    for n, counts in per_step:
        prev = prev or {k: 0 for k in counts}
        out.append(({r["kind"] for r in stream[prev_n:n]},
                    {k: counts[k] - prev[k] for k in counts}))
        prev_n, prev = n, counts
    return out


def _join_watchdogs(threading, timeout_s=60.0):
    """Wait for every watchdog worker the serves abandoned: their late
    launches must not land in a later phase's counts."""
    workers = [t for t in threading.enumerate()
               if t.name.startswith("serve-watchdog")]
    for t in workers:
        t.join(timeout=timeout_s)
    return [t.name for t in workers if t.is_alive()]


def phase_serve_chaos(torch, gpu, model, base, base_toks, n_requests=8,
                      n_slots=4, lead_window=4, block_size=16,
                      num_blocks=PAGED_NUM_BLOCKS, k=3):
    """Fault injection and the recovery ladder on the paged main path (the
    ``serve_paged`` workload and pool, bp_exact, bf16 KV), in three runs:

      chaos     ``draft="prompt_lookup"``, K 3, under the reference chaos
                benchmark's seeded injector; survivors must equal a
                fault-free prompt-lookup serve except near-tie flips, a
                cancelled or failed stream a prefix of it, every injection
                must be in the stream, no block may stay live, and K1 must
                launch on the run's last step.  Verify steps take the dense
                gather, so K2 runs only on classic decodes (after the
                drafter rung), exactly once per layer each;
      kernel    no drafter, two scheduled step faults and no retry: the
                second recovery takes the kernel rung, one
                ``plain_fallback`` degrade, after which K1 and K2 never
                launch again in that serve, and the engine's executor keeps
                its backend; tokens equal ``serve_paged``'s except
                near-tie flips (K2 against its plain version);
      watchdog  no drafter, one 3 s latency spike against a 1.5 s budget:
                one ``StepTimeout`` fault, one recovery, tokens equal
                ``serve_paged``'s except near-tie flips.

    Prints every run's record counts and the recoveries' wall times (the
    ``recover`` call, then the replay prefill after it)."""
    import threading

    import numpy as np

    from repro_torch import serving

    cfg = model["cfg"].replace(kv_cache_int8=False)
    params = model["params"]
    L = cfg.num_layers
    prompts = _paged_requests(serving, np.random.default_rng(1),
                              cfg.vocab_size, n_requests)
    raw = [r.prompt for r in prompts]
    cache_T = max(r.prompt_len + r.max_new_tokens for r in prompts) + 8

    def loop_for(draft="none", **scfg):
        engine = serving.ServingEngine(
            cfg, params, serving.ServeConfig(
                max_new_tokens=32, temperature=0.0, cache_backend="paged",
                block_size=block_size, draft=draft, num_draft_tokens=k,
                **scfg), device="cuda")
        return engine.make_loop(
            _copies(serving, prompts), n_slots=n_slots, cache_T=cache_T,
            num_blocks=num_blocks,
            sched_cfg=serving.SchedulerConfig(lead_window=lead_window))

    def run(loop):
        """Serve, with the launch counts after every loop iteration and
        the wall time of every ``recover`` call."""
        per_step, recover_s = [], []
        recover = loop.recover

        def timed_recover(error):
            t0 = time.perf_counter()
            recover(error)
            recover_s.append(time.perf_counter() - t0)

        loop.recover = timed_recover
        loop.on_step_end = lambda lp: per_step.append(
            (len(lp.stream), launch_counts()))
        reset_counts()
        report = loop.run()
        torch.cuda.synchronize()
        return report, per_step, recover_s

    def summary(loop, report, recover_s):
        # each recovery's replay prefill: the first prefill record after
        # it, unless another recovery came first
        replay, since = [], None
        for r in loop.stream:
            if r["kind"] == "recover":
                if since is not None:
                    replay.append(None)
                since = r
            elif r["kind"] == "prefill" and since is not None:
                replay.append(r["wall_s"])
                since = None
        if since is not None:
            replay.append(None)
        return {"records": _kind_counts(loop.stream),
                "finish": [r.finish_reason for r in report.results],
                "n_faults": report.n_faults,
                "n_injected_faults": report.n_injected_faults,
                "n_retries": report.n_retries,
                "n_recoveries": report.n_recoveries,
                "n_degrades": report.n_degrades,
                "n_preemptions": report.n_preemptions,
                "recover_s": recover_s, "replay_prefill_s": replay}

    def toks_of(report):
        return {r.request_id: r.tokens.tolist() for r in report.results}

    t_phase = time.perf_counter()
    # -- the fault-free prompt-lookup serve the chaos run is held to
    lookup_loop = loop_for("prompt_lookup")
    lookup_rep = lookup_loop.run()
    no_fault_guard(lookup_rep, lookup_loop.stream, "serve_chaos")
    lookup_toks = toks_of(lookup_rep)
    engine = lookup_loop.engine

    # -- 1: seeded chaos
    inj = serving.FaultInjector(seed=0, rates=CHAOS_RATES, max_faults=10)
    loop = loop_for("prompt_lookup", faults=inj, max_step_retries=1,
                    max_recoveries=50, kernel_fault_limit=0)
    report, per_step, recover_s = run(loop)
    launches = launch_counts()
    chaos = summary(loop, report, recover_s)
    got = toks_of(report)
    partial = {r.request_id for r in report.results
               if r.finish_reason in ("cancelled", "failed")}
    chaos["flips"] = _stream_parts(torch, np, engine, raw, got, lookup_toks,
                                   cache_T, ("chaos", "fault_free"), partial)
    chaos["injected"] = [[s, n] for s, n, _ in inj.injected]
    stream_sites = [r["site"] for r in loop.stream
                    if r["kind"] == "fault" and r.get("injected")]
    n_steps = {kd: sum(1 for r in loop.stream if r["kind"] == kd)
               for kd in ("prefill", "decode", "verify")}
    # a prefill whose install failed (an injected OOM or pool fault) ran
    # its forward without a record: whole forwards only
    k1_min = 7 * L * sum(n_steps.values())
    chaos.update(launches=launches, records_by_step=n_steps,
                 live_blocks_after=int(loop.cm.pool.n_live),
                 accepted_tokens=report.accepted_tokens,
                 drafted_tokens=report.drafted_tokens)
    stepping = [d for kinds, d in _step_deltas(loop.stream, per_step)
                if kinds & {"decode", "verify"}]
    k1_last_step = stepping[-1]["bp_matmul"] if stepping else 0
    chaos["k1_launches_last_step"] = k1_last_step
    check_1 = [
        (len(inj.injected) > 0, "the seeded injector fired no fault"),
        (stream_sites == [s for s, _, _ in inj.injected],
         f"injections {chaos['injected']} against the stream's {stream_sites}"),
        (all(f in ("length", "cancelled", "failed") for f in chaos["finish"]),
         f"finish reasons {chaos['finish']}"),
        (chaos["live_blocks_after"] == 0,
         f"{chaos['live_blocks_after']} blocks leaked"),
        (launches["bp_matmul"] >= k1_min
         and (launches["bp_matmul"] - k1_min) % (7 * L) == 0,
         f"K1 launched {launches['bp_matmul']} times for {n_steps}"),
        (launches["paged_attention"] == L * n_steps["decode"],
         f"K2 launched {launches['paged_attention']} times for "
         f"{n_steps['decode']} classic decodes"),
        (k1_last_step > 0, "K1 did not launch on the run's last step"),
        (not any(r["kind"] == "degrade" and r["action"] == "plain_fallback"
                 for r in loop.stream),
         "the kernel rung fired with kernel_fault_limit 0")]

    # -- 2: the kernel rung, scheduled
    inj2 = serving.FaultInjector(schedule=[("step", 0), ("step", 2)])
    loop2 = loop_for(faults=inj2, max_step_retries=0)
    report2, per_step2, recover_s2 = run(loop2)
    rung = summary(loop2, report2, recover_s2)
    degrades = [(i, r) for i, r in enumerate(loop2.stream)
                if r["kind"] == "degrade"]
    at = [c for n, c in per_step2
          if any(r["kind"] == "degrade" for r in loop2.stream[:n])]
    final2 = launch_counts()
    rung.update(degrade_actions=[r["action"] for _, r in degrades],
                launches_at_rung=at[0] if at else None,
                launches=final2,
                executor_backend=loop2.executor.cfg.matmul_backend,
                engine_backend=loop2.engine.executor.cfg.matmul_backend)
    rung["flips"] = _stream_parts(torch, np, engine, raw, toks_of(report2),
                                  base_toks, cache_T, ("rung", "serve_paged"))
    check_2 = [
        ([r["action"] for _, r in degrades] == ["plain_fallback"],
         f"degrade records {rung['degrade_actions']}"),
        (report2.n_degrades == 1, f"n_degrades {report2.n_degrades}"),
        (bool(at) and at[0]["bp_matmul"] > 0
         and at[0]["paged_attention"] > 0,
         f"K1/K2 had not launched before the rung: {rung['launches_at_rung']}"),
        (bool(at) and all(final2[kk] == at[0][kk]
                          for kk in ("bp_matmul", "paged_attention")),
         f"K1/K2 launched after the rung: {at[:1]} -> {final2}"),
        (rung["executor_backend"] == "plain", "the rung left the kernels on"),
        (rung["engine_backend"] == cfg.matmul_backend,
         f"the rung changed the engine's backend to {rung['engine_backend']}"),
        (all(f == "length" for f in rung["finish"]),
         f"finish reasons {rung['finish']}")]

    # -- 3: the watchdog
    inj3 = serving.FaultInjector(rates={"slow": 1.0}, max_faults=1,
                                 slow_s=CHAOS_SLOW_S)
    loop3 = loop_for(faults=inj3, step_timeout_s=CHAOS_STEP_TIMEOUT_S,
                     max_step_retries=0)
    report3, _, recover_s3 = run(loop3)
    watchdog = summary(loop3, report3, recover_s3)
    stuck = _join_watchdogs(threading)
    # the abandoned step's late launches are counted too
    final3 = launch_counts()
    watchdog["launches"] = final3
    kinds3 = [(r["kind"], r.get("error", "")) for r in loop3.stream
              if r["kind"] in ("fault", "recover")]
    watchdog.update(fault_then_recover=[kd for kd, _ in kinds3],
                    slow_s=CHAOS_SLOW_S,
                    step_timeout_s=CHAOS_STEP_TIMEOUT_S,
                    abandoned_still_running=stuck)
    watchdog["flips"] = _stream_parts(torch, np, engine, raw,
                                      toks_of(report3), base_toks, cache_T,
                                      ("watchdog", "serve_paged"))
    check_3 = [
        (len(kinds3) == 3 and kinds3[0] == ("fault", "")
         and "StepTimeout" in kinds3[1][1] and kinds3[2][0] == "recover",
         f"fault and recover records {kinds3}"),
        (report3.n_recoveries == 1, f"recoveries {report3.n_recoveries}"),
        (all(f == "length" for f in watchdog["finish"]),
         f"finish reasons {watchdog['finish']}"),
        (not stuck, f"watchdog workers still running: {stuck}")]
    reset_counts()

    total = {kk: launches[kk] + final2[kk] + final3[kk] for kk in launches}
    result = {
        "phase": "serve_chaos", "gpu": gpu, "model": cfg.name,
        "layers": L, "mode": cfg.matmul_mode,
        "kv_cache_int8": cfg.kv_cache_int8, "cache_backend": "paged",
        "block_size": block_size, "num_blocks": num_blocks,
        "n_requests": n_requests, "n_slots": n_slots, "cache_T": cache_T,
        "rates": CHAOS_RATES, "chaos": chaos, "kernel_rung": rung,
        "watchdog": watchdog,
        "fault_free_lookup_flips_vs_serve_paged": _stream_flips(
            torch, np, engine, raw, lookup_toks, base_toks, cache_T,
            ("lookup", "serve_paged")),
        "serve_paged_decode_step_ms_p50": base["decode_step_ms_p50"],
        "phase_s": time.perf_counter() - t_phase,
    }
    emit(result)
    for cond, msg in check_1:
        check(cond, f"serve_chaos (chaos): {msg}")
    for cond, msg in check_2:
        check(cond, f"serve_chaos (kernel rung): {msg}")
    for cond, msg in check_3:
        check(cond, f"serve_chaos (watchdog): {msg}")
    for name, part in (("chaos", chaos), ("kernel rung", rung),
                       ("watchdog", watchdog)):
        bad = [f for f in part["flips"] if not f["near_tie"]]
        check(not bad, f"serve_chaos ({name}): streams differ beyond a "
                       f"near-tie: {bad}")
    return result, total


def phase_serve_frontdoor(torch, gpu, model, base, base_toks, n_slots=4,
                          lead_window=4, block_size=16,
                          num_blocks=PAGED_NUM_BLOCKS, disconnect_after=4,
                          stagger_s=0.15):
    """The front door on the paged main path: two replicas, each its own
    engine over one set of quantized weights and its own 36-block pool,
    behind ``FrontDoor(policy="affinity")`` on 127.0.0.1 (an ephemeral
    port).  Traffic from client threads, one request every ``stagger_s``:
    the ``serve_paged`` requests (one shared 256-token system prompt), then
    four requests sharing a second system prompt, so that both replicas
    serve at once; every other request streams over SSE, and one streamed
    client hangs up after ``disconnect_after`` tokens.  The router's spill
    threshold lies above the request count, so each system prompt stays on
    its home replica."""
    import threading

    import numpy as np

    from repro_torch import serving

    cfg = model["cfg"].replace(kv_cache_int8=False)
    params = model["params"]
    L = cfg.num_layers
    group_a = _paged_requests(serving, np.random.default_rng(1),
                              cfg.vocab_size, 8)
    group_b = _paged_requests(serving, np.random.default_rng(2),
                              cfg.vocab_size, 4)
    prompts = group_a + group_b
    cache_T = max(r.prompt_len + r.max_new_tokens for r in prompts) + 8

    def engine_for():
        return serving.ServingEngine(
            cfg, params, serving.ServeConfig(
                max_new_tokens=32, temperature=0.0, cache_backend="paged",
                block_size=block_size), device="cuda")

    t_phase = time.perf_counter()
    # -- a direct serve of the second group (the first group's is
    # serve_paged's)
    direct_b = guarded_serve(
        engine_for(), _copies(serving, group_b), n_slots=n_slots,
        cache_T=cache_T, num_blocks=num_blocks,
        sched_cfg=serving.SchedulerConfig(lead_window=lead_window))
    want = dict(base_toks)
    want.update({len(group_a) + r.request_id: r.tokens.tolist()
                 for r in direct_b.results})

    replicas = [serving.Replica(
        engine_for(), name=f"r{i}", n_slots=n_slots, cache_T=cache_T,
        num_blocks=num_blocks,
        sched_cfg=serving.SchedulerConfig(lead_window=lead_window))
        for i in range(2)]
    # the stream every replica worker launches on
    streams = set()
    for rep in replicas:
        def hook(lp, inner=rep.loop.on_step_end):
            streams.add(torch.cuda.current_stream().cuda_stream)
            inner(lp)
        rep.loop.on_step_end = hook
    main_stream = torch.cuda.current_stream().cuda_stream
    torch.cuda.synchronize()
    reset_counts()
    door = serving.FrontDoor(replicas, policy="affinity",
                             max_imbalance=len(prompts)).start()
    client = serving.FrontDoorClient("127.0.0.1", door.port)
    results = [None] * len(prompts)
    sent, arrived = [0.0] * len(prompts), [[] for _ in prompts]
    errors = []
    cut = 1                  # the streamed request whose client hangs up

    def one(i):
        r = prompts[i]
        stream = i % 2 == 1
        try:
            sent[i] = time.perf_counter()
            results[i] = client.generate(
                r.prompt.tolist(), max_new_tokens=r.max_new_tokens,
                stream=stream,
                disconnect_after=disconnect_after if i == cut else None,
                on_token=lambda tok, idx: arrived[i].append(
                    time.perf_counter()))
        except Exception as e:             # reported, then checked
            errors.append(f"request {i}: {type(e).__name__}: {e}")

    threads = []
    try:
        for i in range(len(prompts)):
            t = threading.Thread(target=one, args=(i,),
                                 name=f"client-{i}")
            t.start()
            threads.append(t)
            time.sleep(stagger_s)
        for t in threads:
            t.join(timeout=600)
        health = client.healthz()
        stats = client.stats()
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            s = [rep.stats() for rep in replicas]
            if all(x["queue_depth"] == 0 and x["blocks_in_use"] == 0
                   for x in s):
                break
            time.sleep(0.05)
    finally:
        reports = door.stop()
    torch.cuda.synchronize()
    launches = launch_counts()
    wall_s = time.perf_counter() - t_phase

    # -- the launches both replicas' step streams predict
    want_l = {"gemv": 0, "tile": 0, "paged_attention": 0}
    steps_ms, per_replica = [], {}
    for rep in replicas:
        routes, _ = matmul_routes(rep.loop.stream, 7 * L)
        n_dec = sum(1 for r in rep.loop.stream if r["kind"] == "decode")
        want_l["gemv"] += routes["gemv"]
        want_l["tile"] += routes["tile"]
        want_l["paged_attention"] += L * n_dec
        ms = [1e3 * r["wall_s"] for r in rep.loop.stream
              if r["kind"] == "decode"]
        steps_ms += ms
        p = serving.percentiles(ms, qs=(50, 90))
        rrep = reports[rep.name]
        per_replica[rep.name] = {
            "requests": len(rrep.results), "decode_steps": n_dec,
            "decode_step_ms_p50": p["p50"] if p else None,
            "decode_step_ms_p90": p["p90"] if p else None,
            "prefix_hit_blocks": rrep.prefix_hit_blocks,
            "n_preemptions": rrep.n_preemptions,
            "n_cancelled": rrep.n_cancelled,
            "live_blocks_after": int(rep.loop.cm.pool.n_live),
            "engine_ttft_wall": rrep.ttft_wall,
            "engine_itl_wall": rrep.itl_wall}
    want_l["bp_matmul"] = want_l["gemv"] + want_l["tile"]

    # -- what the clients saw, against the engines' own stamps
    by_id = {(rep.name, int(r.request_id)): r
             for rep in replicas for r in rep.loop.requests}
    got, ttft, gaps, added = {}, [], [], []
    for i, res in enumerate(results):
        if res is None:
            continue
        got[i] = [int(t) for t in res["tokens"]]
        eng_req = by_id.get((res["replica"], int(res["request_id"])))
        if i % 2 == 1 and arrived[i]:
            ttft.append(arrived[i][0] - sent[i])
            gaps += [b - a for a, b in zip(arrived[i], arrived[i][1:])]
            if eng_req is not None:
                added += [c - e for c, e in zip(arrived[i],
                                                eng_req.wall_token_times)]
    cancelled = [(name, r.request_id) for name, rr in reports.items()
                 for r in rr.results if r.finish_reason == "cancelled"]
    flips = _stream_parts(torch, np, replicas[0].engine,
                          [r.prompt for r in prompts], got, want, cache_T,
                          ("door", "direct"), partial={cut})
    homes = {g: sorted({results[i]["replica"] for i in ids
                        if results[i] is not None})
             for g, ids in (("a", range(len(group_a))),
                            ("b", range(len(group_a), len(prompts))))}

    def pct(xs):
        p = serving.percentiles([1e3 * x for x in xs], qs=(50, 90))
        return None if p is None else {k: v for k, v in p.items()}

    result = {
        "phase": "serve_frontdoor", "gpu": gpu, "model": cfg.name,
        "layers": L, "mode": cfg.matmul_mode,
        "kv_cache_int8": cfg.kv_cache_int8, "cache_backend": "paged",
        "block_size": block_size, "num_blocks_per_replica": num_blocks,
        "replicas": 2, "policy": "affinity", "n_requests": len(prompts),
        "streamed": len(prompts) // 2, "n_slots": n_slots,
        "cache_T": cache_T, "stagger_s": stagger_s,
        "healthz": health, "router": {k: v for k, v in stats.items()
                                      if k != "replicas"},
        "homes": homes, "per_replica": per_replica,
        "launches": launches, "expected_launches": want_l,
        "worker_streams_equal_main": streams == {main_stream},
        "cancelled": cancelled,
        "disconnected_tokens": len(got.get(cut, [])),
        "flips": flips, "client_errors": errors,
        "client_ttft_ms": pct(ttft), "client_itl_ms": pct(gaps),
        "door_added_ms_per_token": pct(added),
        "door_decode_step_ms": pct([x / 1e3 for x in steps_ms]),
        "serve_paged_decode_step_ms_p50": base["decode_step_ms_p50"],
        "serve_paged_decode_step_ms_p90": base["decode_step_ms_p90"],
        "serve_paged_ttft_ms": pct([t for t in base["ttft_wall_s_by_request"]
                                    if t is not None]),
        "serve_paged_itl_wall": base["itl_wall_s"],
        "wall_s": wall_s,
    }
    emit(result)
    check(not errors, f"serve_frontdoor: client errors {errors}")
    check(health == {"ok": True}, f"serve_frontdoor: /healthz {health}")
    check(len(stats.get("replicas", [])) == 2,
          f"serve_frontdoor: /v1/stats {stats}")
    check(streams == {main_stream},
          f"serve_frontdoor: replica workers launched on streams {streams}, "
          f"the loop's is {main_stream}")
    check(results[cut] is not None and results[cut]["disconnected"],
          "serve_frontdoor: the hung-up client was not disconnected")
    cut_id = (results[cut]["replica"], results[cut]["request_id"])
    check(cancelled == [cut_id], f"serve_frontdoor: cancelled {cancelled}, "
                                 f"expected the hung-up request {cut_id}")
    for name, rr in reports.items():
        rep = next(r for r in replicas if r.name == name)
        no_fault_guard(rr, rep.loop.stream, f"serve_frontdoor {name}")
        check(all(r.finish_reason in ("length", "cancelled")
                  for r in rr.results),
              f"serve_frontdoor {name}: finish reasons "
              f"{[r.finish_reason for r in rr.results]}")
        check(per_replica[name]["live_blocks_after"] == 0,
              f"serve_frontdoor {name}: "
              f"{per_replica[name]['live_blocks_after']} blocks still live")
    for g, names in homes.items():
        check(len(names) == 1, f"serve_frontdoor: system prompt {g} landed "
                               f"on {names}")
        check(per_replica[names[0]]["prefix_hit_blocks"] > 0,
              f"serve_frontdoor: no prefix hit on {names[0]}")
    check(launches["bp_matmul"] == want_l["bp_matmul"]
          and launches["bp_matmul_gemv"] == want_l["gemv"]
          and launches["bp_matmul_tile"] == want_l["tile"]
          and launches["paged_attention"] == want_l["paged_attention"],
          f"serve_frontdoor: launches {launches}, the replicas' streams "
          f"predict {want_l}")
    bad = [f for f in flips if not f["near_tie"]]
    check(not bad, f"serve_frontdoor: streams differ from a direct serve "
                   f"beyond a near-tie: {bad}")
    reset_counts()
    return result, launches


def build_rwkv(torch):
    """Full-width, full-depth rwkv6-7b in bp_exact: random weights from
    seed 0, every dense weight quantized to int8 once.  Peak device memory
    of the initialisation and quantization is measured on its own."""
    from repro_torch.configs.base import get_arch
    from repro_torch.models import api
    from repro_torch.models.layers import quantize_dense_params

    cfg = get_arch("rwkv6-7b").replace(matmul_mode="bp_exact")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.no_grad():
        params = quantize_dense_params(api.init(cfg, seed=0, device="cuda"))
    torch.cuda.synchronize()
    init_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.cuda.empty_cache()
    return {"cfg": cfg, "params": params,
            "init_and_quantize_s": time.perf_counter() - t0,
            "init_and_quantize_peak_mem_gb": init_peak,
            "param_bytes": sum(t.numel() * t.element_size()
                               for t in _leaves(params))}


def _rwkv_requests(serving, rng, vocab: int, n: int):
    """``n`` requests arriving every two decode steps, 8-32 new tokens
    each: prompts of 64, 128, 192 or 256 tokens (the WKV6 kernel's
    lengths), except request 3, whose 100 tokens take the step
    recurrence."""
    reqs = []
    for i in range(n):
        plen = 100 if i == 3 else int(rng.choice((64, 128, 192, 256)))
        reqs.append(serving.Request(
            prompt=rng.integers(2, vocab, size=plen).astype("int32"),
            max_new_tokens=int(rng.integers(8, 33)),
            arrival_time=float(2 * i)))
    return reqs


def rwkv_noise_floor(torch, cfg, params, prompts, chunk=64):
    """How far two exact evaluations of one rwkv prefill lie apart: for
    every prompt whose length is a multiple of the chunk, the largest
    logit difference between the plain version's chunked form (a prefill
    of the whole prompt) and its step recurrence (a prefill of all but the
    last token, then a decode step of it): the same function, its float32
    sums in another order.  Beside it, the kernel's chunked prefill against
    the plain version's.  ``tests/test_torch_rwkv_depth.py`` measures the
    same gap in the JAX reference."""
    from repro_torch.models import rwkv_model
    plain = cfg.replace(matmul_backend="plain")
    rows = []
    for i, r in enumerate(prompts):
        if r.prompt_len % chunk:
            continue
        tokens = torch.as_tensor(
            r.prompt[None], device=params["embed"]["table"].device).long()
        with torch.no_grad():
            lp = rwkv_model.prefill(params, plain,
                                    {"tokens": tokens})[0][0].float()
            _, state = rwkv_model.prefill(params, plain,
                                          {"tokens": tokens[:, :-1]})
            ls = rwkv_model.decode_step(params, plain, {
                "tokens": tokens[:, -1:], "cache": state})[0][0].float()
            lk = rwkv_model.prefill(params, cfg,
                                    {"tokens": tokens})[0][0].float()
        rows.append({"request": i, "prompt_len": r.prompt_len,
                     "plain_chunked_vs_step": (lp - ls).abs().max().item(),
                     "kernel_vs_plain": (lk - lp).abs().max().item()})
    return rows


def _capture_prefill_states(executor):
    """Record, for every prefill ``executor`` runs, its tokens and each
    layer's WKV state as the prefill left it (a copy).  Returns the list
    the records go to; ``del executor.prefill`` ends the capture."""
    records = []
    inner = executor.prefill

    def prefill(batch, cache_T, prompt_lens=None):
        logits, cache = inner(batch, cache_T, prompt_lens)
        records.append((batch["tokens"].copy(), cache["wkv"].clone()))
        return logits, cache

    executor.prefill = prefill
    return records


def wkv_state_by_layer(torch, got, want, chunk=64):
    """The WKV state each prefill of two serves left in each layer, the
    kernel serve's (``got``) against the plain serve's (``want``): per
    layer, the largest difference relative to the plain state's largest
    element, and whether layer 0 (whose inputs are the same bits in both
    serves: the BitParticle kernel equals its plain version bit for bit)
    lies within the WKV6 kernel's bf16 tolerance, atol = rtol = 3e-2."""
    assert len(got) == len(want)
    per_layer, layer0_ok, layer0_err = None, True, 0.0
    for (tg, sg), (tw, sw) in zip(got, want):
        assert (tg == tw).all(), "the two serves prefilled other tokens"
        rel = [((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
               for a, b in zip(sg, sw)]
        per_layer = rel if per_layer is None else [
            max(x, y) for x, y in zip(per_layer, rel)]
        if tg.shape[1] % chunk == 0:
            layer0_err = max(layer0_err, (sg[0] - sw[0]).abs().max().item())
            layer0_ok &= bool(torch.allclose(sg[0], sw[0], atol=3e-2,
                                             rtol=3e-2))
    return {"layer0_max_abs_err": layer0_err, "layer0_ok": layer0_ok,
            "max_rel_err_by_layer": per_layer}


def phase_serve_rwkv(torch, gpu, model, n_requests=8, n_slots=4,
                     lead_window=4, chunk=64):
    """The RWKV-6 main path: every projection and the lm_head run the
    BitParticle matmul, every prefill whose length is a multiple of the
    chunk runs the WKV6 kernel in every layer, decode takes the step
    recurrence."""
    import numpy as np

    from repro_torch import serving

    cfg, params = model["cfg"], model["params"]
    L = cfg.num_layers

    scfg = serving.ServeConfig(max_new_tokens=32, temperature=0.0)
    engine = serving.ServingEngine(cfg, params, scfg, device="cuda")
    sched = serving.SchedulerConfig(lead_window=lead_window)
    prompts = _rwkv_requests(serving, np.random.default_rng(2),
                             cfg.vocab_size, n_requests)

    cache_T = max(r.prompt_len + r.max_new_tokens for r in prompts) + 8
    kw = dict(n_slots=n_slots, cache_T=cache_T, sched_cfg=sched)
    # warm-up serve (allocator, one kernel-route and one step-route
    # prefill): not measured
    guarded_serve(engine, _copies(serving, prompts)[2:4], **kw)
    torch.cuda.synchronize()

    # -- the measured main-path run: counts zeroed just before, read after
    states = _capture_prefill_states(engine.executor)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    loop = engine.make_loop(_copies(serving, prompts), **kw)
    report = loop.run()
    no_fault_guard(report, loop.stream, "serve_rwkv")
    torch.cuda.synchronize()
    launches = launch_counts()
    peak_mem_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    del engine.executor.prefill
    prefills = [r for r in loop.stream if r["kind"] == "prefill"]
    eligible = [r for r in prefills
                if r["pad_to"] % chunk == 0 and r["pad_to"] > 1]
    step_ms = [1e3 * r["wall_s"] for r in loop.stream
               if r["kind"] == "decode"]
    toks = {r.request_id: r.tokens.tolist() for r in report.results}
    routes, prefill_m = matmul_routes(loop.stream, 7 * L, head=1)
    expected = {"bp_matmul": (7 * L + 1) * (len(prefills) + report.steps),
                "bp_matmul_gemv": routes["gemv"],
                "bp_matmul_tile": routes["tile"],
                "wkv6": L * len(eligible), "paged_attention": 0}

    # -- the model's float32 noise floor.  Random-init rwkv6-7b in bp_exact
    # carries a float32 rounding difference through 32 layers of bf16
    # rounding and int8 activation quantization into logit differences of
    # tenths (two plain evaluations included; the reference amplifies as
    # much, tests/test_torch_rwkv_depth.py), so a stream may flip where
    # two logits lie within that floor; such a flip is a near-tie here
    noise = rwkv_noise_floor(torch, cfg, params, prompts, chunk)
    tie = max(r["plain_chunked_vs_step"] for r in noise)
    kernel_dev = max(r["kernel_vs_plain"] for r in noise)

    # -- the same serve through the plain versions of both kernels
    reset_counts()
    plain = serving.ServingEngine(cfg.replace(matmul_backend="plain"),
                                  params, scfg, device="cuda")
    plain_states = _capture_prefill_states(plain.executor)
    rep_plain = guarded_serve(plain, _copies(serving, prompts), **kw)
    del plain.executor.prefill
    plain_launches = launch_counts()
    reset_counts()
    # every prefill's WKV state, kernel serve against plain serve: where no
    # amplification can reach it yet (layer 0), held to K3's tolerance
    state_gap = wkv_state_by_layer(torch, states, plain_states, chunk)
    del states, plain_states
    other = {r.request_id: r.tokens.tolist() for r in rep_plain.results}
    plain_flips = [
        _flip(torch, np, engine, prompts[i].prompt, toks[i], other[i],
              cache_T, i, names=("kernel", "plain"), tie=tie)
        for i in toks if other[i] != toks[i]]
    # -- the static path on the same prompts, one request at a time
    gen_flips = []
    for i, r in enumerate(prompts):
        g = engine.generate({"tokens": r.prompt[None]},
                            max_new_tokens=r.max_new_tokens,
                            cache_T=cache_T).tokens[0].tolist()
        if g != toks[i]:
            gen_flips.append(_flip(torch, np, engine, r.prompt, toks[i], g,
                                   cache_T, i, tie=tie))
    reset_counts()
    # a short profiled serve: a 256-token prompt (the WKV6 kernel) and the
    # 100-token one (the step recurrence), 8 new tokens each
    long_i = next(i for i, r in enumerate(prompts) if r.prompt_len == 256)
    profile = _profile_serve(
        torch, engine, [serving.Request(prompt=prompts[i].prompt.copy(),
                                        max_new_tokens=8,
                                        arrival_time=float(j))
                        for j, i in enumerate((long_i, 3))],
        n_slots, cache_T, sched)
    reset_counts()

    p = serving.percentiles(step_ms, qs=(50, 90))
    result = {
        "phase": "serve_rwkv", "gpu": gpu, "model": cfg.name,
        "layers": L, "d_model": cfg.d_model, "d_ff": cfg.d_ff,
        "wkv_heads": cfg.d_model // cfg.rwkv_head_dim,
        "head_dim": cfg.rwkv_head_dim, "vocab": cfg.vocab_size,
        "mode": cfg.matmul_mode, "cache_backend": scfg.cache_backend,
        "n_requests": n_requests, "n_slots": n_slots,
        "lead_window": lead_window, "cache_T": cache_T,
        "prompt_lens": [r.prompt_len for r in prompts],
        "init_and_quantize_s": model["init_and_quantize_s"],
        "init_and_quantize_peak_mem_gb":
            model["init_and_quantize_peak_mem_gb"],
        "param_bytes": model["param_bytes"],
        "prefill_calls": len(prefills),
        "prefill_groups": [[r["group_size"], r["pad_to"]] for r in prefills],
        "wkv6_eligible_prefills": len(eligible),
        "decode_steps": report.steps,
        "total_new_tokens": report.total_new_tokens,
        "launches": launches, "expected_launches": expected,
        "plain_backend_launches": plain_launches,
        "noise_floor": noise, "near_tie_logit_gap": tie,
        "wkv_state_kernel_vs_plain": state_gap,
        "tokens_equal_plain_backend": not plain_flips,
        "plain_flips": plain_flips,
        "generate_equal_serve": not gen_flips,
        "generate_flips": gen_flips,
        "decode_tokens_per_s": report.decode_tokens_per_s,
        "decode_step_ms_p50": p["p50"] if p else None,
        "decode_step_ms_p90": p["p90"] if p else None,
        "prefill_s": report.prefill_s, "decode_s": report.decode_s,
        "serve_peak_mem_gb": peak_mem_gb,
        "first_tokens": toks[0][:8],
        "profile": profile,
    }
    emit(result)
    check(all(r.finish_reason == "length" for r in report.results),
          "an rwkv request finished for another reason than length")
    check(all(0 <= t < cfg.vocab_padded for ts in toks.values() for t in ts),
          "a generated token lies outside the padded vocabulary")
    check(len(eligible) < len(prefills),
          "no prefill took the step recurrence")
    for name, want in expected.items():
        check(launches[name] == want,
              f"{name} launched {launches[name]} times on the rwkv path, "
              f"expected {want}")
    check(launches["wkv6"] > 0, "the WKV6 kernel never ran on its path")
    check(not any(plain_launches.values()),
          f"the plain backend launched a kernel: {plain_launches}")
    check(state_gap["layer0_ok"],
          f"layer 0's WKV state after a kernel-route prefill lies "
          f"{state_gap['layer0_max_abs_err']} from the plain serve's, "
          f"beyond 3e-2")
    check(kernel_dev <= 2 * tie,
          f"the kernel's prefill logits lie {kernel_dev} from the plain "
          f"version's, over twice the model's float32 noise floor {tie}")
    for name, fl in (("plain-version", plain_flips),
                     ("generate()", gen_flips)):
        bad = [f for f in fl if not f["near_tie"]]
        check(not bad, f"rwkv serve and {name} differ beyond a near-tie: "
                       f"{bad}")
    # the kernels line's shape: the most frequent kernel-route prefill
    shapes = [(r["group_size"] * cfg.d_model // cfg.rwkv_head_dim,
               r["pad_to"]) for r in eligible]
    shape = max(set(shapes), key=lambda sh: (shapes.count(sh), sh))
    return result, {**launches, "prefill_rows": prefill_m}, {
        "R": shape[0], "T": shape[1], "N": cfg.rwkv_head_dim,
        "chunk": chunk}


def wkv6_summary(torch, flush, gpu, shape, launches):
    """The kernels line's numbers for WKV6: one layer's call at the rwkv
    serve's most frequent kernel-route prefill shape, timed in this run
    beside its plain version and the bound."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    row = time_wkv_case(torch, flush, gen, gpu, shape["R"], shape["T"],
                        shape["N"], shape["chunk"])
    plan = row["plan"]
    return {"name": "wkv6", "route": "cuda",
            "source": KERNEL_SOURCES["wkv6"],
            "replaces": "src/repro/kernels/wkv6/kernel.py:85",
            "launches": launches["wkv6"],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None,
            "shape": f"one layer's prefill call in the rwkv serve: R="
                     f"{shape['R']} rows (64 heads x requests), T="
                     f"{shape['T']}, N {shape['N']}, chunk {shape['chunk']}, "
                     f"bf16 r/k/v; two kernels per call: "
                     f"{plan['state_blocks']} state-chain blocks "
                     f"({plan['col_blocks']} per row) and "
                     f"{plan['chunk_blocks']} chunk blocks (row split "
                     f"{plan['row_split']}); library: none computes WKV6"}


#: device-kernel name fragments of each of the port's CUDA kernels
KERNEL_SYMBOLS = {"bp_matmul_gemv": ("bp_gemv",),
                  "bp_matmul_tile": ("bp_tile", "bp_wgmma"),
                  "paged_attention": ("paged_attention_kernel",),
                  "wkv6": ("wkv6_state_kernel", "wkv6_chunk_kernel")}


def _profile_serve(torch, engine, requests, n_slots, cache_T, sched,
                   **serve_kw):
    """Where a serve's time goes: one more serve of ``requests`` under
    ``torch.profiler``, reduced to device-busy time against wall time, the
    number of kernels launched, each of the port's kernels' device time,
    and the kernels that take the most device time.  The profiler slows
    the host, so ``idle_share`` is an upper bound on the unprofiled run's."""
    from torch.profiler import ProfilerActivity, profile

    def device_us(ev):
        return getattr(ev, "self_device_time_total",
                       getattr(ev, "self_cuda_time_total", 0.0))

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rep = guarded_serve(engine, requests, n_slots=n_slots,
                            cache_T=cache_T, sched_cfg=sched, **serve_kw)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA")
               and device_us(e) > 0]
    busy_ms = sum(device_us(e) for e in kernels) / 1e3
    n_kernels = sum(e.count for e in kernels)
    ours = {name: sum(device_us(e) for e in kernels
                      if any(sym in e.key for sym in syms)) / 1e3
            for name, syms in KERNEL_SYMBOLS.items()}
    top = sorted(kernels, key=device_us, reverse=True)[:6]
    return {"requests": len(requests), "decode_steps": rep.steps,
            "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / wall_ms,
            "kernels": n_kernels,
            **{f"{name}_device_ms": ms for name, ms in ours.items()},
            "top_kernels": [{"name": e.key[:60], "count": e.count,
                             "device_ms": device_us(e) / 1e3}
                            for e in top]}


def _flip(torch, np, engine, prompt, serve_toks, gen_toks, cache_T, rid,
          names=("serve", "generate"), tie=0.0):
    """Where two token streams first part: the position, both tokens, and
    the top-2 margin of a fresh single-request prefill of the prompt plus
    the shared prefix.  It is a near-tie when both tokens' logits lie
    within 4 bf16 units in the last place (at the top logit's magnitude),
    or within ``tie`` if that is larger, of the top logit.  ``names``
    label the two streams."""
    j = next((k for k in range(min(len(serve_toks), len(gen_toks)))
              if serve_toks[k] != gen_toks[k]), None)
    if j is None:       # one stream ends early: no token to compare
        return {"request": rid, "lengths": [len(serve_toks), len(gen_toks)],
                "near_tie": False}
    seq = np.concatenate([prompt, np.asarray(serve_toks[:j], np.int32)])
    logits, _ = engine.executor.prefill({"tokens": seq[None]}, cache_T)
    lg = logits[0].float()
    top = torch.topk(lg, 2).values.tolist()
    ulp = 2.0 ** (int(np.floor(np.log2(abs(top[0]) + 1e-30))) - 7)
    margin = top[0] - top[1]
    l_s, l_g = lg[serve_toks[j]].item(), lg[gen_toks[j]].item()
    a, b = names
    return {"request": rid, "position": j, f"{a}_token": serve_toks[j],
            f"{b}_token": gen_toks[j],
            f"logit_{a}_token": l_s, f"logit_{b}_token": l_g,
            "top2_margin": margin, "bf16_ulp": ulp,
            "near_tie": top[0] - min(l_s, l_g) <= max(4 * ulp, tie)}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def time_chain(torch, flush, gen, m, kn, library=False):
    """Calls of the BitParticle matmul (exact, fused dequant) at M = m, one
    per (K, N) of ``kn``, timed back to back in this run beside the plain
    version and the bound: (ms, plain_ms, bound_ms, bound_by, max_abs_err,
    library).  The calls are one dependent chain on the main path, so their
    bound is the sum of theirs.  With ``library``, also the same chain of
    ``torch._int_mm`` calls in each weight layout ({layout: ms}; empty
    where it refuses a shape)."""
    from repro_torch.kernels.bitparticle_matmul.ops import bp_matmul
    cases = [_rand_case(torch, gen, m, k, n) for k, n in kn]
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
    bounds = [matmul_bound(m, k, n, False) for k, n in kn]
    bound_by = {by for _, by in bounds}
    lib = {}
    fns = [_library_int_mm(torch, a, w) for a, w, _, _ in cases]
    if library and all(fns):
        for layout in fns[0]:
            calls = [f[layout] for f in fns]
            lib[layout] = time_ms(torch, lambda: [c() for c in calls], flush)
    return (ms, plain_ms, sum(t for t, _ in bounds),
            "bytes" if bound_by == {"bytes"} else "operations", err, lib)


def decode_layer_summary(torch, flush, n_slots, launches):
    """The kernels line's numbers for bp_matmul's decode GEMV: the seven
    projections of one qwen2-1.5b decoder layer at the main path's decode
    shape (M = n_slots), and beside them one rwkv6-7b layer's seven
    projections and its lm_head at the same M, each timed in this run
    beside the plain version and the bound."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    ms, plain_ms, bound_ms, bound_by, err, _ = time_chain(
        torch, flush, gen, n_slots, QWEN_LAYER_KN)
    extra = {}
    for name, kn in (("rwkv6_7b_layer", RWKV_LAYER_KN),
                     ("rwkv6_7b_lm_head", ((4096, 65536),))):
        r_ms, r_plain, r_bound, r_by, r_err, _ = time_chain(
            torch, flush, gen, n_slots, kn)
        err = max(err, r_err)
        extra[name] = {"ms": r_ms, "plain_ms": r_plain, "bound_ms": r_bound,
                       "bound_by": r_by, "max_abs_err": r_err}
    return {"name": "bp_matmul", "route": "cuda",
            "kernel": "bp_gemv_kernel (decode, M <= 8)",
            "source": KERNEL_SOURCES["bp_matmul"],
            "replaces": "src/repro/kernels/bitparticle_matmul/kernel.py:93",
            "launches": launches["bp_matmul_gemv"], "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
            "shape": f"one qwen2-1.5b decoder layer's 7 projections at "
                     f"M={n_slots} (decode), exact mode; torch._int_mm "
                     f"refuses M <= 16",
            **extra}


def prefill_layer_summary(torch, flush, qwen_m, rwkv_m, launches):
    """The kernels line's numbers for bp_matmul's prefill tile kernel: the
    seven projections of one qwen2-1.5b decoder layer at the main path's
    most frequent prefill row count, and beside them one rwkv6-7b layer's
    at its serve's, each timed in this run beside the plain version, the
    bound and the same chain of ``torch._int_mm`` calls (the faster weight
    layout is ``library_ms``)."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    ms, plain_ms, bound_ms, bound_by, err, lib = time_chain(
        torch, flush, gen, qwen_m, QWEN_LAYER_KN, library=True)
    r_ms, r_plain, r_bound, r_by, r_err, r_lib = time_chain(
        torch, flush, gen, rwkv_m, RWKV_LAYER_KN, library=True)
    return {"name": "bp_matmul_tile", "route": "cuda",
            "kernel": "bp_tile_kernel (mma.sync) and bp_wgmma_kernel "
                      "(prefill, M > 8)",
            "source": KERNEL_SOURCES["bp_matmul"],
            "replaces": "src/repro/kernels/bitparticle_matmul/kernel.py:93",
            "launches": launches["bp_matmul_tile"],
            "max_abs_err": max(err, r_err), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": min(lib.values()) if lib else None,
            "library_ms_by_layout": lib,
            "shape": f"one qwen2-1.5b decoder layer's 7 projections at "
                     f"M={qwen_m} (the serve's most frequent prefill rows), "
                     f"exact mode; library: the same chain of "
                     f"torch._int_mm, the faster weight layout",
            "rwkv6_7b_layer": {"m": rwkv_m, "ms": r_ms, "plain_ms": r_plain,
                               "bound_ms": r_bound, "bound_by": r_by,
                               "max_abs_err": r_err,
                               "library_ms_by_layout": r_lib}}


def paged_layer_summary(torch, flush, paged_shape, launches):
    """The kernels line's numbers for paged attention: one decoder layer's
    call at the paged serve's decode shape (its slots, table width and the
    per-slot positions of its median full-batch step), timed in this run
    beside the plain version, the library yardstick and the bound."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    lengths = paged_shape["lengths"]
    row = time_paged_case(torch, flush, gen, len(lengths), lengths,
                          pps=paged_shape["pages_per_seq"])
    return {"name": "paged_attention", "route": "cuda",
            "source": KERNEL_SOURCES["paged_attention"],
            "replaces": "src/repro/kernels/paged_attention/kernel.py:96",
            "launches": launches["paged_attention"],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": f"one decoder layer at the paged serve's decode shape: "
                     f"B={len(lengths)}, H 12, KH 2, D 128, block 16, "
                     f"{row['pages_per_seq']} pages per table, positions "
                     f"{row['lengths']}, bf16; library: SDPA (enable_gqa) "
                     f"on K/V gathered dense beforehand"}


#: tile sweep: the row counts timed beside PREFILL_TIME's (the serves'
#: most frequent prefill rows)
SWEEP_EXTRA = ((128, QWEN_KN), (128, RWKV_KN[:3]))


def wkv_time(torch, gpu, path):
    """The WKV6 kernels alone at rwkv6-7b's prefill shapes: built from this
    checkout, held against the plain version and timed as
    ``phase_kernel_time`` times them; written to ``path``, one line per
    shape printed."""
    from repro_torch.kernels.wkv6 import build
    t0 = time.perf_counter()
    build.LIBRARY.load()
    flush = Flusher(torch)
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for R, T in WKV_SERVE_SHAPES + (WKV_LONG_SHAPE,):
        rows.append(time_wkv_case(torch, flush, gen, gpu, R, T))
        print(json.dumps({k: rows[-1][k] for k in
                          ("R", "T", "ms", "bound_ms", "max_abs_err")}),
              flush=True)
    pathlib.Path(path).parent.mkdir(parents=True, exist_ok=True)
    pathlib.Path(path).write_text(json.dumps(
        {"gpu": gpu, "root": str(ROOT), "build_and_load_s":
         time.perf_counter() - t0, "event_floor_ms":
         event_floor_ms(torch, flush), "rows": rows}, indent=1))


def tile_sweep(torch, gpu, path):
    """Every tile x K split of the prefill tile kernels at the serves'
    prefill shapes, both modes, each launch held bit-exact against the
    plain version and timed (``time_ms``, 10 launches), beside the plan's
    own choice: the data ``ops.tile_plan``'s thresholds were fitted to.
    Writes every variant's time to ``path`` and prints one line per shape
    and mode: the plan, its time, and the fastest variant."""
    import ctypes

    from repro_torch.kernels.bitparticle_matmul import build, ops
    lib = build.library()
    flush = Flusher(torch)
    gen = torch.Generator(device="cuda").manual_seed(1)
    sms = ops._sm_count(torch.device("cuda"))
    stream = torch.cuda.current_stream().cuda_stream
    tiles = {False: ops.TILE_SHAPES_WGMMA + ops.TILE_SHAPES_MMA,
             True: ops.TILE_SHAPES_APPROX}
    rows = []
    for m, kns in PREFILL_TIME + SWEEP_EXTRA:
        for k, n in kns:
            a, w, sa, sw = _rand_case(torch, gen, m, k, n)
            out = torch.empty(m, n, device="cuda")
            steps = -(-k // ops.TILE_K)
            for _, approx in MODES:
                want = ops.bp_matmul(a, w, sa, sw, approx=approx,
                                     backend="plain")

                def launch(plan):
                    rc = lib.bp_tile_launch(
                        *(ctypes.c_void_p(t.data_ptr())
                          for t in (a, w, sa, sw, out)),
                        m, n, k, int(approx), 1, 1, *plan,
                        ctypes.c_void_p(stream))
                    check(rc == 0, f"tile launch {plan} failed: {rc}")

                variants = {}
                for bm, bn in tiles[approx]:
                    n_tiles = -(-m // bm) * -(-n // bn)
                    for split in (1, 2, 3, 4, 6, 8):
                        if split > max(1, steps // 2) or not (
                                8 <= n_tiles * split <= 12 * sms):
                            continue
                        kslice = -(-steps // split) * ops.TILE_K
                        stages = max(ops.TILE_MIN_STAGES, min(
                            ops.TILE_MAX_STAGES,
                            ops.TILE_SMEM // ((bm + bn) * ops.TILE_K)))
                        plan = (bm, bn, -(-k // kslice), kslice, stages)
                        out.zero_()
                        launch(plan)
                        torch.cuda.synchronize()
                        check(torch.equal(out, want),
                              f"tile plan {plan} disagrees at {m}x{k}x{n}")
                        variants[str(plan)] = 1e3 * time_ms(
                            torch, lambda: launch(plan), flush, iters=10)
                plan = ops.tile_plan(sms, m, n, k, approx)
                best = min(variants, key=variants.get)
                row = {"m": m, "k": k, "n": n,
                       "mode": "approx" if approx else "exact",
                       "plan": plan, "plan_us": 1e3 * time_ms(
                           torch, lambda: launch(plan), flush, iters=10),
                       "best": best, "best_us": variants[best],
                       "variants_us": variants}
                rows.append(row)
                print(json.dumps({k: row[k] for k in (
                    "m", "k", "n", "mode", "plan", "plan_us", "best",
                    "best_us")}), flush=True)
    pathlib.Path(path).parent.mkdir(parents=True, exist_ok=True)
    pathlib.Path(path).write_text(json.dumps(
        {"gpu": gpu, "timing": "time_ms, 10 launches, L2 flushed",
         "rows": rows}, indent=1))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--details", default=None, metavar="PATH",
                    help="also write every phase's record to this JSON file")
    ap.add_argument("--tile-sweep", default=None, metavar="PATH",
                    help="instead of the smoke test, time every tile x K "
                         "split of the prefill tile kernels at the serves' "
                         "prefill shapes and write them to this JSON file")
    ap.add_argument("--wkv-time", default=None, metavar="PATH",
                    help="instead of the smoke test, time the WKV6 kernels "
                         "alone at rwkv6-7b's prefill shapes and write "
                         "them to this JSON file")
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
    gpu = {"name": torch.cuda.get_device_name(0), "nvidia_smi": smi,
           "sm_clock_mhz": float(nvidia_smi("clocks.max.sm", "nounits"))}
    if args.tile_sweep or args.wkv_time:
        try:
            if args.tile_sweep:
                tile_sweep(torch, gpu, args.tile_sweep)
            else:
                wkv_time(torch, gpu, args.wkv_time)
        except CheckFailed as e:
            print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
            return 1
        print(smi, flush=True)
        return 0
    records = []
    t0 = _START[0] = time.perf_counter()
    try:
        phase_device(torch, gpu)
        phase_kernels(torch, gpu)
        flush = Flusher(torch)
        timed, verify_rows = phase_kernel_time(torch, gpu, flush)
        records.append({"kernel_time": timed})
        model = build_model(torch)
        serve, launches, serve_toks = phase_serve(torch, gpu, model)
        records.append({"serve": serve})
        paged, paged_launches, paged_shape, paged_toks = phase_serve_paged(
            torch, gpu, model)
        records.append({"serve_paged": paged})
        spec, spec_launches = phase_serve_spec(torch, gpu, model, serve,
                                               serve_toks)
        records.append({"serve_spec": spec})
        chunked, chunked_launches = phase_serve_chunked(
            torch, gpu, model, paged, paged_toks)
        records.append({"serve_chunked": chunked})
        probed, probe_launches = phase_serve_probe(
            torch, gpu, model, paged, paged_toks, paged_launches)
        records.append({"serve_probe": probed})
        chaos, chaos_launches = phase_serve_chaos(torch, gpu, model, paged,
                                                  paged_toks)
        records.append({"serve_chaos": chaos})
        door, door_launches = phase_serve_frontdoor(torch, gpu, model,
                                                    paged, paged_toks)
        records.append({"serve_frontdoor": door})
        del model
        rwkv = build_rwkv(torch)
        serve_rwkv, rwkv_launches, rwkv_shape = phase_serve_rwkv(
            torch, gpu, rwkv)
        records.append({"serve_rwkv": serve_rwkv})
        del rwkv
        torch.cuda.empty_cache()
        bp = decode_layer_summary(torch, flush, serve["n_slots"], launches)
        tile = prefill_layer_summary(torch, flush, launches["prefill_rows"],
                                     rwkv_launches["prefill_rows"], launches)
        tile["qwen2_verify_layer"] = verify_rows
        paths = {"serve": launches, "serve_paged": paged_launches,
                 "serve_spec": spec_launches,
                 "serve_chunked": chunked_launches,
                 "serve_probe": probe_launches,
                 "serve_chaos": chaos_launches,
                 "serve_frontdoor": door_launches,
                 "serve_rwkv": rwkv_launches}
        pa = paged_layer_summary(torch, flush, paged_shape, paged_launches)
        for entry, key in ((bp, "bp_matmul_gemv"), (tile, "bp_matmul_tile"),
                           (pa, "paged_attention")):
            entry["launches_by_path"] = {p: c.get(key, 0)
                                         for p, c in paths.items()}
        wk = wkv6_summary(torch, flush, gpu, rwkv_shape, rwkv_launches)
        summary = [bp, tile, pa, wk]
        for k in summary:
            check(k["launches"] > 0,
                  f"{k['name']} was never launched on its main path")
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    emit({"phase": "done", "gpu": gpu,
          "total_s": time.perf_counter() - t0})
    if args.details:
        pathlib.Path(args.details).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.details).write_text(json.dumps(
            {"gpu": gpu, "records": records, "kernels": summary},
            indent=1))
    emit({"kernels": summary})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
