#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--details PATH]
    python3 chip_smoke.py --tile-sweep PATH
    python3 chip_smoke.py --wkv-time PATH
    python3 chip_smoke.py --train-dist PATH

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
               256 among them) and qwen2-1.5b's at the train phase's M
               8192, the reference's ragged
               shapes and ragged prefill ones (K % 16 != 0, N 17 and 260),
               every projection of moonshot-v1-16b-a3b, granite-moe-1b-a400m,
               qwen2-7b, phi3-medium-14b and granite-34b (their routers and
               untied lm heads included) at M 1, 4, 8 and 256, and of
               qwen2-vl-7b, zamba2-2.7b (in_proj N 10,448: a partial tile)
               and seamless-m4t-medium (lm head N 256,256) at M 1, 4, 8,
               128 and 256,
               an A one byte off alignment (the byte loads), inputs with
               -128, and plans that split K (the GEMV's workspace must be
               zero again after them); paged attention within 1e-5 in float32 on the
               reference's ragged shapes and within one bf16 unit in the
               last place at qwen2-1.5b's decode shape, at 1, 8 and 12
               query rows per kv head (float32 and bf16), at 32 sequences
               of 8192 positions, at lengths either side of a ring stage and
               a split, on pages shared across sequences, at the further
               configs' decode shapes (G 1 at D 128, G 2 at D 64, G 7, G 4
               and G 48 on one kv head), plus a length-0 all-trash case;
               its state variant K2s (acc, m, l in float32) within 1e-5 in
               float32 on the ragged shapes, within one bf16 unit on acc / l
               at qwen2-1.5b's decode shape and at G 1, 2 (D 64), 7 and 4,
               exactly neutral (0, -0.7 FLT_MAX, 0) on negative lengths and
               all-trash tables, and merged over 2 and 4 shards of the card
               against the unsharded kernel within 1e-5 in float32; the
               sharded matmul bit-exact against the unsharded one (column
               split, split-K, replicated) at the reference's mesh shapes
               and qwen2-1.5b's gate/up at M 4 and 128;
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
               ``torch._int_mm`` in both weight layouts, every
               projection of the three last families at M 4 and 128 (beside
               ``_int_mm`` at 128), and one qwen2-1.5b
               layer's seven projections at the verify steps' rows (M 20
               and 256) and the train phase's (M 8192) beside the same
               chain of ``torch._int_mm`` calls in both weight layouts;
               WKV6 at rwkv6-7b's prefill shapes with its plan and
               achieved HBM rate; and the
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
  serve_mesh   mesh serving on the one card, on the same qwen2 weights:
               ``serve_paged``'s workload and pool on meshes (1, 2) and
               (2, 2) and ``serve``'s (slab, int8 KV) on (1, 2), every shard
               on cuda:0 (``MeshExecutor``: one controller, the weights cut
               per shard at placement, the paged table widened to a
               multiple of 4 blocks so the KV splits).  K1 launches once per
               shard and K2s once per model shard per layer per paged
               decode step, exactly as the step stream predicts, K2 never;
               streams equal ``serve_paged``'s and ``serve``'s except
               near-tie flips, each reported.  Reports per mesh step
               p50/p90, decode tokens/s beside the single-device serve's,
               K1 launches per shard and peak memory;
  serve_modes  the configurations ``examples_torch/serve_lm.py`` exposes,
               through its own functions on the same qwen2 weights and
               its own workload (8 requests on 4 slots, 32-token prompts,
               up to 24 new tokens, Poisson arrivals at 0.3 a step, lead
               window 4): bp_approx on the slab store with an int8 KV
               cache (tokens equal ``generate()``'s but reported near-ties,
               K1 exactly per route, the positions agreeing with a bp_exact
               serve counted), bf16 on the paged store with a bf16 KV
               cache (the same weights unquantized; tokens equal
               ``generate()``'s but near-ties, K1 never, K2 once per layer
               per decode step) and bp_exact at temperature 0.8 twice
               (identical streams, tokens in the padded vocabulary).  Each
               serve reports decode tokens/s, step p50/p90, TTFT p50, peak
               memory and launches; K1's approximate and exact GEMV chains
               of one layer at the decode rows are timed beside the bp_approx
               decode step;
  examples     each ``examples_torch`` script's ``main`` on the card at its
               small defaults: serve_lm in bp_approx with ``--probe 2
               --metrics`` (under build/), estimate_deployment
               ``--measured`` on that file, quickstart (K1 once, equal to
               its plain version), train_lm for 6 steps with
               ``--compress-grads`` in a temporary directory, resumed to
               step 8, and the front door with one replica and its drive;
               any failure fails the script;
  serve_rwkv   the third main path, after the qwen2 weights are freed:
               full-width rwkv6-7b cut to 12 of its 32 layers
               (``RWKV_SERVE_LAYERS``, for the 1200 s limit; random weights
               from a seed) in bp_exact on the slab store, greedy; prompts
               of 64-256
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
               prefill of the serve within 3e-2 of the plain serve's;
  serve_moe    the fourth main path, the MoE family, after the rwkv
               weights are freed, one JSON line per model: full-width
               moonshot-v1-16b-a3b cut to 24 of its 48 layers (64 experts
               of d_ff 1408, top 6; random weights from a seed, the expert
               stacks drawn a layer at a time into bf16, ~27 GB) on
               ``serve_paged``'s workload, block size and 36-block pool,
               then four requests of full-width granite-moe-1b-a400m (K2 at
               head dim 64, a 32-block pool), both in bp_exact with a bf16
               KV cache.  K1 must launch 5 times per layer per forward (q,
               k, v, o, the router) plus once for the lm head, per route,
               and K2 once per layer per decode step; the pool must
               preempt.  Tokens are held against the same engine on the
               plain versions: streams may part only at a near-tie, of the
               final logits (within 4 bf16 units at the step where they
               part) or of a router top-k (shown by re-running each decode
               step from the same state with the plain K2: a layer's picks
               change); a part that is neither fails.  A slab serve with an
               int8 KV cache bypasses K2, so its tokens must equal its
               plain version's exactly.  ``generate()`` (first 8 tokens)
               groups other tokens than the serve, so capacity drops
               differ: its parts are counted, not held.  Reports the
               weight bytes by kind, peak memory, decode tokens/s, step
               p50/p90 and TTFT beside
               ``serve_paged``'s, and a profiled two-request serve's device
               time per decode step (its steps annotated) against the
               expert stacks' byte bound (every expert is read every step:
               the capacity buffer spans all of them);
  serve_vlm    the fifth main path, after the MoE weights are freed:
               full-width, full-depth qwen2-vl-7b (28 layers, d 3584, 28
               heads on 4 kv heads of 128, M-RoPE sections 16/24/24, vocab
               152,064) in bp_exact on the paged store, bf16 KV, with
               per-request ``extras``: six requests open with a vision span
               of 64-256 image-pad tokens and bf16-scale patch embeddings
               (requests 0 and 1: equal tokens, other images), two
               text-only ones share a 128-token system prompt.  K1 7 per
               layer per forward plus the lm head, per route, and K2 once
               per layer per decode step, exactly; tokens equal the plain
               serve, a slab serve and every request's own ``generate()``
               except near-tie flips, each reported; only the text-only
               pair shares prefix blocks (1-9); a ``generate()`` on three
               unequal M-RoPE rows (the image on an 8 x 16 grid) runs
               ``mrope_angles`` on the card, kernel against plain;
  serve_hybrid full-width zamba2-2.7b cut to 24 of its 54 Mamba-2 layers
               (4 of 9 super-blocks; d 2560, SSM state 64, a shared
               attention + GELU block every 6 layers, vocab 32,000) in bp_exact on the slab store; prompts
               of 64-256 tokens (the chunked SSD) and of 100 and 77 (the
               step recurrence).  K1 2 per Mamba layer and 6 per shared
               block per forward plus the lm head, exactly; tokens equal
               the plain serve and ``generate()`` except near-tie flips,
               a near-tie lying within 4 bf16 units or within the model's
               float32 noise floor measured in the run, as for rwkv6-7b
               (the chunked prefill against the step recurrence);
  serve_audio  full-width, full-depth seamless-m4t-medium (12 encoder and
               12 decoder layers, d 1024, vocab 256,206) in bp_exact on the
               slab store, ``src_embeds`` of 128 frames per request but one
               of 80 (the ``cross_len`` mask over a 128-position pool).  K1
               6 per encoder layer, 2 per decoder layer's cross K/V, 8 per
               decoder layer and the lm head, exactly; tokens equal the
               plain serve and ``generate()`` stream for stream except
               near-tie flips.  Each of the three reports weight bytes,
               peak memory, step p50/p90, decode tokens/s, TTFT, and a
               profiled one-request serve's device time per decode step
               and idle share; each engine and model is freed before the
               next;
  train        the training path, after every serve: full-width,
               full-depth qwen2-1.5b (random weights from a seed), the
               repo's synthetic Zipf data at 8 sequences of 1024 tokens a
               step.  (a) qat: ``make_train_step`` for 8 steps at
               grad_accum 2 (peak lr 1e-3, warmup 2, cosine over 8) on
               the ``PrefetchingLoader``'s batches; every loss finite,
               every step committed, step 8's loss below step 1's, K1
               never launched; step wall p50/p90, tokens/s (every token
               over the summed step walls, and at the p50 wall), peak
               memory.  Before it, the resume check on the same width cut
               to 2 layers (the full state's 21.6 GB took 50-55 s to
               write and read): a ``Trainer`` for 4 steps, saved at step 4
               (keep 1, under build/, deleted after), then a fresh
               ``Trainer`` that resumes there (every leaf of params and
               optimizer state bit-equal to the saved one) and runs to 8,
               every loss finite and every step committed; the
               checkpoint's write and read seconds and GB/s.  (b) bp_exact: two ``make_train_step``
               steps at grad_accum 1 (K1's tiles at M 8192), after one
               step from the same params and batch on the plain versions
               (rejected on purpose, so it leaves the state as it was):
               K1 launches exactly 7 per checkpointed layer run (a forward
               and a recomputation per layer and step, counted), losses
               within 1e-3 relative and grad norms within 1e-2, and every
               dense weight's Adam moments exactly zero after both steps
               (the reference's STE gives them no gradient).  (c)
               bp_approx: one step, finite, K1 exact.  (d) a profiled
               step of qat, then one of bp_exact: device busy and idle,
               the top kernels, K1's share of device time;
  train_dist   the rest of training on full-width qwen2-1.5b.  (a)
               ``BoundedStalenessTrainer`` in qat, E 3, four groups of 2 x
               512 tokens of the Zipf data, ``update_fn`` on
               ``apply_updates``: a first step with lags forced to 0 within
               1e-2 (per-leaf relative Frobenius of the float32 master's
               change) of one synchronous ``make_train_step`` update on the
               groups joined (grad_accum 4); three steps with drawn lags,
               each group's gradient taken on the version its lag names;
               then one bp_exact step, K1 exactly 392 tiles a group (7 x 56
               layer runs); E+1 versions in the ring, each with its own
               storage; losses finite; peak memory.  (b) ``pipeline_apply``
               over a 4-stage ("model",) mesh on the card, 7 decoder
               layers a stage, 4 microbatches of a 8 x 512 batch: bp_exact
               forward bit-equal to the stack run one microbatch at a
               time, K1 exactly 7 x 28 x 4; the gap to the whole-batch
               stack printed; qat gradients of a scalar loss within 1e-2
               of the stack's, the worst leaf printed.  (c) elastic: a
               2-layer state of the same width (params and AdamW state)
               placed on a (2, 2) train mesh on the card, saved, restored
               onto (1, 4), (4, 1) and (1, 1) and gathered, each bit-equal
               to the original; GB/s.  (d) the dry-run record of the
               ``train`` phase's cell (8 x 1024 tokens, mesh (1, 1),
               meta) in qat and bp_exact against ``op_analysis`` around
               one real step of each on the card: dot FLOPs (float and
               int) and argument bytes equal exactly; the predicted peak
               beside ``max_memory_allocated``; ``HBM_PER_CHIP`` against
               the card's memory.

Then one ``{"kernels": [...]}`` line, the ``nvidia-smi`` name/power-limit
line, and last ``{"ok": true, "device": {...}}``.  Any failed check exits 1.

``--wkv-time PATH`` runs none of that either: it builds the WKV6 library
alone and times it at rwkv6-7b's prefill shapes (``kernel_time``'s WKV6
rows), writing them to PATH; copied into an older checkout it times that
checkout's kernel with the same harness, for an A/B within one call.

``--train-dist PATH`` builds the kernels and runs the ``train_dist``
phase alone, writing its record to PATH.

``--tile-sweep PATH`` runs none of that: it times every tile x K split of
the BitParticle matmul's prefill tile kernels at the serves' prefill
shapes, each held bit-exact against the plain version, beside the host
plan's own choice (``ops.tile_plan``, whose thresholds were fitted to this
sweep), and writes them to PATH.
"""

from __future__ import annotations

import argparse
import json
import math
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
# the further configs whose projections and decode attention the kernels
# phase checks (``projection_kn``, ``attention_dims``): the MoE family
# (``serve_moe`` serves both) and the dense configs not served here
FURTHER_CONFIGS = ("moonshot-v1-16b-a3b", "granite-moe-1b-a400m", "qwen2-7b",
                   "phi3-medium-14b", "granite-34b")
# rows those projections are checked at: the decode GEMV's 1, 4 and 8, and
# one prefill's 256 (the tiles)
FURTHER_CHECK_M = (1, 4, 8, 256)
# the last three families, served by serve_vlm, serve_hybrid and
# serve_audio: their projections are checked at FURTHER_CHECK_M and at
# 128 (a prefill's tiles), before any serve runs them.  zamba's in_proj (N
# 10,448: a multiple of 16, not of 32) leaves a partial tile and a partial
# GEMV column group; seamless's lm head (N 256,256) is the widest GEMV
NEW_CONFIGS = ("qwen2-vl-7b", "zamba2-2.7b", "seamless-m4t-medium")
NEW_CHECK_M = (1, 4, 8, 128, 256)
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
#: the train phase's rows per projection call in bp_* modes: 8 sequences
#: of 1024 tokens in one micro-batch
TRAIN_M = 8192
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
#: serve_moe: each model's requests and pool (the trash page included).
#: moonshot-v1-16b-a3b takes ``serve_paged``'s workload, whose lengths its
#: request generator draws alike, so its 36 blocks preempt as qwen2's do
#: (4 times in a CPU rehearsal); granite-moe-1b-a400m's 4 requests hold up
#: to 39 blocks unbounded, and 32 preempt once in the rehearsal
#: moonshot runs 24 of its 48 layers (``layers``): the whole script must
#: finish within its time limit, and this phase took the largest share
MOE_SERVES = {"moonshot-v1-16b-a3b": {"n_requests": 8, "num_blocks": 36,
                                      "seed": 1, "layers": 24},
              "granite-moe-1b-a400m": {"n_requests": 4, "num_blocks": 32,
                                       "seed": 5}}
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
#: each phase's last line's seconds since then, by phase (the details
#: file keeps them: where the script's time limit goes)
_ELAPSED = {}


def emit(obj: dict) -> None:
    if "phase" in obj:
        obj = {**obj, "elapsed_s": time.perf_counter() - _START[0]}
        _ELAPSED[obj["phase"]] = obj["elapsed_s"]
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
                    block_size: int, pages_per_seq: int, esize: int = 2,
                    state: bool = False):
    """(bound_ms, bound_by) of paged decode attention: the larger of bytes
    over HBM rate (the valid K and V rows of every sequence, q, the output,
    the tables and lengths, each once) and its flops (q.k and p.v, two per
    multiply-add) over the bf16 tensor-core rate.  ``state``: the output
    is K2s's float32 (acc, m, l)."""
    B = len(lengths)
    tokens = sum(min(max(int(n) + 1, 0), pages_per_seq * block_size)
                 for n in lengths)
    out_bytes = (B * n_heads * (4 * head_dim + 8) if state
                 else B * n_heads * head_dim * esize)
    nbytes = (2 * tokens * kv_heads * head_dim * esize
              + B * n_heads * head_dim * esize + out_bytes
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


def family_layer_kn(cfg, encoder=False):
    """(K, N) of the BitParticle matmuls of one repeating unit of a new
    family's forward, in call order: a qwen2-vl decoder layer's 7, a
    zamba super-block (``attn_every`` Mamba layers' in and out
    projections, then the shared block's q, k, v, o, FFN up and down), a
    seamless decoder layer's 8 (self q, k, v, o, cross q and o, FFN up and
    down), or with ``encoder`` its encoder layer's 6 (q, k, v, o, FFN up
    and down: what its prefill runs at the source's rows)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    q, kv = (d, cfg.num_heads * hd), (d, cfg.num_kv_heads * hd)
    attn = (q, kv, kv, q[::-1])
    ffn = ((d, cfg.d_ff), (cfg.d_ff, d))
    if cfg.family == "vlm":
        return attn + ((d, cfg.d_ff),) + ffn
    if cfg.family == "hybrid":
        mamba = projection_kn(cfg)[:2]
        return tuple(mamba) * cfg.attn_every + attn + ffn
    if encoder:
        return attn + ffn
    return attn + (q, q[::-1]) + ffn


def projection_kn(cfg):
    """(K, N) of each distinct BitParticle matmul of a config's forward:
    a hybrid's Mamba in and out projections, q, k / v, o, the dense FFN's
    in and out or the MoE router, and the untied lm head (on the padded
    vocabulary)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    kn = []
    if cfg.family == "hybrid":
        di = 2 * d
        kn += [(d, 2 * di + 2 * cfg.ssm_state + di // cfg.ssm_head_dim),
               (di, d)]
    kn += [(d, cfg.num_heads * hd), (d, cfg.num_kv_heads * hd),
           (cfg.num_heads * hd, d)]
    if cfg.num_experts:
        kn.append((d, cfg.num_experts))
    else:
        kn += [(d, cfg.d_ff), (cfg.d_ff, d)]
    if not cfg.tie_embeddings:
        kn.append((d, cfg.vocab_padded))
    return list(dict.fromkeys(kn))


def attention_dims(cfg):
    """(query heads, kv heads, head dim) of a config's decode attention."""
    return cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim


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
    entries = [check_bp_matmul(torch), check_bp_matmul_sharded(torch),
               check_paged_attention(torch),
               check_paged_attention_state(torch), check_wkv6(torch)]
    emit({"phase": "kernels", "gpu": gpu, "kernels": entries})
    for e in entries:
        check(not e["failures"], f"{e['name']} disagrees with its plain "
                                 f"version on {len(e['failures'])} cases: "
                                 f"{e['failures'][:3]}")


def check_bp_matmul(torch):
    """The BitParticle matmul bit-exact against its plain version (raw
    int32 and fused float32, both modes), on each route: the decode GEMV
    (M <= 8) and the prefill tile kernels (M > 8: ``mma.sync``, and
    ``wgmma`` for exact mode's larger tiles), at the served models' shapes
    and every further config's projections (``FURTHER_CONFIGS``: the MoE
    routers at N 64 and 32, the untied lm heads up to N 163,840) at M 1, 4,
    8 and 256, each route's cases and error
    kept apart; plans that split K are counted (the tiles' slices sum in a
    cluster's shared memory, the GEMV's in a workspace, which must be zero
    again after them)."""
    from repro_torch.configs.base import get_arch
    from repro_torch.kernels.bitparticle_matmul import ops
    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = [(m, k, n) for m in (1, 4, 8) for k, n in QWEN_KN + RWKV_KN]
    shapes += [(m, k, n) for m in PREFILL_CHECK_M
               for k, n in QWEN_KN + RWKV_KN[:3]]
    further = [(m, k, n) for name in FURTHER_CONFIGS
               for k, n in projection_kn(get_arch(name))
               for m in FURTHER_CHECK_M]
    further += [(m, k, n) for name in NEW_CONFIGS
                for k, n in projection_kn(get_arch(name))
                for m in NEW_CHECK_M]
    shapes += further
    # the train phase's bp_* steps: qwen2-1.5b's projections at M 8192
    shapes += [(TRAIN_M, k, n) for k, n in QWEN_KN]
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
            "further_configs": {name: projection_kn(get_arch(name))
                                for name in FURTHER_CONFIGS + NEW_CONFIGS},
            "further_cases": 4 * len(further),
            "parity": "ok" if not failures else "FAILED",
            "failures": failures[:10]}


def check_paged_attention(torch):
    """The paged-attention kernel against its plain version: float32 on the
    reference's ragged shapes (atol = rtol = 1e-5, that test's own), bf16 at
    qwen2-1.5b's decode shape and at the further configs' (one bf16 unit in
    the last place, see ``bf16_ulp``), and length-0 slots whose tables are
    all trash."""
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
    # the further configs' decode attention: G 1 (moonshot), G 2 at head
    # dim 64 (granite-moe), G 7 (qwen2-7b), G 4 (phi3), G 48 on one kv head
    # (granite-34b: six groups of 8)
    from repro_torch.configs.base import get_arch
    for name in FURTHER_CONFIGS + ("qwen2-vl-7b",):
        h, kh, d = attention_dims(get_arch(name))
        lengths = torch.randint(0, bs * pps, (4,), generator=gen,
                                device="cuda").tolist()
        cases.append((f"{name} H{h} KH{kh} D{d} B4", "bfloat16",
                      paged_case(torch, gen, 4, h, kh, d, 4 * pps + 1, bs,
                                 pps, lengths, torch.bfloat16)))
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


def cuda_mesh(torch, data, model):
    """A ``(data, model)`` mesh with every shard on the card (one card:
    the shards launch one after another on its default stream)."""
    from repro_torch.launch.mesh import make_local_mesh
    return make_local_mesh(data, model,
                           devices=[torch.device("cuda", 0)] * (data * model))


def _state_err(torch, got, want):
    """(max |acc/l| difference, max |m| difference, whether the kernel's
    state is finite) of K2s against its plain version.  Where l is 0 (no
    valid position) both ratios are taken as 0."""
    def ratio(acc, l):
        return torch.where(l > 0, acc / torch.where(l > 0, l, 1.0), 0.0)

    r_got, r_want = ratio(got[0], got[2]), ratio(want[0], want[2])
    finite = all(bool(torch.isfinite(t).all()) for t in got)
    return r_got, r_want, (got[1] - want[1]).abs().max().item(), finite


def check_paged_attention_state(torch):
    """K2s, the paged-attention kernel's state variant, against its plain
    version: float32 on the reference's ragged shapes (acc, m and l each
    within atol = rtol = 1e-5), bf16 at qwen2-1.5b's decode shape and at
    the further configs' groupings (G 1, 2 at D 64, 7, 4; acc / l within
    one bf16 unit, m within 1e-4), rows with negative lengths and all-trash
    tables exactly neutral (acc 0, m -0.7 FLT_MAX, l 0) on one and on
    several splits, and the split-KV merge over 2 and 4 shards of one card
    against the unsharded K2 within 1e-5 in float32, far shards included."""
    from repro_torch.configs.base import get_arch
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.paged_attention.ref import NEG_INF
    gen = torch.Generator(device="cuda").manual_seed(13)
    H, KH, D, bs = (QWEN_ATTN[k] for k in ("H", "KH", "D", "bs"))
    neg_inf = torch.tensor(NEG_INF, dtype=torch.float32).item()
    failures, max_err, n_cases = [], 0.0, 0

    def state(args, backend):
        return pa_ops.paged_attention_state(*args, backend=backend)

    # float32 on the ragged shapes
    for B, h, kh, d, nb, b_s, pps, t_hi in PA_RAGGED:
        lengths = torch.randint(0, t_hi, (B,), generator=gen,
                                device="cuda").tolist()
        args = paged_case(torch, gen, B, h, kh, d, nb, b_s, pps, lengths,
                          torch.float32)
        got, want = state(args, "kernel"), state(args, "plain")
        torch.cuda.synchronize()
        n_cases += 1
        err = max((g - w).abs().max().item() for g, w in zip(got, want))
        max_err = max(max_err, err)
        if not all(torch.allclose(g, w, atol=1e-5, rtol=1e-5)
                   for g, w in zip(got, want)):
            failures.append({"case": f"ragged B{B} H{h} KH{kh} D{d}",
                             "max_abs_err": err})
    # bf16 at the models' decode groupings
    pps = 32
    dims = [("qwen2-1.5b", (H, KH, D))] + [
        (name, attention_dims(get_arch(name)))
        for name in ("moonshot-v1-16b-a3b", "granite-moe-1b-a400m",
                     "qwen2-7b", "phi3-medium-14b")]
    for name, (h, kh, d) in dims:
        lengths = torch.randint(0, bs * pps, (4,), generator=gen,
                                device="cuda").tolist()
        args = paged_case(torch, gen, 4, h, kh, d, 4 * pps + 1, bs, pps,
                          lengths, torch.bfloat16)
        got, want = state(args, "kernel"), state(args, "plain")
        torch.cuda.synchronize()
        n_cases += 1
        r_got, r_want, m_err, finite = _state_err(torch, got, want)
        err = (r_got - r_want).abs()
        max_err = max(max_err, err.max().item())
        if not (finite and bool((err <= bf16_ulp(torch, r_want)).all())
                and m_err <= 1e-4):
            failures.append({"case": f"{name} H{h} KH{kh} D{d} bf16",
                             "max_abs_err": err.max().item(),
                             "m_err": m_err})
    # exactly neutral rows: negative lengths (a far shard) and all-trash
    # tables, on a 4-page table (one split) and a 512-page one (several)
    for dtype in (torch.float32, torch.bfloat16):
        for P in (4, 512):
            lens = [-1, -bs * P, -7, 5]
            q, kp, vp, tables, _ = paged_case(torch, gen, 4, H, KH, D,
                                              4 * P + 1, bs, P, [5] * 4,
                                              dtype)
            tables[1:3] = 0
            lt = torch.tensor(lens, dtype=torch.int32, device="cuda")
            got = state((q, kp, vp, tables, lt), "kernel")
            torch.cuda.synchronize()
            n_cases += 1
            acc, m, l = (t[:3] for t in got)
            neutral = (bool((acc == 0).all()) and bool((l == 0).all())
                       and bool((m == neg_inf).all())
                       and bool(torch.isfinite(got[0]).all()))
            if not neutral:
                failures.append({"case": f"neutral rows P{P} {dtype}",
                                 "acc_max": acc.abs().max().item(),
                                 "l_max": l.abs().max().item(),
                                 "m": m.flatten()[:4].tolist()})
    # the split-KV merge over 2 and 4 shards against the unsharded K2, in
    # float32: a short table (far shards hold nothing) and 8192 positions
    # (several splits per shard)
    for B, P, lengths in ((4, 8, [0, 17, 60, 127]),
                          (4, 512, [8191, 5000, 2047, 100])):
        args = paged_case(torch, gen, B, H, KH, D, B * P + 1, bs, P,
                          lengths, torch.float32)
        want = pa_ops.paged_attention(*args, backend="kernel")
        for model in (2, 4):
            got = pa_ops.paged_attention(*args, backend="kernel",
                                         mesh=cuda_mesh(torch, 1, model))
            torch.cuda.synchronize()
            n_cases += 1
            err = (got - want).abs().max().item()
            max_err = max(max_err, err)
            if not (torch.allclose(got, want, atol=1e-5, rtol=1e-5)
                    and bool(torch.isfinite(got).all())):
                failures.append({"case": f"merge over {model} shards, "
                                         f"{P} pages", "max_abs_err": err})
    torch.cuda.synchronize()
    cnt = pa_ops._COUNTERS.get(torch.device("cuda", 0))
    left = 0 if cnt is None else int(cnt.abs().sum())
    if left:
        failures.append({"counters_left_nonzero": left})
    pa_ops.reset_launches()
    return {"name": "paged_attention_state", "cases": n_cases,
            "tolerance": "float32: atol = rtol = 1e-5 on acc, m and l "
                         "(the merge: on the output); bfloat16: acc / l "
                         "within one bf16 unit (at magnitudes >= 2^-8), m "
                         "within 1e-4; masked rows exactly (0, -0.7 "
                         "FLT_MAX, 0)",
            "max_abs_err": max_err,
            "parity": "ok" if not failures else "FAILED",
            "failures": failures[:10]}


def check_bp_matmul_sharded(torch):
    """The sharded BitParticle matmul bit-exact against the unsharded
    kernel (raw int32 and fused float32, both modes): the reference's five
    mesh shapes on a (2, 4) mesh of one card (column split, split-K,
    replicated; the batch over "data" where it divides) and qwen2-1.5b's
    gate/up at M 4 and 128 on (1, 2) and (2, 2)."""
    from repro_torch.kernels.bitparticle_matmul import ops
    gen = torch.Generator(device="cuda").manual_seed(17)
    cases = [((b, s), k, n, (2, 4)) for b, s, k, n in
             ((4, 1, 33, 128), (4, 4, 33, 128), (4, 1, 128, 130),
              (4, 4, 128, 130), (5, 1, 33, 17))]
    k_up, n_up = QWEN_KN[2]
    cases += [((m,), k_up, n_up, mesh) for m in (4, 128)
              for mesh in ((1, 2), (2, 2))]
    failures, strategies = [], {}
    for lead, k, n, shape in cases:
        m = 1
        for d in lead:
            m *= d
        a, w, sa, sw = _rand_case(torch, gen, m, k, n)
        a, sa = a.reshape(*lead, k), sa.reshape(*lead, 1)
        placed = ops.place_weight(w, sw, cuda_mesh(torch, *shape))
        strategies[placed.strategy] = strategies.get(placed.strategy, 0) + 1
        for name, approx in MODES:
            got_i = ops.bp_matmul_sharded(a, placed, approx=approx,
                                          backend="kernel")
            want_i = ops.bp_matmul(a, w, approx=approx, backend="kernel")
            got_f = ops.bp_matmul_sharded(a, placed, sa, approx=approx,
                                          backend="kernel")
            want_f = ops.bp_matmul(a, w, sa, sw, approx=approx,
                                   backend="kernel")
            torch.cuda.synchronize()
            if not (torch.equal(got_i, want_i) and torch.equal(got_f,
                                                              want_f)):
                failures.append({"lead": lead, "k": k, "n": n,
                                 "mesh": shape, "mode": name,
                                 "strategy": placed.strategy})
    ops.reset_launches()
    return {"name": "bp_matmul_sharded", "cases": 4 * len(cases),
            "strategies": strategies,
            "tolerance": "bit-exact against the unsharded kernel (int32 "
                         "and float32)",
            "max_abs_err": 0.0 if not failures else None,
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
    from repro_torch.configs.base import get_arch
    new_rows = []
    for name in NEW_CONFIGS:
        for k, n in projection_kn(get_arch(name)):
            for m in (4, 128):
                row = time_case(torch, flush, gen, m, k, n, False,
                                plain_iters=3 if m * k * n > 2 ** 34
                                else 10)
                new_rows.append({"config": name, **row})
    ops.reset_launches()
    emit({"phase": "kernel_time", "gpu": gpu, "kernel": "bp_matmul",
          "route": "decode GEMV (M 4) and prefill tiles (M 128)",
          "shape": "every distinct projection of qwen2-vl-7b, zamba2-2.7b "
                   "(Mamba in_proj N 10,448, out_proj, the shared block, "
                   "lm head) and seamless-m4t-medium (lm head N 256,256), "
                   "exact mode",
          "library": "torch._int_mm at M 128, both weight layouts; "
                     "library_ms is the faster",
          "event_floor_ms": floor, "rows": new_rows})
    verify_rows = [verify_layer_row(torch, flush, gen, m)
                   for m in VERIFY_M]
    train_row = verify_layer_row(torch, flush, gen, TRAIN_M)
    ops.reset_launches()
    emit({"phase": "kernel_time", "gpu": gpu, "kernel": "bp_matmul",
          "route": "verify tiles (M > 8)",
          "shape": "one qwen2-1.5b layer's 7 projections, exact mode, at "
                   "the verify steps' rows: M 20 (4 slots x K+1 = 5, "
                   "speculation) and 256 (4 slots x a 64-token chunk)",
          "library": "the same chain of torch._int_mm calls in each weight "
                     "layout; library_ms is the faster",
          "event_floor_ms": floor, "rows": verify_rows})
    emit({"phase": "kernel_time", "gpu": gpu, "kernel": "bp_matmul",
          "route": "train tiles (M > 8)",
          "shape": "one qwen2-1.5b layer's 7 projections, exact mode, at "
                   "the train phase's bp_* rows: M 8192 (8 sequences of "
                   "1024 tokens)",
          "library": "the same chain of torch._int_mm calls in each weight "
                     "layout; library_ms is the faster",
          "event_floor_ms": floor, "rows": [train_row]})
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
    return (rows + tile_rows + new_rows + verify_rows + [train_row]
            + pa_rows + wkv_rows, verify_rows, train_row)


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


def time_paged_case(torch, flush, gen, B, lengths, pps=None, dims=None):
    """Median times of paged attention at qwen2-1.5b's decode shape (or at
    ``dims`` = (H, KH, D)) with the given lengths (inclusive last
    positions): the kernel, its plain version and the library yardstick,
    beside the bound."""
    from repro_torch.kernels.paged_attention.ops import paged_attention
    H, KH, D, bs = (QWEN_ATTN[k] for k in ("H", "KH", "D", "bs"))
    if dims is not None:
        H, KH, D = dims
    if pps is None:
        pps = max(int(n) for n in lengths) // bs + 1
    args = paged_case(torch, gen, B, H, KH, D, B * pps + 1, bs, pps, lengths,
                      torch.bfloat16)
    got = paged_attention(*args, backend="kernel")
    want = paged_attention(*args, backend="plain")
    row = {"B": B, "H": H, "KH": KH, "D": D,
           "lengths": [int(n) for n in lengths][:8], "pages_per_seq": pps,
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
    per route, K2, K2s (its state variant), K2's calls routed to the plain
    gather (int8 KV pages), and K3."""
    from repro_torch.kernels.bitparticle_matmul import ops as bp_ops
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.wkv6 import ops as wkv_ops
    return {"bp_matmul": bp_ops.LAUNCHES["bp_matmul"],
            "bp_matmul_gemv": bp_ops.LAUNCHES["gemv"],
            "bp_matmul_tile": bp_ops.LAUNCHES["tile"],
            "paged_attention": pa_ops.LAUNCHES["paged_attention"],
            "paged_attention_state":
                pa_ops.LAUNCHES["paged_attention_state"],
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


#: serve_mesh: the (data, model) meshes of the paged serves, every shard on
#: the one card, and the mesh of the slab serve
MESH_PAGED = ((1, 2), (2, 2))
MESH_SLAB = (1, 2)


def mesh_routes(stream, per_forward, shape):
    """K1's launches in a mesh serve, from its step stream: each forward's
    ``per_forward`` projections (every one a column split: qwen2-1.5b's N
    divide by 2) launch once per model shard and per data shard where the
    forward's batch (a prefill's group, a decode step's slots) divides by
    "data", else on data shard 0 alone; each shard's rows take the GEMV up
    to 8, else the tiles.  Returns the launches by route and by shard, and
    the data shards of the decode steps (K2s launches that many times the
    model shards per layer per step)."""
    from repro_torch.kernels.bitparticle_matmul.ops import GEMV_MAX_M
    data, model = shape
    routes, per_shard = {"gemv": 0, "tile": 0}, {}
    decode_data = set()
    for r in stream:
        if r["kind"] == "prefill":
            batch, rows = r["group_size"], r["pad_to"]
        elif r["kind"] == "decode":
            batch, rows = r["n_slots"], 1
        else:
            continue
        n_d = data if batch % data == 0 else 1
        if r["kind"] == "decode":
            decode_data.add(n_d)
        m = batch // n_d * rows
        routes["tile" if m > GEMV_MAX_M else "gemv"] += (per_forward * model
                                                         * n_d)
        for i in range(n_d):
            for j in range(model):
                per_shard[f"{i},{j}"] = per_shard.get(f"{i},{j}",
                                                      0) + per_forward
    return routes, per_shard, decode_data


def phase_serve_mesh(torch, gpu, model, paged_base, paged_toks, serve_base,
                     serve_toks, n_slots=4, lead_window=4, block_size=16,
                     num_blocks=PAGED_NUM_BLOCKS):
    """Mesh serving on the card: ``serve_paged``'s workload and pool on
    meshes (1, 2) and (2, 2), then ``serve``'s (slab, int8 KV) on (1, 2),
    every shard on the one card (``MeshExecutor``, one controller).  The
    quantized weights are ``build_model``'s, cut per shard at placement.
    The paged table is widened to a multiple of 4 blocks, so every decode's
    attention splits its KV over the model shards (K2s per shard, then the
    state merge).  K1 and K2s launch exactly as the step stream predicts
    (``mesh_routes``), K2 never; streams equal ``serve_paged``'s and
    ``serve``'s except flips at argmax near-ties (the merge and the wider
    table sum in another order), each reported."""
    import numpy as np

    from repro_torch import serving

    params = model["params"]
    sched = serving.SchedulerConfig(lead_window=lead_window)
    runs = [("paged", shape) for shape in MESH_PAGED] + [("slab", MESH_SLAB)]
    out = {"phase": "serve_mesh", "gpu": gpu, "model": model["cfg"].name,
           "layers": model["cfg"].num_layers, "serves": []}
    t_phase = time.perf_counter()
    failed, state_shape = [], None
    for backend, shape in runs:
        cfg = model["cfg"].replace(kv_cache_int8=backend == "slab")
        if backend == "paged":
            prompts = _paged_requests(serving, np.random.default_rng(1),
                                      cfg.vocab_size, 8)
            want, base = paged_toks, paged_base
            cache_T = max(r.prompt_len + r.max_new_tokens
                          for r in prompts) + 8
            # a table width that 2 and 4 divide
            cache_T = -(-cache_T // (4 * block_size)) * 4 * block_size
            kw = dict(num_blocks=num_blocks)
        else:
            prompts = _requests(serving, np.random.default_rng(0),
                                cfg.vocab_size, 8)
            want, base = serve_toks, serve_base
            cache_T = max(r.prompt_len + r.max_new_tokens
                          for r in prompts) + 8
            kw = {}
        mesh = cuda_mesh(torch, *shape)
        engine = serving.ServingEngine(
            cfg, params, serving.ServeConfig(
                max_new_tokens=32, temperature=0.0, cache_backend=backend,
                block_size=block_size, mesh_shape=shape),
            executor=serving.make_executor(cfg, params, mesh=mesh))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        loop = engine.make_loop(_copies(serving, prompts), n_slots=n_slots,
                                cache_T=cache_T, sched_cfg=sched, **kw)
        step_lengths = []
        if backend == "paged":
            loop.on_step_end = lambda lp: step_lengths.append(
                lp.cm.cache_len_vector().tolist())
        report = loop.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts()
        no_fault_guard(report, loop.stream, "serve_mesh")
        toks = {r.request_id: r.tokens.tolist() for r in report.results}
        routes, per_shard, decode_data = mesh_routes(
            loop.stream, 7 * cfg.num_layers, shape)
        k2s = (cfg.num_layers * shape[1] * max(decode_data, default=1)
               * report.steps if backend == "paged" else 0)
        expected = {"bp_matmul": routes["gemv"] + routes["tile"],
                    "bp_matmul_gemv": routes["gemv"],
                    "bp_matmul_tile": routes["tile"],
                    "paged_attention": 0,
                    "paged_attention_state": k2s,
                    "routed_plain_int8_kv": 0}
        flips = _stream_flips(torch, np, engine,
                              [r.prompt for r in prompts], toks, want,
                              cache_T, (f"mesh{shape[0]}x{shape[1]}",
                                        "single"))
        step_ms = [1e3 * r["wall_s"] for r in loop.stream
                   if r["kind"] == "decode"]
        p = serving.percentiles(step_ms, qs=(50, 90))
        rec = {"cache_backend": backend, "mesh": list(shape),
               "report_mesh_shape": list(report.mesh_shape or ()),
               "cache_T": cache_T,
               "blocks_per_seq": getattr(loop.cm, "blocks_per_seq", None),
               "kv_cache_int8": cfg.kv_cache_int8,
               "decode_steps": report.steps,
               "total_new_tokens": report.total_new_tokens,
               "n_preemptions": report.n_preemptions,
               "launches": launches, "expected_launches": expected,
               "bp_matmul_launches_per_shard": per_shard,
               "decode_data_shards": sorted(decode_data),
               "tokens_equal_single_device": not flips,
               "flips": flips,
               "decode_tokens_per_s": report.decode_tokens_per_s,
               "step_wall_tokens_per_s": step_wall_rate(loop.stream),
               "decode_step_ms_p50": p["p50"] if p else None,
               "decode_step_ms_p90": p["p90"] if p else None,
               "single_device_step_ms_p50": base["decode_step_ms_p50"],
               "single_device_decode_tokens_per_s":
                   base["decode_tokens_per_s"],
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
               "serve_wall_s": wall}
        out["serves"].append(rec)
        for name, n in expected.items():
            if launches[name] != n:
                failed.append(f"{backend} {shape}: {name} launched "
                              f"{launches[name]} times, expected {n}")
        if report.mesh_shape != shape:
            failed.append(f"{backend} {shape}: report mesh_shape "
                          f"{report.mesh_shape}")
        bad = [f for f in flips if not f["near_tie"]]
        if bad:
            failed.append(f"{backend} {shape}: mesh and single-device "
                          f"streams differ beyond a near-tie: {bad}")
        if not all(r.finish_reason == "length" for r in report.results):
            failed.append(f"{backend} {shape}: a request finished for "
                          f"another reason than length")
        if backend == "paged" and state_shape is None:
            # the kernels line's K2s shape: this serve's median full-batch
            # decode step
            full = [ls for ls in step_lengths if min(ls) > 0] or step_lengths
            state_shape = {"lengths": sorted(full, key=sum)[len(full) // 2],
                           "pages_per_seq": loop.cm.blocks_per_seq,
                           "model": shape[1]}
        del engine, loop
    reset_counts()
    torch.cuda.empty_cache()
    out["phase_wall_s"] = time.perf_counter() - t_phase
    emit(out)
    check(not failed, "; ".join(failed))
    k2s_total = sum(s["launches"]["paged_attention_state"]
                    for s in out["serves"])
    k1_total = sum(s["launches"]["bp_matmul"] for s in out["serves"])
    check(k2s_total > 0 and k1_total > 0,
          f"serve_mesh launched K2s {k2s_total} and the sharded K1 "
          f"{k1_total} times")
    return out, {"bp_matmul_gemv": sum(s["launches"]["bp_matmul_gemv"]
                                       for s in out["serves"]),
                 "bp_matmul_tile": sum(s["launches"]["bp_matmul_tile"]
                                       for s in out["serves"]),
                 "paged_attention": 0,
                 "paged_attention_state": k2s_total,
                 "state_shape": state_shape}


def _lm_serve(torch, serve_lm, engine, workload, args):
    """One measured serve of serve_lm's workload through its own ``run``,
    after its warm-up: the launch counts are zeroed just before and read
    just after.  Returns the report, the step stream, the tokens by
    request and the serve's figures."""
    from repro_torch import serving
    serve_lm.warm_up(engine, workload, args)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    report, stream = serve_lm.run(engine, workload, args, warmup=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    no_fault_guard(report, stream, "serve_modes")
    step_ms = [1e3 * r["wall_s"] for r in stream if r["kind"] == "decode"]
    p = serving.percentiles(step_ms, qs=(50, 90))
    toks = {r.request_id: r.tokens.tolist() for r in report.results}
    fig = {"mode": args.mode, "cache_backend": args.cache_backend,
           "kv_cache_int8": engine.cfg.kv_cache_int8,
           "temperature": args.temperature, "wall_s": wall,
           "prefill_calls": sum(1 for r in stream if r["kind"] == "prefill"),
           "decode_steps": report.steps,
           "total_new_tokens": report.total_new_tokens,
           "decode_tokens_per_s": report.decode_tokens_per_s,
           "decode_step_ms_p50": p["p50"] if p else None,
           "decode_step_ms_p90": p["p90"] if p else None,
           "ttft_ms_p50": (1e3 * report.ttft_wall["p50"]
                           if report.ttft_wall else None),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
           "launches": launches,
           "finish_reasons": sorted({r.finish_reason
                                     for r in report.results})}
    return report, stream, toks, fig


def _generate_flips(torch, np, engine, workload, toks):
    """``generate()`` of every prompt in one static batch (serve_lm's
    prompts share one length) against the serve's streams, each cut to
    its request's length: each parting stream with its top-2 margin
    (``_flip``)."""
    gen = engine.generate({"tokens": workload.prompts},
                          max_new_tokens=int(workload.max_new.max()),
                          cache_T=workload.cache_T).tokens
    flips = []
    for i, prompt in enumerate(workload.prompts):
        g = gen[i][:int(workload.max_new[i])].tolist()
        if g != toks[i]:
            flips.append(_flip(torch, np, engine, prompt, toks[i], g,
                               workload.cache_T, i))
    return flips


def phase_serve_modes(torch, gpu, model, flush):
    """serve_lm's configurations at full width: its own functions
    (``parse_args``, ``build_engine``, ``make_workload``, ``warm_up``,
    ``run``) on ``build_model``'s qwen2-1.5b with serve_lm's workload (8
    requests on 4 slots, 32-token prompts, up to 24 new tokens, Poisson
    arrivals at 0.3 a step from ``default_rng(0)``, lead window 4).
    bp_approx on the slab store with an int8 KV cache, greedy: tokens equal
    ``generate()``'s but reported near-ties, K1 exactly as the step stream
    predicts per route, the positions that agree with a bp_exact serve of
    the same workload (a figure).  bf16 on the paged store with a bf16 KV
    cache (the float weights ``build_model`` quantized, drawn again from
    seed 0), greedy: tokens equal ``generate()``'s but near-ties, K1 never,
    K2 once per layer per decode step.  bp_exact on the slab store at
    temperature 0.8, twice: identical streams, every token in the padded
    vocabulary the logits span.  Also K1's approximate and exact GEMV
    chains of one layer at the decode rows, timed, and their share of a
    decode step."""
    import numpy as np
    import serve_lm     # examples_torch/serve_lm.py

    from repro_torch.models import api

    cfg, L = model["cfg"], model["cfg"].num_layers
    out = {"phase": "serve_modes", "gpu": gpu, "model": cfg.name,
           "layers": L, "d_model": cfg.d_model, "serves": {}}
    t_phase = time.perf_counter()

    def args_for(mode, backend, temperature):
        return serve_lm.parse_args(["--mode", mode, "--cache-backend",
                                    backend, "--temperature",
                                    str(temperature)])

    # -- bp_approx, slab, int8 KV, greedy; then bp_exact on the same
    args = args_for("bp_approx", "slab", 0.0)
    workload = serve_lm.make_workload(cfg, args)
    engine = serve_lm.build_engine(cfg, model["params"], args)
    check(engine.cfg.matmul_mode == "bp_approx"
          and engine.cfg.kv_cache_int8, "serve_modes: the bp_approx engine")
    _, stream, approx_toks, fig = _lm_serve(torch, serve_lm, engine,
                                            workload, args)
    routes, _ = matmul_routes(stream, 7 * L)
    fig["expected_launches_by_route"] = routes
    fig["generate_flips"] = _generate_flips(torch, np, engine, workload,
                                            approx_toks)
    reset_counts()
    exact_args = args_for("bp_exact", "slab", 0.0)
    exact = serve_lm.build_engine(cfg, model["params"], exact_args)
    exact_rep, _ = serve_lm.run(exact, workload, exact_args)
    exact_toks = {r.request_id: r.tokens.tolist()
                  for r in exact_rep.results}
    agree = total = 0
    for i, want in exact_toks.items():
        got = approx_toks[i]
        total += max(len(got), len(want))
        agree += sum(a == b for a, b in zip(got, want))
    fig["positions_agreeing_with_bp_exact"] = [agree, total]
    out["serves"]["bp_approx"] = fig
    del engine, exact
    # K1's share of a bp_approx decode step: one layer's seven GEMVs at
    # the decode rows, approximate and exact, times the layers, over the
    # step's p50
    gen = torch.Generator(device="cuda").manual_seed(3)
    chains = {}
    for name, approx in (("approx", True), ("exact", False)):
        ms, plain_ms, bound_ms, bound_by, err, _ = time_chain(
            torch, flush, gen, args.slots, QWEN_LAYER_KN, approx=approx)
        chains[name] = {"layer_ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        "max_abs_err": err}
    share = L * chains["approx"]["layer_ms"] / fig["decode_step_ms_p50"]
    out["k1_decode_gemv"] = {"m": args.slots, **chains,
                             "approx_share_of_decode_step_p50": share}
    emit({**out, "partial": "bp_approx"})
    la = fig["launches"]
    check(all(la[f"bp_matmul_{r}"] == n for r, n in routes.items())
          and la["bp_matmul"] == sum(routes.values())
          and la["paged_attention"] == 0,
          f"serve_modes bp_approx: K1 launched {la}, expected {routes}")
    bad = [f for f in fig["generate_flips"] if not f["near_tie"]]
    check(not bad, f"serve_modes bp_approx: generate() differs from serve() "
                   f"beyond a near-tie: {bad}")
    check(max(chains["approx"]["max_abs_err"],
              chains["exact"]["max_abs_err"]) == 0.0,
          f"serve_modes: K1's decode chain disagrees with its plain version "
          f"{chains}")

    # -- bf16, paged, bf16 KV, greedy: the float weights
    args = args_for("bf16", "paged", 0.0)
    with torch.no_grad():
        params = api.init(cfg.replace(matmul_mode="bf16"), seed=0,
                          device="cuda")
    engine = serve_lm.build_engine(cfg, params, args)
    check(engine.cfg.matmul_mode == "bf16" and not engine.cfg.kv_cache_int8,
          "serve_modes: the bf16 engine")
    rep, _, toks, fig = _lm_serve(torch, serve_lm, engine, workload, args)
    fig["expected_paged_attention"] = L * rep.steps
    fig["generate_flips"] = _generate_flips(torch, np, engine, workload,
                                            toks)
    out["serves"]["bf16"] = fig
    del engine, params
    torch.cuda.empty_cache()
    lb = fig["launches"]
    check(lb["bp_matmul"] == 0, f"serve_modes bf16: K1 launched {lb}")
    check(lb["paged_attention"] == L * rep.steps,
          f"serve_modes bf16: K2 launched {lb['paged_attention']} times, "
          f"expected {L} x {rep.steps} decode steps")
    bad = [f for f in fig["generate_flips"] if not f["near_tie"]]
    check(not bad, f"serve_modes bf16: generate() differs from serve() "
                   f"beyond a near-tie: {bad}")

    # -- bp_exact, slab, temperature 0.8, twice with the same seeds
    args = args_for("bp_exact", "slab", 0.8)
    engine = serve_lm.build_engine(cfg, model["params"], args)
    _, _, toks, fig = _lm_serve(torch, serve_lm, engine, workload, args)
    again, _ = serve_lm.run(engine, workload, args, warmup=False)
    toks_again = {r.request_id: r.tokens.tolist() for r in again.results}
    flat = [t for ts in toks.values() for t in ts]
    fig["identical_streams"] = toks == toks_again
    fig["tokens_past_vocab_size"] = sum(t >= cfg.vocab_size for t in flat)
    out["serves"]["bp_exact_sampled"] = fig
    del engine
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    check(fig["identical_streams"], "serve_modes: two sampled serves with "
                                    "the same seeds differ")
    check(all(0 <= t < cfg.vocab_padded for t in flat),
          "serve_modes: a sampled token lies outside the vocabulary")
    totals = {k: sum(f["launches"][k] for f in out["serves"].values())
              for k in out["serves"]["bf16"]["launches"]}
    return out, totals


def _example(torch, name, argv):
    """``examples_torch/<name>.py``'s ``main(argv)`` on the card, its
    printout captured: (what main returned, the run's record).  A raise or
    an exit fails the phase."""
    import contextlib
    import importlib
    import io
    mod = importlib.import_module(name)
    buf = io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            ret = mod.main(argv)
        torch.cuda.synchronize()
    except (Exception, SystemExit) as e:
        raise CheckFailed(f"examples: {name} {argv} failed: "
                          f"{type(e).__name__}: {e}\n"
                          f"{buf.getvalue()[-2000:]}") from e
    text = buf.getvalue()
    return ret, {"argv": argv, "wall_s": time.perf_counter() - t0,
                 "launches": launch_counts(),
                 "last_lines": text.splitlines()[-4:], "text": text}


def phase_examples(torch, gpu):
    """Each ``examples_torch`` script's ``main`` on the card at its small
    defaults: serve_lm in bp_approx with the probe every 2 steps writing
    its JSONL under build/, estimate_deployment ``--measured`` on that
    file, quickstart, train_lm for 6 steps with compressed gradients in a
    temporary directory under build/ and then resumed to step 8, and the
    front door with one replica and its drive."""
    import math
    import shutil
    import tempfile

    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    out = {"phase": "examples", "gpu": gpu, "runs": {}}
    t_phase = time.perf_counter()
    runs = out["runs"]
    jsonl = build / "examples_serve_lm.jsonl"
    jsonl.unlink(missing_ok=True)
    report, runs["serve_lm"] = _example(
        torch, "serve_lm", ["--mode", "bp_approx", "--probe", "2",
                            "--metrics", str(jsonl)])
    runs["serve_lm"]["hw_estimate_records"] = sum(
        '"hw_estimate"' in line for line in jsonl.read_text().splitlines())
    runs["serve_lm"]["finish_reasons"] = sorted(
        {r.finish_reason for r in report.results})
    rc, runs["estimate_deployment"] = _example(
        torch, "estimate_deployment", ["--measured", str(jsonl)])
    runs["estimate_deployment"]["rc"] = rc
    quick, runs["quickstart"] = _example(torch, "quickstart", [])
    runs["quickstart"]["kernel_equal"] = quick["kernel_equal"]
    ckpt = tempfile.mkdtemp(prefix="train_lm_", dir=build)
    try:
        common = ["--compress-grads", "--ckpt-dir", ckpt]
        (end, hist), runs["train_lm"] = _example(
            torch, "train_lm", ["--steps", "6", "--fresh", *common])
        (end2, hist2), runs["train_lm_resume"] = _example(
            torch, "train_lm", ["--steps", "8", *common])
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    runs["train_lm"]["losses"] = [l for _, l in hist]
    runs["train_lm_resume"]["losses"] = [l for _, l in hist2]
    (seen, reports), runs["frontdoor_server"] = _example(
        torch, "frontdoor_server", ["--replicas", "1"])
    runs["frontdoor_server"]["stream_finish"] = [
        s["finish_reason"] for s in seen["streams"]]
    runs["frontdoor_server"]["disconnected_tokens"] = len(
        seen["disconnected"]["tokens"])
    runs["frontdoor_server"]["cancelled"] = reports["r0"].n_cancelled
    texts = {k: r.pop("text") for k, r in runs.items()}
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    ls, lq = runs["serve_lm"]["launches"], runs["quickstart"]["launches"]
    check(runs["serve_lm"]["finish_reasons"] == ["length"]
          and runs["serve_lm"]["hw_estimate_records"] > 0
          and report.hw_measured is not None and ls["bp_matmul"] > 0,
          f"examples: serve_lm {runs['serve_lm']}")
    check(rc == 0 and "measured-traffic deployment estimate" in
          texts["estimate_deployment"],
          f"examples: estimate_deployment --measured returned {rc}")
    check(quick["kernel_equal"] and lq["bp_matmul"] == 1,
          f"examples: quickstart's kernel {quick['kernel_equal']}, "
          f"launches {lq}")
    check(end == 6 and end2 == 8 and [s for s, _ in hist2] == [7, 8]
          and "resumed from checkpoint at step 6" in texts["train_lm_resume"]
          and all(math.isfinite(l) for _, l in hist + hist2),
          f"examples: train_lm ended at {end}, {end2}: {hist} {hist2}")
    fd = runs["frontdoor_server"]
    check(fd["stream_finish"] == ["length"] * 3
          and fd["disconnected_tokens"] == 2 and fd["cancelled"] == 1
          and fd["launches"]["paged_attention"] > 0,
          f"examples: frontdoor_server {fd}")
    totals = {k: sum(r["launches"][k] for r in runs.values())
              for k in runs["quickstart"]["launches"]}
    return out, totals


def state_layer_summary(torch, flush, shape, launches):
    """The kernels line's numbers for K2s: one decoder layer's call on one
    shard of ``serve_mesh``'s (1, 2) paged serve at its median full-batch
    decode step (its slots and positions, half its table per shard), timed
    on shard 0 (the nearer half of every table) and on the far shard beside
    the plain version, the library yardstick (SDPA on the shard's K/V
    gathered dense) and the bound (the shard's valid K/V rows, q, the
    float32 state written once); and the whole split call (both shards and
    the merge)."""
    from repro_torch.kernels.paged_attention import ops as pa_ops
    gen = torch.Generator(device="cuda").manual_seed(6)
    H, KH, D, bs = (QWEN_ATTN[k] for k in ("H", "KH", "D", "bs"))
    lengths, P, model = shape["lengths"], shape["pages_per_seq"], \
        shape["model"]
    p_l, B = P // model, len(lengths)
    q, kp, vp, tables, lens = paged_case(torch, gen, B, H, KH, D, B * P + 1,
                                         bs, P, lengths, torch.bfloat16)

    def shard(s):
        return (q, kp, vp, tables[:, s * p_l:(s + 1) * p_l].contiguous(),
                lens - s * p_l * bs)

    near, far = shard(0), shard(model - 1)
    got = pa_ops.paged_attention_state(*near, backend="kernel")
    want = pa_ops.paged_attention_state(*near, backend="plain")
    r_got, r_want, _, _ = _state_err(torch, got, want)
    ms = time_ms(torch, lambda: pa_ops.paged_attention_state(
        *near, backend="kernel"), flush)
    far_ms = time_ms(torch, lambda: pa_ops.paged_attention_state(
        *far, backend="kernel"), flush)
    plain_ms = time_ms(torch, lambda: pa_ops.paged_attention_state(
        *near, backend="plain"), flush, iters=10)
    library_ms = time_ms(torch, _sdpa_on_gathered(torch, *near), flush)
    mesh = cuda_mesh(torch, 1, model)
    split_ms = time_ms(torch, lambda: pa_ops.paged_attention(
        q, kp, vp, tables, lens, backend="kernel", mesh=mesh), flush)
    bound_ms, bound_by = attention_bound(lengths, H, KH, D, bs, p_l,
                                         state=True)
    far_lengths = [int(n) - p_l * bs for n in lengths]
    return {"name": "paged_attention_state", "route": "cuda",
            "source": KERNEL_SOURCES["paged_attention"],
            "replaces": "src/repro/kernels/paged_attention/kernel.py:96 "
                        "(return_state=True, epilogue _done at :82)",
            "launches": launches["paged_attention_state"],
            "max_abs_err": (r_got - r_want).abs().max().item(),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "far_shard_ms": far_ms,
            "far_shard_bound_ms": attention_bound(
                far_lengths, H, KH, D, bs, p_l, state=True)[0],
            "split_call_ms": split_ms,
            "shape": f"one decoder layer, shard 0 of {model} of the "
                     f"serve_mesh (1, {model}) paged serve's median decode "
                     f"step: B={B}, H 12, KH 2, D 128, block 16, {p_l} of "
                     f"{P} pages per table, positions {list(lengths)}, "
                     f"bf16 in, float32 state out; max_abs_err on acc / l; "
                     f"library: SDPA (enable_gqa) on the shard's K/V "
                     f"gathered dense beforehand; split_call_ms: both "
                     f"shards and the merge"}


#: rwkv6-7b's layers in ``serve_rwkv``: 12 of its 32, for the script's
#: 1200 s limit on a host ~1.5 times slower than the usual one (the width
#: is the model's)
RWKV_SERVE_LAYERS = 12


def build_rwkv(torch):
    """Full-width rwkv6-7b in bp_exact, cut to ``RWKV_SERVE_LAYERS``
    layers: random weights from seed 0, every dense weight quantized to
    int8 once.  Peak device memory of the initialisation and quantization
    is measured on its own."""
    from repro_torch.configs.base import get_arch
    from repro_torch.models import api
    from repro_torch.models.layers import quantize_dense_params

    cfg = get_arch("rwkv6-7b").replace(matmul_mode="bp_exact",
                                       num_layers=RWKV_SERVE_LAYERS)
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


def recurrent_noise_floor(torch, cfg, params, prompts, chunk=64):
    """How far two exact evaluations of one prefill of a recurrent model
    (rwkv6-7b, zamba2-2.7b) lie apart: for every prompt whose length is a
    multiple of the chunk, the largest logit difference between the plain
    versions' prefill of the whole prompt (the chunked form) and a prefill
    of all but its last token (the step recurrence) followed by a decode
    step of it: the same function, its float32 sums in another order.
    Beside it, the kernels' chunked prefill against the plain version's.
    ``tests/test_torch_rwkv_depth.py`` measures the same gap in the JAX
    reference; ``tests/test_torch_hybrid.py`` finds the reference and the
    port apart by up to 0.074 at zamba's 12 reduced layers."""
    from repro_torch.models import api
    plain = cfg.replace(matmul_backend="plain")
    rows = []
    for i, r in enumerate(prompts):
        S = r.prompt_len
        if S % chunk:
            continue
        tokens = torch.as_tensor(
            r.prompt[None], device=params["embed"]["table"].device).long()
        with torch.no_grad():
            lp = api.prefill(params, plain, {"tokens": tokens},
                             S + 1)[0][0].float()
            _, state = api.prefill(params, plain, {"tokens": tokens[:, :-1]},
                                   S + 1)
            ls = api.decode_step(params, plain, {
                "tokens": tokens[:, -1:], "cache": state,
                "cache_len": S - 1})[0][0].float()
            lk = api.prefill(params, cfg, {"tokens": tokens},
                             S + 1)[0][0].float()
        rows.append({"request": i, "prompt_len": S,
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
    # carries a float32 rounding difference through its layers of bf16
    # rounding and int8 activation quantization into logit differences of
    # tenths (two plain evaluations included; the reference amplifies as
    # much, tests/test_torch_rwkv_depth.py), so a stream may flip where
    # two logits lie within that floor; such a flip is a near-tie here
    noise = recurrent_noise_floor(torch, cfg, params, prompts, chunk)
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


def build_full(torch, name, layers=None):
    """Full-width model in bp_exact, full-depth unless ``layers`` cuts it:
    random weights from seed 0 (an MoE's expert stacks drawn a layer at a
    time straight into bf16), every dense weight (attention, router, SSM
    projections, lm head) quantized to int8 once.  Peak device memory of
    the initialisation and quantization is measured on its own."""
    from repro_torch.configs.base import get_arch
    from repro_torch.models import api
    from repro_torch.models.layers import quantize_dense_params

    cfg = get_arch(name).replace(matmul_mode="bp_exact")
    if layers is not None:
        cfg = cfg.replace(num_layers=layers)
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
            "weight_bytes": weight_bytes_by_kind(torch, params)}


def weight_bytes_by_kind(torch, params):
    """Device bytes of the weights by kind: the bf16 expert stacks, the
    int8 dense weights (attention, router, lm head), the embedding table,
    and the rest (their float32 scales, norms)."""
    out = {"experts_bf16": 0, "int8_dense": 0, "embedding": 0, "other": 0}

    def rec(node, top):
        for key, v in node.items():
            if isinstance(v, dict):
                rec(v, top or key)
                continue
            nbytes = v.numel() * v.element_size()
            kind = ("experts_bf16" if key.startswith("experts_") else
                    "int8_dense" if v.dtype == torch.int8 else
                    "embedding" if (top or key) == "embed" else "other")
            out[kind] += nbytes
    rec(params, None)
    out["total"] = sum(out.values())
    return out


class RouterTap:
    """While installed, records every MoE layer's routing, in call order
    (one entry per layer of each forward): its top-k expert ids (G, Tg, K)
    and the gap between the k-th and (k+1)-th router logit (the gap of
    their log-probabilities), the margin by which a pick won."""

    def __init__(self, torch):
        self.torch = torch
        self.calls = []

    def __enter__(self):
        from repro_torch.models import moe
        self._moe, self._route = moe, moe.route
        torch = self.torch

        def route(params, xg, cfg, probe=None):
            probs, top_p, top_e = self._route(params, xg, cfg, probe)
            v = torch.topk(probs, cfg.top_k + 1, dim=-1).values
            self.calls.append((top_e, v[..., -2].log() - v[..., -1].log()))
            return probs, top_p, top_e

        moe.route = route
        return self

    def __exit__(self, *exc):
        self._moe.route = self._route


def router_tie_rerun(torch, np, engine, plain_cfg, requests, plain_toks,
                     **serve_kw):
    """The kernel serve again, each paged decode step run twice from the
    same state: as the serve runs it, then on a copy of the cache with the
    plain versions (of which only K2's result differs: K1 equals its plain
    version bit for bit).  Per active slot and step it records the request,
    the position the step writes, the layers whose expert picks differ
    between the two runs (with both top-k margins there), and, where the
    plain serve's stream (``plain_toks``) has another token at that
    position, the step's logits of both tokens against the bf16 unit at
    the top logit.  Returns (tokens of this serve, records)."""
    from repro_torch.models import causal_lm
    orig = causal_lm.decode_step_paged
    rows, state = [], {}

    def step(params, cfg, batch, probe=None):
        copy = {k: v.clone() for k, v in batch["cache"].items()}
        with RouterTap(torch) as kern:
            logits, cache = orig(params, cfg, batch, probe=probe)
        with RouterTap(torch) as plain:
            plain_logits, _ = orig(params, plain_cfg, dict(batch, cache=copy))
        del copy
        B = logits.shape[0]
        picks = [(torch.sort(ek.reshape(B, -1), -1).values,
                  torch.sort(ep.reshape(B, -1), -1).values,
                  gk.reshape(B), gp.reshape(B))
                 for (ek, gk), (ep, gp) in zip(kern.calls, plain.calls)]
        for slot, req in state["loop"].active.items():
            pos = len(req.tokens)
            flips = [{"layer": l, "kernel_margin": float(gk[slot]),
                      "plain_margin": float(gp[slot]),
                      "kernel_picks": ek[slot].tolist(),
                      "plain_picks": ep[slot].tolist()}
                     for l, (ek, ep, gk, gp) in enumerate(picks)
                     if not torch.equal(ek[slot], ep[slot])]
            want = plain_toks.get(req.request_id, [])
            lg = logits[slot].float()
            tok = int(torch.argmax(lg))
            other = want[pos] if pos < len(want) else tok
            if not flips and other == tok:
                continue
            top = lg[tok].item()
            ulp = 2.0 ** (int(np.floor(np.log2(abs(top) + 1e-30))) - 7)
            rows.append({"request": req.request_id, "position": pos,
                         "router_flips": flips, "kernel_token": tok,
                         "plain_serve_token": other,
                         "plain_step_token": int(torch.argmax(
                             plain_logits[slot].float())),
                         "logit_gap": top - lg[other].item(),
                         "bf16_ulp": ulp})
        return logits, cache

    causal_lm.decode_step_paged = step
    try:
        loop = engine.make_loop(requests, **serve_kw)
        state["loop"] = loop
        report = loop.run()
    finally:
        causal_lm.decode_step_paged = orig
    return {r.request_id: r.tokens.tolist() for r in report.results}, rows


def explain_parts(got, want, rows, names=("kernel", "plain")):
    """Every request whose two streams part, with why: a near-tie of the
    final logits (the two tokens within 4 bf16 units at the step where they
    part) or of a router top-k (a layer's picks changed when the step was
    re-run from the same state with the plain K2, at or before the part).
    A part that is neither is not a near-tie."""
    parts = []
    for rid in sorted(got):
        g, w = got[rid], want[rid]
        if g == w:
            continue
        j = next((k for k in range(min(len(g), len(w))) if g[k] != w[k]),
                 None)
        a, b = names
        part = {"request": rid, "position": j}
        if j is not None:
            part.update({f"{a}_token": g[j], f"{b}_token": w[j]})
        mine = [r for r in rows if r["request"] == rid
                and j is not None and r["position"] <= j]
        router = [dict(r["router_flips"][0], position=r["position"],
                       n_layers=len(r["router_flips"]))
                  for r in mine if r["router_flips"]]
        at = [r for r in mine if r["position"] == j
              and r["plain_serve_token"] != r["kernel_token"]]
        part["router_near_tie"] = router[0] if router else None
        if at:
            part["logit_gap"] = at[0]["logit_gap"]
            part["bf16_ulp"] = at[0]["bf16_ulp"]
        part["logit_near_tie"] = bool(
            at and at[0]["logit_gap"] <= 4 * at[0]["bf16_ulp"])
        part["near_tie"] = bool(router) or part["logit_near_tie"]
        parts.append(part)
    return parts


def phase_serve_moe_model(torch, gpu, model, paged, n_requests, num_blocks,
                          seed, n_slots=4, lead_window=4, block_size=16):
    """One MoE model on the paged main path (bp_exact, bf16 KV): K1 on
    every attention projection, router and lm head, K2 on every decode
    step, the bf16 experts a batched product per weight.  Beside it the
    same engine on the plain versions, the slab store with an int8 KV
    cache (which bypasses K2) against its plain version, ``generate()``,
    and a profiled two-request serve."""
    import numpy as np

    from repro_torch import serving
    from repro_torch.models import causal_lm

    cfg = model["cfg"]
    params = model["params"]
    L = cfg.num_layers
    plain_cfg = cfg.replace(matmul_backend="plain")

    def engine_for(c, backend="paged"):
        return serving.ServingEngine(
            c, params, serving.ServeConfig(max_new_tokens=32,
                                           temperature=0.0,
                                           cache_backend=backend,
                                           block_size=block_size),
            device="cuda")

    engine = engine_for(cfg)
    sched = serving.SchedulerConfig(lead_window=lead_window)
    prompts = _paged_requests(serving, np.random.default_rng(seed),
                              cfg.vocab_size, n_requests)
    cache_T = max(r.prompt_len + r.max_new_tokens for r in prompts) + 8
    kw = dict(n_slots=n_slots, cache_T=cache_T, sched_cfg=sched)
    pkw = dict(kw, num_blocks=num_blocks)
    t0 = time.perf_counter()
    # warm-up serve (allocator): not measured
    guarded_serve(engine, _copies(serving, prompts[:2]), **pkw)
    torch.cuda.synchronize()

    # -- the measured main-path run: counts zeroed just before, read after
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    loop = engine.make_loop(_copies(serving, prompts), **pkw)
    step_lengths = []
    loop.on_step_end = lambda lp: step_lengths.append(
        lp.cm.cache_len_vector().tolist())
    report = loop.run()
    no_fault_guard(report, loop.stream, f"serve_moe {cfg.name}")
    torch.cuda.synchronize()
    launches = launch_counts()
    peak_mem_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    n_prefill = sum(1 for r in loop.stream if r["kind"] == "prefill")
    step_ms = [1e3 * r["wall_s"] for r in loop.stream
               if r["kind"] == "decode"]
    toks = {r.request_id: r.tokens.tolist() for r in report.results}
    # per forward: q, k, v, o and the router in every layer, and the lm
    # head once
    routes, prefill_m = matmul_routes(loop.stream, 5 * L, head=1)
    expected = {"bp_matmul": (5 * L + 1) * (n_prefill + report.steps),
                "bp_matmul_gemv": routes["gemv"],
                "bp_matmul_tile": routes["tile"],
                "paged_attention": L * report.steps, "wkv6": 0}
    marks = {"measured_serve": time.perf_counter()}

    # -- the same engine config and batching on the plain versions
    reset_counts()
    rep_plain = guarded_serve(engine_for(plain_cfg),
                              _copies(serving, prompts), **pkw)
    plain_launches = launch_counts()
    reset_counts()
    plain_toks = {r.request_id: r.tokens.tolist() for r in rep_plain.results}
    rows = []
    if plain_toks != toks:
        rerun_toks, rows = router_tie_rerun(
            torch, np, engine, plain_cfg, _copies(serving, prompts),
            plain_toks, **pkw)
        check(rerun_toks == toks, f"{cfg.name}: the kernel serve is not "
                                  f"deterministic")
    parts = explain_parts(toks, plain_toks, rows)
    marks["plain_serve"] = time.perf_counter()

    # -- the slab store with an int8 KV cache bypasses K2: every operation
    # is the plain serve's, so the tokens must be equal, not near
    slab_cfg = cfg.replace(kv_cache_int8=True)
    reset_counts()
    slab_loop = engine_for(slab_cfg, "slab").make_loop(
        _copies(serving, prompts), **kw)
    rep_slab = slab_loop.run()
    no_fault_guard(rep_slab, slab_loop.stream, f"serve_moe {cfg.name} slab")
    slab_launches = launch_counts()
    slab_routes, _ = matmul_routes(slab_loop.stream, 5 * L, head=1)
    n_slab_prefill = sum(1 for r in slab_loop.stream
                         if r["kind"] == "prefill")
    slab_expected = {"bp_matmul": (5 * L + 1) * (n_slab_prefill
                                                  + rep_slab.steps),
                     "bp_matmul_gemv": slab_routes["gemv"],
                     "bp_matmul_tile": slab_routes["tile"],
                     "paged_attention": 0, "wkv6": 0}
    reset_counts()
    rep_slab_plain = guarded_serve(engine_for(slab_cfg.replace(
        matmul_backend="plain"), "slab"), _copies(serving, prompts), **kw)
    slab_plain_launches = launch_counts()
    reset_counts()
    slab_toks = {r.request_id: r.tokens.tolist() for r in rep_slab.results}
    slab_plain_toks = {r.request_id: r.tokens.tolist()
                       for r in rep_slab_plain.results}
    marks["slab_serves"] = time.perf_counter()

    # -- generate(), one request at a time, its first 8 tokens: its groups
    # hold other tokens than the serve's batches, so capacity drops (and so
    # streams) may differ; reported, not held
    gen_parts = []
    for i, r in enumerate(prompts):
        g = engine.generate({"tokens": r.prompt[None]},
                            max_new_tokens=min(r.max_new_tokens, 8),
                            cache_T=cache_T).tokens[0].tolist()
        j = next((k for k in range(len(g)) if g[k] != toks[i][k]), None)
        if j is not None:
            gen_parts.append({"request": i, "position": j,
                              "positions_apart": sum(
                                  a != b for a, b in zip(g, toks[i]))})
    reset_counts()
    marks["generate"] = time.perf_counter()

    # -- a profiled two-request serve (4 new tokens each: the profiler's
    # post-processing grows with the kernels); the decode steps are
    # annotated, so their device time stands apart from the prefills'
    profile = _profile_serve(
        torch, engine, [serving.Request(prompt=r.prompt.copy(),
                                        max_new_tokens=4,
                                        arrival_time=r.arrival_time)
                        for r in prompts[:2]], n_slots, cache_T, sched,
        annotate=((causal_lm, "decode_step_paged"),),
        num_blocks=num_blocks)
    reset_counts()
    marks["profile"] = time.perf_counter()

    wb = model["weight_bytes"]
    dec = profile["annotated"].get("decode_step_paged", {})
    per_step_dev = (dec["device_ms"] / dec["count"]
                    if dec.get("count") else None)
    bound_ms = wb["experts_bf16"] / HBM_BYTES_PER_S * 1e3
    p = serving.percentiles(step_ms, qs=(50, 90))
    ttft = [r.ttft_wall_s for r in report.results]
    result = {
        "model": cfg.name, "layers": L, "d_model": cfg.d_model,
        "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
        "head_dim": cfg.resolved_head_dim, "experts": cfg.num_experts,
        "top_k": cfg.top_k, "expert_d_ff": cfg.d_ff,
        "vocab": cfg.vocab_size, "mode": cfg.matmul_mode,
        "kv_cache_int8": False, "cache_backend": "paged",
        "block_size": block_size, "num_blocks": num_blocks,
        "n_requests": n_requests, "n_slots": n_slots, "cache_T": cache_T,
        "init_and_quantize_s": model["init_and_quantize_s"],
        "init_and_quantize_peak_mem_gb":
            model["init_and_quantize_peak_mem_gb"],
        "weight_bytes": wb,
        "prefill_calls": n_prefill,
        "prefill_groups": [[r["group_size"], r["pad_to"]]
                           for r in loop.stream if r["kind"] == "prefill"],
        "decode_steps": report.steps,
        "total_new_tokens": report.total_new_tokens,
        "launches": launches, "expected_launches": expected,
        "plain_backend_launches": plain_launches,
        "n_preemptions": report.n_preemptions,
        "prefix_hit_blocks": report.prefix_hit_blocks,
        "peak_blocks_in_use": report.peak_blocks_in_use,
        "tokens_equal_plain_backend": not parts,
        "plain_parts": parts,
        "router_rerun_records": rows[:20],
        "slab_int8kv_launches": slab_launches,
        "slab_int8kv_expected_launches": slab_expected,
        "slab_plain_launches": slab_plain_launches,
        "slab_int8kv_tokens_equal_plain": slab_toks == slab_plain_toks,
        "generate_parts": gen_parts,
        "generate_positions_apart": sum(g["positions_apart"]
                                        for g in gen_parts),
        "decode_tokens_per_s": report.decode_tokens_per_s,
        "step_wall_tokens_per_s": step_wall_rate(loop.stream),
        "decode_step_ms_p50": p["p50"] if p else None,
        "decode_step_ms_p90": p["p90"] if p else None,
        "ttft_wall_s_by_request": ttft,
        "prefill_s": report.prefill_s, "decode_s": report.decode_s,
        "serve_paged_beside": {
            k: paged.get(k) for k in ("model", "decode_tokens_per_s",
                                      "decode_step_ms_p50",
                                      "decode_step_ms_p90",
                                      "ttft_wall_s_by_request")},
        "peak_mem_gb": peak_mem_gb,
        "decode_step_device_ms": per_step_dev,
        "decode_step_expert_bound_ms": bound_ms,
        "first_tokens": toks[0][:8],
        "profile": profile,
        "wall_s": _spans(marks, t0),
    }
    emit({"phase": "serve_moe", "gpu": gpu, **result})
    check(all(r.finish_reason == "length" for r in report.results),
          f"a {cfg.name} request finished for another reason than length")
    check(all(0 <= t < cfg.vocab_padded for ts in toks.values() for t in ts),
          "a generated token lies outside the padded vocabulary")
    for name, want in expected.items():
        check(launches[name] == want,
              f"{name} launched {launches[name]} times on the {cfg.name} "
              f"paged path, expected {want}")
    for name, want in slab_expected.items():
        check(slab_launches[name] == want,
              f"{name} launched {slab_launches[name]} times on the "
              f"{cfg.name} slab path, expected {want}")
    check(launches["routed_plain_int8_kv"] == 0,
          "paged attention was routed to the plain version")
    for what, pl in (("paged", plain_launches), ("slab", slab_plain_launches)):
        check(not any(pl.values()),
              f"the plain backend launched a kernel ({what}): {pl}")
    check(report.prefix_hit_blocks > 0, f"{cfg.name}: no prefix-sharing hit")
    check(report.n_preemptions >= 1, f"{cfg.name}: the pool of {num_blocks} "
                                     f"blocks never ran dry")
    check(slab_toks == slab_plain_toks,
          f"{cfg.name}: the int8-KV slab serve differs from its plain "
          f"version")
    bad = [q for q in parts if not q["near_tie"]]
    check(not bad, f"{cfg.name}: kernel and plain serves part beyond a "
                   f"near-tie: {bad}")
    full = [ls for ls in step_lengths if min(ls) > 0] or step_lengths
    shape = sorted(full, key=sum)[len(full) // 2]
    return result, {**launches, "prefill_rows": prefill_m}, {
        "lengths": shape, "pages_per_seq": loop.cm.blocks_per_seq,
        "dims": attention_dims(cfg)}


def phase_serve_moe(torch, gpu, paged):
    """The MoE family, after the rwkv weights are freed: full-width
    moonshot-v1-16b-a3b (cut to ``MOE_SERVES``' depth) on ``serve_paged``'s
    workload and pool size, then a four-request full-width
    granite-moe-1b-a400m serve (K2's
    head-dim-64 walk on a served path), each model built, served and freed
    in turn.  Returns ({model: record}, {model: launches}, {model: decode
    shape})."""
    import gc
    records, launches, shapes = {}, {}, {}
    for name, spec in MOE_SERVES.items():
        model = build_full(torch, name, spec.get("layers"))
        try:
            records[name], launches[name], shapes[name] = \
                phase_serve_moe_model(torch, gpu, model, paged,
                                      spec["n_requests"], spec["num_blocks"],
                                      spec["seed"])
        finally:
            del model
            gc.collect()
            torch.cuda.empty_cache()
    return records, launches, shapes


# ---------------------------------------------------------------------------
# the last three model families: vision-language, hybrid, encoder-decoder
# ---------------------------------------------------------------------------

#: Qwen2-VL's image placeholder token: the positions a vision span covers
IMAGE_PAD_TOKEN = 151655


def _grow_extra(np, extra, length):
    """A request's extras as a batch of one for a prefill of its prompt
    plus generated tokens: the per-position vision arrays continue as text
    (zero embeddings, mask off), M-RoPE ``positions`` (3, S) continue as a
    decode step places them (at the token's index, on all three rows), a
    source stays as it is."""
    out = {}
    for k, v in (extra or {}).items():
        v = np.asarray(v)
        if k == "positions":
            grow = np.arange(v.shape[1], length)
            out[k] = np.concatenate(
                [v, np.broadcast_to(grow, (3, grow.size))], axis=1)[:, None]
            continue
        if k in ("vision_embeds", "vision_mask") and v.shape[0] < length:
            v = np.concatenate([v, np.zeros((length - v.shape[0],)
                                            + v.shape[1:], v.dtype)])
        out[k] = v[None]
    return out


def _vlm_workload(serving, np, vocab, d, n=8, system_len=128):
    """qwen2-vl-7b requests: six with a leading vision span of 64-256
    positions (image-pad tokens, bf16-scale patch embeddings from a seed),
    requests 0 and 1 with equal tokens and different images; two text-only
    requests (6, 7) sharing a ``system_len``-token system prompt.  Prompt
    lengths are distinct between the vision and the text requests, so no
    admission group mixes requests with and without extras."""
    rng = np.random.default_rng(8)
    spans = (128, 128, 64, 192, 256, 96)
    texts = (48, 48, 40, 24, 16, 60)
    prompts, extras = [], {}
    for i, (span, own) in enumerate(zip(spans, texts)):
        if i == 1:
            toks = prompts[0].copy()
        else:
            toks = np.concatenate([np.full(span, IMAGE_PAD_TOKEN),
                                   rng.integers(2, vocab, own)]).astype(
                                       np.int32)
        mask = np.zeros(len(toks), bool)
        mask[:span] = True
        emb = (rng.standard_normal((len(toks), d)) * d ** -0.5).astype(
            np.float32)
        emb[~mask] = 0.0
        prompts.append(toks)
        extras[i] = {"vision_embeds": emb, "vision_mask": mask}
    system = rng.integers(2, vocab, system_len)
    for own in (20, 36):
        prompts.append(np.concatenate([system, rng.integers(2, vocab, own)])
                       .astype(np.int32))
    reqs = [serving.Request(prompt=p, max_new_tokens=int(rng.integers(8, 33)),
                            arrival_time=float(2 * i), request_id=i)
            for i, p in enumerate(prompts[:n])]
    return reqs, extras


def _mrope_positions(np, span, length, grid_w=16):
    """Qwen2-VL's (t, h, w) rows for one image of ``span`` patches on a
    ``grid_w``-wide grid followed by text: the image at t 0 on its grid,
    the text counting on from the grid's largest index on all three
    rows."""
    pos = np.zeros((3, length), np.int64)
    idx = np.arange(span)
    pos[1, :span] = idx // grid_w
    pos[2, :span] = idx % grid_w
    start = int(pos[:, :span].max()) + 1
    pos[:, span:] = start + np.arange(length - span)
    return pos


def _hybrid_workload(serving, np, vocab, n=8):
    """zamba2-2.7b requests: prompts of 64, 128, 192 or 256 tokens (the
    chunked SSD), except requests 3 and 6, of 100 and 77 (the step
    recurrence)."""
    rng = np.random.default_rng(9)
    reqs = []
    for i in range(n):
        plen = {3: 100, 6: 77}.get(i, int(rng.choice((64, 128, 192, 256))))
        reqs.append(serving.Request(
            prompt=rng.integers(2, vocab, plen).astype(np.int32),
            max_new_tokens=int(rng.integers(8, 33)),
            arrival_time=float(2 * i), request_id=i))
    return reqs, {}


#: seamless-m4t-medium: source frames per request (one shorter than the
#: pool's 128 cross positions) and decoder prompt lengths (request 5's of
#: its own: a group stacks its sources)
AUDIO_FRAMES = (128, 128, 128, 128, 128, 80, 128, 128)
AUDIO_PROMPTS = (8, 12, 8, 16, 12, 5, 16, 8)


def _audio_workload(serving, np, vocab, d):
    rng = np.random.default_rng(10)
    reqs, extras = [], {}
    for i, (frames, plen) in enumerate(zip(AUDIO_FRAMES, AUDIO_PROMPTS)):
        reqs.append(serving.Request(
            prompt=rng.integers(2, vocab, plen).astype(np.int32),
            max_new_tokens=int(rng.integers(8, 33)),
            arrival_time=float(2 * i), request_id=i))
        extras[i] = {"src_embeds": (rng.standard_normal((frames, d))
                                    * d ** -0.5).astype(np.float32)}
    return reqs, extras


def _forward_routes(cfg, stream):
    """K1's launches per route that a serve's step stream predicts, for
    the three families (every call at M > 8 rows takes the tiles, else the
    GEMV): qwen2-vl 7 per layer at the prefill's rows; zamba 2 per Mamba
    layer and 6 per shared block (q, k, v, o, FFN up, down); seamless 6
    per encoder layer and 2 per decoder layer's cross K/V at the source's
    rows (group x frames, always above 8), 8 per decoder layer at the
    prompt's; each lm head once on the last positions (the GEMV while the
    group is at most 8 rows); a decode step all of them at one row per
    slot."""
    from repro_torch.kernels.bitparticle_matmul.ops import GEMV_MAX_M
    L = cfg.num_layers
    if cfg.family == "vlm":
        src_calls, per_tok = 0, 7 * L
    elif cfg.family == "hybrid":
        src_calls, per_tok = 0, 2 * L + 6 * (L // cfg.attn_every)
    else:
        src_calls, per_tok = 6 * cfg.encoder_layers + 2 * L, 8 * L
    want, rows = {"gemv": 0, "tile": 0}, []
    for r in stream:
        if r["kind"] == "prefill":
            m = r["group_size"] * r["pad_to"]
            # the tiles' most frequent rows: the source's for seamless
            # (group x its usual 128 frames), the prompt's otherwise
            rows.append(r["group_size"] * max(AUDIO_FRAMES) if src_calls
                        else m)
            want["tile"] += src_calls
            want["tile" if m > GEMV_MAX_M else "gemv"] += per_tok
            want["tile" if r["group_size"] > GEMV_MAX_M else "gemv"] += 1
        elif r["kind"] == "decode":
            want["gemv"] += per_tok + 1
    n = sum(r["kind"] in ("prefill", "decode") for r in stream)
    n_pre = sum(r["kind"] == "prefill" for r in stream)
    total = (per_tok + 1) * n + src_calls * n_pre
    common = max(set(rows), key=lambda m: (rows.count(m), m)) if rows else 0
    return want, total, common


#: ``layers`` cuts a depth for the script's time limit: zamba2-2.7b runs
#: 24 of its 54 layers (4 of its 9 super-blocks)
FAMILY_SERVES = {
    "qwen2-vl-7b": {"phase": "serve_vlm", "backend": "paged"},
    "zamba2-2.7b": {"phase": "serve_hybrid", "backend": "slab",
                    "layers": 24},
    "seamless-m4t-medium": {"phase": "serve_audio", "backend": "slab"},
}


def phase_serve_family(torch, gpu, model, paged, n_slots=4, lead_window=4,
                       block_size=16):
    """One of the last three model families at full width and depth, on
    its main path: K1 on every projection (and K2 on the VLM's paged
    decode), from seeded random weights, bp_exact, 8 requests on 4 slots.
    Beside it the same engine config on the plain versions, each request's
    ``generate()`` (with its extras), a family check (the VLM: the slab
    store against the paged one, text-only prefix hits, the two requests
    with equal tokens and different images, and a ``generate()`` on three
    unequal M-RoPE position rows; the audio family: the 80-frame source's
    ``cross_len``), and a profiled one-request serve whose decode steps
    are annotated."""
    import numpy as np

    from repro_torch import serving
    from repro_torch.models import causal_lm, encdec, zamba_model

    cfg, params = model["cfg"], model["params"]
    spec = FAMILY_SERVES[cfg.name]
    L = cfg.num_layers
    plain_cfg = cfg.replace(matmul_backend="plain")

    def engine_for(c, backend=spec["backend"]):
        return serving.ServingEngine(
            c, params, serving.ServeConfig(max_new_tokens=32,
                                           temperature=0.0,
                                           cache_backend=backend,
                                           block_size=block_size),
            device="cuda")

    if cfg.family == "vlm":
        prompts, extras = _vlm_workload(serving, np, cfg.vocab_size,
                                        cfg.d_model)
        annotate = (causal_lm, "decode_step_paged")
    elif cfg.family == "hybrid":
        prompts, extras = _hybrid_workload(serving, np, cfg.vocab_size)
        annotate = (zamba_model, "decode_step")
    else:
        prompts, extras = _audio_workload(serving, np, cfg.vocab_size,
                                          cfg.d_model)
        annotate = (encdec, "decode_step")
    extras = extras or None
    # a near-tie: within 4 bf16 units of the top logit, or, for the
    # hybrid, within the model's float32 noise floor measured in this run
    noise = (recurrent_noise_floor(torch, cfg, params, prompts)
             if cfg.family == "hybrid" else None)
    tie = max((r["plain_chunked_vs_step"] for r in noise), default=0.0) \
        if noise else 0.0
    engine = engine_for(cfg)
    sched = serving.SchedulerConfig(lead_window=lead_window)
    cache_T = max(r.prompt_len + r.max_new_tokens for r in prompts) + 8
    kw = dict(n_slots=n_slots, cache_T=cache_T, sched_cfg=sched,
              extras=extras)
    t0 = time.perf_counter()
    # warm-up serve (allocator, kernels): not measured
    guarded_serve(engine, _copies(serving, prompts[:2]), **kw)
    torch.cuda.synchronize()

    # -- the measured main-path run: counts zeroed just before, read after
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    loop = engine.make_loop(_copies(serving, prompts), **kw)
    step_lengths, cross_lens = [], set()

    def on_step(lp):
        step_lengths.append(lp.cm.cache_len_vector().tolist())
        if cfg.family == "audio":
            cross_lens.update(lp.cm.cache["cross_len"].tolist())

    loop.on_step_end = on_step
    report = loop.run()
    no_fault_guard(report, loop.stream, spec["phase"])
    torch.cuda.synchronize()
    launches = launch_counts()
    peak_mem_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    prefills = [r for r in loop.stream if r["kind"] == "prefill"]
    step_ms = [1e3 * r["wall_s"] for r in loop.stream
               if r["kind"] == "decode"]
    toks = {r.request_id: r.tokens.tolist() for r in report.results}
    routes, n_k1, prefill_m = _forward_routes(cfg, loop.stream)
    expected = {"bp_matmul": n_k1, "bp_matmul_gemv": routes["gemv"],
                "bp_matmul_tile": routes["tile"],
                "paged_attention": L * report.steps
                if spec["backend"] == "paged" else 0, "wkv6": 0}
    marks = {"measured_serve": time.perf_counter()}

    def flips(got, want, names, eng=engine):
        return [_flip(torch, np, eng, prompts[i].prompt, got[i], want[i],
                      cache_T, i, names=names, tie=tie,
                      extra=(extras or {}).get(i))
                for i in sorted(got) if got[i] != want[i]]

    # -- the same engine config and batching on the plain versions
    reset_counts()
    rep_plain = guarded_serve(engine_for(plain_cfg),
                              _copies(serving, prompts), **kw)
    plain_launches = launch_counts()
    reset_counts()
    plain_toks = {r.request_id: r.tokens.tolist() for r in rep_plain.results}
    plain_flips = flips(toks, plain_toks, ("kernel", "plain"))
    marks["plain_serve"] = time.perf_counter()

    # -- generate(), one request at a time, with its extras
    gen_toks = {}
    for i, r in enumerate(prompts):
        batch = {"tokens": r.prompt[None],
                 **_grow_extra(np, (extras or {}).get(i), r.prompt_len)}
        gen_toks[i] = engine.generate(batch, max_new_tokens=r.max_new_tokens,
                                      cache_T=cache_T).tokens[0].tolist()
    gen_flips = flips(toks, gen_toks, ("serve", "generate"))
    reset_counts()
    marks["generate"] = time.perf_counter()

    family = {}
    if cfg.family == "vlm":
        # the slab store (bf16 KV: K1 only) against the paged one
        reset_counts()
        rep_slab = guarded_serve(engine_for(cfg, "slab"),
                                 _copies(serving, prompts), **kw)
        slab_launches = launch_counts()
        reset_counts()
        slab_toks = {r.request_id: r.tokens.tolist()
                     for r in rep_slab.results}
        # M-RoPE on the card: request 0's image as a 8 x 16 grid at t 0,
        # its text on from the grid's largest index, kernel and plain
        r0 = prompts[0]
        span = int(extras[0]["vision_mask"].sum())
        pos = _mrope_positions(np, span, r0.prompt_len)
        mrope_extra = dict(extras[0], positions=pos)
        mb = {"tokens": r0.prompt[None],
              **_grow_extra(np, mrope_extra, r0.prompt_len)}
        mrope = engine.generate(mb, max_new_tokens=8,
                                cache_T=cache_T).tokens[0].tolist()
        mrope_plain = engine_for(plain_cfg).generate(
            mb, max_new_tokens=8, cache_T=cache_T).tokens[0].tolist()
        reset_counts()
        family = {
            "slab_tokens_equal_paged": slab_toks == toks,
            "slab_flips": flips(slab_toks, toks, ("slab", "paged")),
            "slab_launches": slab_launches,
            "equal_token_pair_streams_differ": toks[0] != toks[1],
            "mrope_rows_distinct": bool((pos[0] != pos[1]).any()
                                        and (pos[1] != pos[2]).any()),
            "mrope_generate": mrope, "mrope_generate_plain": mrope_plain,
            "mrope_differs_from_default_positions": mrope != gen_toks[0][:8],
        }
        marks["slab_and_mrope"] = time.perf_counter()
    elif cfg.family == "audio":
        family = {"cross_lens_seen": sorted(cross_lens),
                  "cross_positions_per_slot":
                      int(loop.cm.cache["cross_k"].shape[2])}

    # -- a profiled one-request serve (4 new tokens: the profiler's
    # post-processing grows with the kernels); the decode
    # steps are annotated, so their device time stands apart
    profile = _profile_serve(
        torch, engine, _copies(serving, prompts[:1], max_new_tokens=4),
        n_slots, cache_T, sched, annotate=(annotate,),
        extras={0: extras[0]} if extras else None)
    reset_counts()
    marks["profile"] = time.perf_counter()
    dec = profile["annotated"].get(annotate[1], {})
    per_step_dev = (dec["device_ms"] / dec["count"]
                    if dec.get("count") else None)

    wb = model["weight_bytes"]
    p = serving.percentiles(step_ms, qs=(50, 90))
    result = {
        "phase": spec["phase"], "gpu": gpu, "model": cfg.name,
        "family": cfg.family, "layers": L, "d_model": cfg.d_model,
        "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
        "head_dim": cfg.resolved_head_dim, "d_ff": cfg.d_ff,
        "vocab": cfg.vocab_size, "mode": cfg.matmul_mode,
        "cache_backend": spec["backend"], "n_requests": len(prompts),
        "n_slots": n_slots, "cache_T": cache_T,
        "prompt_lens": [r.prompt_len for r in prompts],
        "init_and_quantize_s": model["init_and_quantize_s"],
        "init_and_quantize_peak_mem_gb":
            model["init_and_quantize_peak_mem_gb"],
        "weight_bytes": wb,
        "prefill_calls": len(prefills),
        "prefill_groups": [[r["group_size"], r["pad_to"]] for r in prefills],
        "decode_steps": report.steps,
        "total_new_tokens": report.total_new_tokens,
        "launches": launches, "expected_launches": expected,
        "plain_backend_launches": plain_launches,
        "prefix_hit_blocks": report.prefix_hit_blocks,
        "n_preemptions": report.n_preemptions,
        "tokens_equal_plain_backend": not plain_flips,
        "plain_flips": plain_flips,
        "generate_equal_serve": not gen_flips,
        "generate_flips": gen_flips,
        "noise_floor": noise, "near_tie_logit_gap": tie,
        **family,
        "decode_tokens_per_s": report.decode_tokens_per_s,
        "step_wall_tokens_per_s": step_wall_rate(loop.stream),
        "decode_step_ms_p50": p["p50"] if p else None,
        "decode_step_ms_p90": p["p90"] if p else None,
        "ttft_wall_s_by_request": [r.ttft_wall_s for r in report.results],
        "prefill_s": report.prefill_s, "decode_s": report.decode_s,
        "serve_paged_beside": {
            k: paged.get(k) for k in ("decode_tokens_per_s",
                                      "decode_step_ms_p50",
                                      "decode_step_ms_p90")},
        "peak_mem_gb": peak_mem_gb,
        "decode_step_device_ms": per_step_dev,
        "decode_step_weight_bound_ms":
            (wb["int8_dense"] / HBM_BYTES_PER_S * 1e3),
        "first_tokens": toks[0][:8],
        "profile": profile,
        "wall_s": _spans(marks, t0),
    }
    emit(result)
    check(all(r.finish_reason == "length" for r in report.results),
          f"a {cfg.name} request finished for another reason than length")
    check(all(0 <= t < cfg.vocab_padded for ts in toks.values() for t in ts),
          "a generated token lies outside the padded vocabulary")
    for name, want in expected.items():
        check(launches[name] == want,
              f"{name} launched {launches[name]} times on the {cfg.name} "
              f"path, expected {want}")
    check(not any(plain_launches.values()),
          f"the plain backend launched a kernel: {plain_launches}")
    for what, fl in (("the plain-version serve", plain_flips),
                     ("generate()", gen_flips),
                     ("the slab serve", family.get("slab_flips", []))):
        bad = [f for f in fl if not f["near_tie"]]
        check(not bad, f"{cfg.name}: serve and {what} differ beyond a "
                       f"near-tie: {bad}")
    if cfg.family == "vlm":
        check(launches["routed_plain_int8_kv"] == 0,
              "paged attention was routed to the plain version")
        # only the text-only pair shares: its 128-token system prompt is 8
        # full blocks (a partial hit adds one); every vision request opens
        # with image-pad tokens, and would share them were it not kept out
        # of the trie
        check(1 <= report.prefix_hit_blocks <= 9,
              f"{cfg.name}: {report.prefix_hit_blocks} prefix-hit blocks, "
              f"expected the text-only pair's 1-9")
        sl = family["slab_launches"]
        check(sl["paged_attention"] == 0 and sl["bp_matmul"] > 0,
              f"{cfg.name} slab serve launches: {sl}")
        check(family["mrope_rows_distinct"], "the M-RoPE rows are equal")
        bad = _flip(torch, np, engine, prompts[0].prompt, mrope,
                    mrope_plain, cache_T, 0, names=("kernel", "plain"),
                    extra=mrope_extra)
        check(mrope == mrope_plain or bad["near_tie"],
              f"M-RoPE generate(): kernel and plain differ beyond a "
              f"near-tie: {bad}")
    if cfg.family == "audio":
        check(min(AUDIO_FRAMES) in cross_lens,
              f"no slot held the {min(AUDIO_FRAMES)}-frame source's length: "
              f"{sorted(cross_lens)}")
    full = [ls for ls in step_lengths if min(ls) > 0] or step_lengths
    shape = sorted(full, key=sum)[len(full) // 2]
    return result, {**launches, "prefill_rows": prefill_m}, {
        "lengths": shape,
        "pages_per_seq": getattr(loop.cm, "blocks_per_seq", None),
        "dims": attention_dims(cfg)}


def phase_serve_families(torch, gpu, paged):
    """The vision-language, hybrid and encoder-decoder families, each
    built, served and freed in turn.  Returns ({phase: record}, {phase:
    launches}, {phase: decode shape})."""
    import gc
    records, launches, shapes = {}, {}, {}
    for name, spec in FAMILY_SERVES.items():
        model = build_full(torch, name, spec.get("layers"))
        try:
            ph = spec["phase"]
            records[ph], launches[ph], shapes[ph] = phase_serve_family(
                torch, gpu, model, paged)
        finally:
            del model
            gc.collect()
            torch.cuda.empty_cache()
    return records, launches, shapes


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
# ---------------------------------------------------------------------------
# train: the training path (qat learns; bp_exact / bp_approx run K1)
# ---------------------------------------------------------------------------

#: the train phase's data: the repo's synthetic Zipf pipeline at qwen2's
#: vocabulary, 8 sequences of 1024 tokens a step
TRAIN_DATA = dict(vocab_size=151936, seq_len=1024, global_batch=8)
TRAIN_STEPS = 8
#: the resume check's first trainer stops (and saves) here; a fresh one
#: resumes there
TRAIN_SAVE_AT = 4
#: the resume check runs qwen2-1.5b's width at this depth: the full
#: model's state (21.6 GB) took 50-55 s to write and read back on a
#: checkout's disk, past the issue's 60 s mark with any slower disk
TRAIN_RESUME_LAYERS = 2
#: dense projections of one qwen2-1.5b layer (q, k, v, o, gate, up, down)
QWEN_LAYER_PROJ = 7


def _state_bytes(tree):
    from repro_torch.tree import leaves
    return sum(t.numel() * t.element_size() for t in leaves(tree))


def _same_bits(torch, a, b):
    """Bit-for-bit equality of two tensors of one dtype and shape."""
    return (a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8)))


def _percentile(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))]


def _qat_config():
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.train_loop import TrainConfig
    return TrainConfig(total_steps=TRAIN_STEPS, grad_accum=2,
                       ckpt_every=10 ** 9, ckpt_keep=1, log_every=1,
                       optimizer=opt_lib.OptimizerConfig(
                           peak_lr=1e-3, warmup_steps=2,
                           total_steps=TRAIN_STEPS))


def _train_qat(torch, cfg, data):
    """Part (a): qat learns.  ``make_train_step`` for ``TRAIN_STEPS``
    steps from ``api.init``'s seed-0 params, the batches from the
    ``PrefetchingLoader`` a ``Trainer`` reads, each step's loss read on
    the host as the ``Trainer`` reads it.  Returns (record, the trained
    params)."""
    import numpy as np

    from repro_torch.data.pipeline import PrefetchingLoader
    from repro_torch.models import api
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.train_loop import batch_to_device, make_train_step
    step_fn = make_train_step(cfg, _qat_config())
    reset_counts()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = api.init(cfg, seed=0, device="cuda")
    opt = opt_lib.init_state(params)
    err = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    state_gb = _state_bytes({"params": params, "opt": opt}) / 1e9
    metrics, walls = [], []
    loader = PrefetchingLoader(data, start_step=0, q_depth=2)
    try:
        for step in range(1, TRAIN_STEPS + 1):
            batch = batch_to_device(next(loader), "cuda")
            t0 = time.perf_counter()
            params, opt, err, m = step_fn(params, opt, err, batch, 0.0)
            m = {k: float(v) for k, v in m.items() if np.ndim(v) == 0}
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            metrics.append({"step": step, **m})
    finally:
        loader.close()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = launch_counts()
    losses = [m["loss"] for m in metrics]
    check(all(math.isfinite(x) for x in losses), f"qat losses {losses}")
    check(all(m["committed"] == 1.0 for m in metrics),
          f"a qat step was rejected: {metrics}")
    check(losses[-1] < losses[0], f"qat loss did not fall: {losses}")
    check(launches["bp_matmul"] == 0,
          f"qat launched K1 {launches['bp_matmul']} times")
    tokens = data.global_batch * data.seq_len
    # the first step pays the process's warm-up (allocator, cuBLAS
    # handles): reported apart from the steady steps' percentiles
    steady = walls[1:]
    p50 = _percentile(steady, 0.5)
    del opt, err
    torch.cuda.empty_cache()
    return {"mode": "qat", "steps": TRAIN_STEPS, "grad_accum": 2,
            "micro_batch_rows": tokens // 2, "losses": losses,
            "lr": [m["lr"] for m in metrics],
            "grad_norm": [m["grad_norm"] for m in metrics],
            "committed": [m["committed"] for m in metrics],
            "step_wall_s": walls, "first_step_s": walls[0],
            "step_wall_p50_s": p50,
            "step_wall_p90_s": _percentile(steady, 0.9),
            "tokens_per_s": tokens * len(walls) / sum(walls),
            "tokens_per_s_p50": tokens / p50, "peak_mem_gb": peak_gb,
            "init_s": init_s, "state_gb": state_gb,
            "launches": launches}, params


def _train_resume(torch, cfg, data, ckpt_dir):
    """Part (a), the resume: qwen2-1.5b's width cut to
    ``TRAIN_RESUME_LAYERS`` layers in qat.  A ``Trainer`` for
    ``TRAIN_SAVE_AT`` steps (saved at the end, keep 1), then a fresh
    ``Trainer`` that resumes there, every leaf bit-equal to the saved
    one, and runs to ``TRAIN_STEPS``."""
    import dataclasses

    from repro_torch.train.train_loop import Trainer
    from repro_torch.tree import leaf_paths
    cfg = cfg.replace(num_layers=TRAIN_RESUME_LAYERS)
    tc = dataclasses.replace(_qat_config(), total_steps=TRAIN_SAVE_AT,
                             ckpt_dir=str(ckpt_dir))
    stamps, metrics = [], []

    def on_metrics(step, m):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        metrics.append({"step": step, **m})

    first = Trainer(cfg, tc, data, init_seed=0, device="cuda")
    state_gb = _state_bytes(first._state_tree()) / 1e9
    first.run(on_metrics)
    write_s = time.perf_counter() - stamps[-1]
    check(first.ckpt.all_steps() == [TRAIN_SAVE_AT],
          f"the first trainer's checkpoints: {first.ckpt.all_steps()}")
    saved = [(path, t.detach().cpu())
             for path, t in leaf_paths(first._state_tree())]
    del first
    torch.cuda.empty_cache()
    second = Trainer(cfg, dataclasses.replace(tc, total_steps=TRAIN_STEPS),
                     data, init_seed=1, device="cuda")
    check(second.start_step == TRAIN_SAVE_AT,
          f"resumed at step {second.start_step}, not {TRAIN_SAVE_AT}")
    restored = leaf_paths(second._state_tree())
    check([p for p, _ in restored] == [p for p, _ in saved],
          "the restored state's leaves differ from the saved ones")
    unequal = [p for (p, got), (_, want) in zip(restored, saved)
               if not _same_bits(torch, got, want.to(got.device))]
    check(not unequal, f"restored leaves differ from the saved ones: "
                       f"{unequal[:5]}")
    del saved
    second.run(on_metrics)
    read_s = second.resume_s
    losses = [m["loss"] for m in metrics]
    check([m["step"] for m in metrics] == list(range(1, TRAIN_STEPS + 1)),
          f"resume check's steps {[m['step'] for m in metrics]}")
    check(all(math.isfinite(x) for x in losses),
          f"resume check's losses {losses}")
    check(all(m["committed"] == 1.0 for m in metrics),
          f"a resume check's step was rejected: {metrics}")
    del second
    torch.cuda.empty_cache()
    return {"layers": TRAIN_RESUME_LAYERS, "save_at": TRAIN_SAVE_AT,
            "steps": TRAIN_STEPS, "losses": losses,
            "restored_bit_equal": True, "state_gb": state_gb,
            "ckpt_write_s": write_s, "ckpt_write_gb_per_s": state_gb / write_s,
            "ckpt_read_s": read_s, "ckpt_read_gb_per_s": state_gb / read_s}


def phase_train(torch, gpu):
    """The training path on full-width, full-depth qwen2-1.5b (module
    docstring, ``train``)."""
    import shutil

    from repro_torch.configs.base import get_arch
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.models import remat
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.train_loop import (TrainConfig, batch_to_device,
                                              make_train_step)
    from repro_torch.tree import leaf_paths
    cfg = get_arch("qwen2-1.5b")
    data = DataConfig(**TRAIN_DATA)
    qat_cfg = cfg.replace(matmul_mode="qat")
    ckpt_dir = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    try:
        resume = _train_resume(torch, qat_cfg, data, ckpt_dir)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    qat, params = _train_qat(torch, qat_cfg, data)
    qat["resume"] = resume
    emit({"phase": "train", "part": "qat", "gpu": gpu, **qat})

    # (b) bp_exact: the same step function on K1 at M 8192, against a step
    # on the plain versions from the same params and batch
    batch = batch_to_device(make_batch(data, 100), "cuda")
    tc = TrainConfig(total_steps=TRAIN_STEPS, grad_accum=1, optimizer=(
        opt_lib.OptimizerConfig(peak_lr=1e-3, warmup_steps=2,
                                total_steps=TRAIN_STEPS)))
    opt = opt_lib.init_state(params)
    err = torch.zeros(1, device="cuda")
    rows = data.global_batch * data.seq_len
    bp = cfg.replace(matmul_mode="bp_exact")
    # the plain step first, rejected on purpose (a tiny median): it
    # computes the loss and gradients and leaves the state as it was
    reset_counts()
    plain_step = make_train_step(bp.replace(matmul_backend="plain"), tc)
    _, _, _, plain = plain_step(params, opt, err, batch, 1e-30)
    torch.cuda.synchronize()
    check(plain["committed"].item() == 0.0 and
          launch_counts()["bp_matmul"] == 0,
          "the plain-version step committed or launched K1")
    step = make_train_step(bp, tc)
    exact = {"mode": "bp_exact", "rows": rows, "steps": []}
    for i in range(2):
        reset_counts()
        remat.reset_runs()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, err, m = step(params, opt, err, batch, 0.0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        lc = launch_counts()
        runs = remat.RUNS["body"]
        exact["steps"].append({"loss": float(m["loss"]),
                               "grad_norm": float(m["grad_norm"]),
                               "committed": float(m["committed"]),
                               "wall_s": wall, "layer_runs": runs,
                               "launches": lc})
        check(runs == 2 * cfg.num_layers,
              f"bp_exact step {i + 1}: {runs} checkpointed layer runs, "
              f"not {2 * cfg.num_layers} (a forward and a recomputation)")
        check(lc["bp_matmul_tile"] == QWEN_LAYER_PROJ * runs
              and lc["bp_matmul_gemv"] == 0,
              f"bp_exact step {i + 1}: K1 launches {lc}, expected "
              f"{QWEN_LAYER_PROJ} x {runs} tiles")
        check(float(m["committed"]) == 1.0, "a bp_exact step was rejected")
    k0 = exact["steps"][0]
    exact["plain_loss"] = float(plain["loss"])
    exact["plain_grad_norm"] = float(plain["grad_norm"])
    exact["loss_rel_diff"] = abs(k0["loss"] - exact["plain_loss"]) / abs(
        exact["plain_loss"])
    exact["grad_norm_rel_diff"] = abs(
        k0["grad_norm"] - exact["plain_grad_norm"]) / exact["plain_grad_norm"]
    check(exact["loss_rel_diff"] <= 1e-3,
          f"bp_exact loss: kernel {k0['loss']} vs plain "
          f"{exact['plain_loss']}")
    check(exact["grad_norm_rel_diff"] <= 1e-2,
          f"bp_exact grad norm: kernel {k0['grad_norm']} vs plain "
          f"{exact['plain_grad_norm']}")
    # a zero gradient leaves Adam's moments exactly zero: every dense
    # weight's, after two committed steps; the embedding's are not
    moments = dict(leaf_paths({"m": opt["m"], "v": opt["v"]}))
    dense = [p for p in moments if p.endswith("/w")]
    check(len(dense) == 2 * QWEN_LAYER_PROJ and not any(
        moments[p].any().item() for p in dense),
          "a bp_exact dense weight got a nonzero gradient")
    check(moments["m/embed/table"].any().item(),
          "the embedding got no gradient in bp_exact")
    exact["dense_weight_moments_zero"] = len(dense)
    emit({"phase": "train", "part": "bp_exact", "gpu": gpu, **exact})

    # (c) bp_approx: one step
    reset_counts()
    remat.reset_runs()
    params, opt, err, m = make_train_step(
        cfg.replace(matmul_mode="bp_approx"), tc)(params, opt, err, batch,
                                                  0.0)
    lc = launch_counts()
    approx = {"mode": "bp_approx", "rows": rows, "loss": float(m["loss"]),
              "grad_norm": float(m["grad_norm"]),
              "layer_runs": remat.RUNS["body"], "launches": lc}
    check(math.isfinite(approx["loss"]), f"bp_approx loss {approx['loss']}")
    check(lc["bp_matmul_tile"] == QWEN_LAYER_PROJ * approx["layer_runs"]
          == QWEN_LAYER_PROJ * 2 * cfg.num_layers,
          f"bp_approx K1 launches {lc}")
    emit({"phase": "train", "part": "bp_approx", "gpu": gpu, **approx})

    # (d) a profiled step of qat, then one of bp_exact
    from torch.profiler import ProfilerActivity, profile
    profiles = {}
    for mode in ("qat", "bp_exact"):
        fn = make_train_step(cfg.replace(matmul_mode=mode), tc)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            params, opt, err, m = fn(params, opt, err, batch, 0.0)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        prof_rec = profile_summary(prof, wall_ms, top=8)
        busy = prof_rec["device_busy_ms"]
        prof_rec["k1_share_of_device"] = (
            (prof_rec["bp_matmul_gemv_device_ms"]
             + prof_rec["bp_matmul_tile_device_ms"]) / busy if busy else None)
        profiles[mode] = prof_rec
    emit({"phase": "train", "part": "profile", "gpu": gpu,
          "profiles": profiles})
    launches = {"bp_matmul_tile": sum(s["launches"]["bp_matmul_tile"]
                                      for s in exact["steps"])
                + approx["launches"]["bp_matmul_tile"],
                "bp_matmul_gemv": 0}
    del params, opt, err, batch
    torch.cuda.empty_cache()
    return {"qat": qat, "bp_exact": exact, "bp_approx": approx,
            "profile": profiles}, launches


# ---------------------------------------------------------------------------
# train_dist: bounded staleness, the pipeline, elastic restore, the dry run
# ---------------------------------------------------------------------------

#: the staleness trainer's bound, groups and steps, and one group's batch
QS_E = 3
QS_GROUPS = 4
QS_STEPS = 4
QS_DATA = dict(vocab_size=151936, seq_len=512, global_batch=2)
#: the pipeline: stages over a ("model",) mesh on the card, microbatches,
#: and its batch
PIPE_STAGES = 4
PIPE_MICRO = 4
PIPE_DATA = dict(vocab_size=151936, seq_len=512, global_batch=8)
#: the elastic check's meshes: placed on the first, restored on the rest
ELASTIC_MESHES = ((2, 2), (1, 4), (4, 1), (1, 1))


def _cuda_mesh(shape, axes=("data", "model")):
    from repro_torch.launch.mesh import make_mesh
    return make_mesh(shape, axes, "cuda:0")


def _grads_of(torch, cfg, params, batch):
    """(loss, gradient tree) of ``api.loss_fn``; an unused leaf (a bp_*
    dense weight) gets an exact zero, as in ``make_train_step``."""
    from repro_torch.models import api
    from repro_torch.tree import leaves, unflatten
    flat = leaves(params)
    for p in flat:
        if p.is_floating_point():
            p.requires_grad_(True)
    trained = [p for p in flat if p.requires_grad]
    with torch.enable_grad():
        loss, _ = api.loss_fn(params, cfg, batch)
        got = iter(torch.autograd.grad(loss, trained, allow_unused=True))
    grads = []
    for p in flat:
        g = next(got) if p.requires_grad else None
        grads.append(torch.zeros_like(p) if g is None else g)
    return loss.detach(), unflatten(params, grads)


def _leaf_rel(torch, got, want):
    """Relative Frobenius distance of two tensors, in float32."""
    d = torch.linalg.vector_norm((got.float() - want.float()).reshape(-1))
    n = torch.linalg.vector_norm(want.float().reshape(-1))
    return float(d / n) if float(n) > 0 else float(d)


def _train_quasi_sync(torch, cfg):
    """Part (a): ``BoundedStalenessTrainer`` in qat, ``update_fn`` on
    ``apply_updates``; one step with lags forced to 0 against one
    synchronous ``make_train_step`` update on the groups joined, then
    drawn lags, then one bp_exact step on K1."""
    import numpy as np

    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.distributed.quasi_sync import BoundedStalenessTrainer
    from repro_torch.models import api, remat
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.train_loop import (TrainConfig, batch_to_device,
                                              make_train_step)
    from repro_torch.tree import leaf_paths, leaves, tree_map
    data = DataConfig(**QS_DATA)
    opt_cfg = opt_lib.OptimizerConfig(peak_lr=1e-3, warmup_steps=2,
                                      total_steps=8)
    qat = cfg.replace(matmul_mode="qat")
    groups = [[batch_to_device(make_batch(data, 10 * step + g), "cuda")
               for g in range(QS_GROUPS)] for step in range(QS_STEPS + 1)]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    p0 = api.init(qat, seed=0, device="cuda")

    # the synchronous reference: one update on the four groups joined
    joined = {k: torch.cat([b[k] for b in groups[0]]) for k in groups[0][0]}
    sync_params = tree_map(lambda t: t.detach().clone(), p0)
    sync_opt = opt_lib.init_state(sync_params)
    sync_step = make_train_step(qat, TrainConfig(grad_accum=QS_GROUPS,
                                                 optimizer=opt_cfg))
    _, sync_opt, _, sync_m = sync_step(sync_params, sync_opt,
                                       torch.zeros(1, device="cuda"),
                                       joined, 0.0)
    sync_master = sync_opt["master"]
    del sync_params, sync_opt
    torch.cuda.empty_cache()
    sync_s = time.perf_counter() - t0

    opt = opt_lib.init_state(p0)
    mode = {"cfg": qat}
    calls, losses = [], []

    def grad_fn(params, batch):
        reset_counts()
        remat.reset_runs()
        loss, grads = _grads_of(torch, mode["cfg"], params, batch)
        calls.append({"version": id(params), "loss": float(loss),
                      "k1": launch_counts(), "runs": remat.RUNS["body"]})
        losses.append(float(loss))
        return grads

    def update_fn(params, grads):
        opt_lib.apply_updates(opt_cfg, params, opt, grads)
        return params

    tr = BoundedStalenessTrainer(grad_fn, update_fn, p0, E=QS_E, seed=0,
                                 n_groups=QS_GROUPS)
    steps, walls = [], []
    for step in range(QS_STEPS + 1):
        if step == QS_STEPS:
            mode["cfg"] = cfg.replace(matmul_mode="bp_exact")
        before = list(tr.history)
        calls.clear()
        lags = np.zeros(QS_GROUPS, int) if step == 0 else None
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        tr.step(groups[step], lags=lags)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t1)
        want = [id(before[-1 - int(lag)]) for lag in tr.last_lags]
        check([c["version"] for c in calls] == want,
              f"quasi-sync step {step + 1}: gradients taken on versions "
              f"{[c['version'] for c in calls]}, lags {tr.last_lags} name "
              f"{want}")
        steps.append({"lags": [int(x) for x in tr.last_lags],
                      "losses": [c["loss"] for c in calls],
                      "wall_s": walls[-1],
                      "mode": "bp_exact" if step == QS_STEPS else "qat"})
        if step == 0:
            # the forced-zero-lag step against the synchronous update:
            # the float32 master's change, leaf by leaf
            rels = {}
            for (path, mq), ms, p in zip(leaf_paths(opt["master"]),
                                         leaves(sync_master), leaves(p0)):
                base = p.detach().float()
                rels[path] = _leaf_rel(torch, mq - base, ms - base)
            worst = max(rels, key=rels.get)
            steps[0]["sync_worst_leaf"] = worst
            steps[0]["sync_worst_rel"] = rels[worst]
            steps[0]["sync_loss"] = float(sync_m["loss"])
            check(rels[worst] <= 1e-2,
                  f"quasi-sync zero-lag step vs synchronous update: leaf "
                  f"{worst} parts by {rels[worst]:.3e} (> 1e-2)")
            del sync_master
            torch.cuda.empty_cache()
    last = calls
    check(all(math.isfinite(x) for x in losses), f"quasi-sync losses {losses}")
    n_proj = QWEN_LAYER_PROJ * 2 * cfg.num_layers
    check(all(c["k1"]["bp_matmul_tile"] == n_proj
              and c["k1"]["bp_matmul_gemv"] == 0
              and c["runs"] == 2 * cfg.num_layers for c in last),
          f"bp_exact staleness step: K1 per group "
          f"{[c['k1'] for c in last]}, expected {n_proj} tiles "
          f"({QWEN_LAYER_PROJ} x {2 * cfg.num_layers} layer runs)")
    check(len(tr.history) == QS_E + 1,
          f"the ring holds {len(tr.history)} versions, not {QS_E + 1}")
    ptrs = [leaves(v)[0].untyped_storage().data_ptr() for v in tr.history]
    check(len(set(ptrs)) == len(ptrs),
          f"versions in the ring share storage: {ptrs}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    rec = {"E": QS_E, "groups": QS_GROUPS,
           "group_tokens": QS_DATA["global_batch"] * QS_DATA["seq_len"],
           "steps": steps, "versions": len(tr.history),
           "sync_step_s": sync_s, "peak_mem_gb": peak,
           "k1_per_group_bp_exact": n_proj,
           "wall_s": time.perf_counter() - t0}
    launches = QS_GROUPS * n_proj
    del tr, opt, p0, groups, calls, last
    torch.cuda.empty_cache()
    return rec, launches


def _pipeline_stage(torch, cfg):
    """A stage of ``PIPE_STAGES``: its share of qwen2-1.5b's decoder
    layers, positions 0..S-1."""
    from repro_torch.models import causal_lm, layers
    per = cfg.num_layers // PIPE_STAGES

    def stage(sp, x):
        B, S, _ = x.shape
        pos = torch.arange(S, device=x.device)[None].expand(B, S)
        cos, sin = causal_lm._angles(cfg, pos)
        for i in range(per):
            x, _ = causal_lm._train_block(layers.stack_slice(sp, i), x, cfg,
                                          cfg.matmul_mode, cos, sin)
        return x
    return stage


def _train_pipeline(torch, cfg):
    """Part (b): ``pipeline_apply`` over a 4-stage ("model",) mesh on the
    card: bp_exact forward bit-equal to the stack run one microbatch at a
    time, K1 exact; qat gradients of a scalar loss against the stack's."""
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.distributed.pipeline import pipeline_apply
    from repro_torch.models import api, layers
    from repro_torch.tree import leaf_paths, leaves, tree_map
    t0 = time.perf_counter()
    mesh = _cuda_mesh((PIPE_STAGES,), ("model",))
    data = DataConfig(**PIPE_DATA)
    tokens = torch.as_tensor(make_batch(data, 200)["tokens"],
                             device="cuda")
    params = api.init(cfg, seed=0, device="cuda")
    per = cfg.num_layers // PIPE_STAGES
    staged = tree_map(lambda t: t.reshape(PIPE_STAGES, per, *t.shape[1:]),
                      params["layers"])
    mb = PIPE_DATA["global_batch"] // PIPE_MICRO
    rec = {"stages": PIPE_STAGES, "layers_per_stage": per,
           "microbatches": PIPE_MICRO,
           "tokens": PIPE_DATA["global_batch"] * PIPE_DATA["seq_len"]}

    def stack(c, x, sp_tree, per_micro=True):
        stage = _pipeline_stage(torch, c)
        parts = x.split(mb) if per_micro else (x,)
        outs = []
        for h in parts:
            for s in range(PIPE_STAGES):
                h = stage(tree_map(lambda t, s=s: t[s], sp_tree), h)
            outs.append(h)
        return torch.cat(outs)

    bp = cfg.replace(matmul_mode="bp_exact")
    with torch.no_grad():
        x = layers.embed(params["embed"], tokens)
        reset_counts()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = pipeline_apply(_pipeline_stage(torch, bp), staged, x,
                             mesh=mesh, n_microbatches=PIPE_MICRO)
        torch.cuda.synchronize()
        rec["bp_exact_forward_s"] = time.perf_counter() - t1
        lc = launch_counts()
        want_k1 = QWEN_LAYER_PROJ * cfg.num_layers * PIPE_MICRO
        check(lc["bp_matmul_tile"] == want_k1 and lc["bp_matmul_gemv"] == 0,
              f"pipeline bp_exact K1 launches {lc}, expected {want_k1} "
              f"tiles")
        rec["launches"] = lc
        seq = stack(bp, x, staged)
        check(_same_bits(torch, out, seq),
              f"pipeline bp_exact output differs from the stack run one "
              f"microbatch at a time: max |diff| "
              f"{float((out.float() - seq.float()).abs().max())}")
        whole = stack(bp, x, staged, per_micro=False)
        rec["whole_batch_max_abs_diff"] = float(
            (out.float() - whole.float()).abs().max())
        rec["whole_batch_rel_frobenius"] = _leaf_rel(torch, out, whole)
        del out, seq, whole

    qat = cfg.replace(matmul_mode="qat")
    flat = [t for t in leaves(params["layers"]) if t.is_floating_point()]
    for t in flat:
        t.requires_grad_(True)
    # the stage views again, now of leaves that need a gradient
    staged = tree_map(lambda t: t.reshape(PIPE_STAGES, per, *t.shape[1:]),
                      params["layers"])
    grads = {}
    for name, run in (
            ("pipeline", lambda: pipeline_apply(
                _pipeline_stage(torch, qat), staged, x, mesh=mesh,
                n_microbatches=PIPE_MICRO)),
            ("stack", lambda: stack(qat, x, staged))):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with torch.enable_grad():
            loss = run().float().pow(2).mean()
            grads[name] = torch.autograd.grad(loss, flat)
        torch.cuda.synchronize()
        rec[f"qat_{name}_fwd_bwd_s"] = time.perf_counter() - t1
        rec[f"qat_{name}_loss"] = float(loss.detach())
    paths = [p for p, t in leaf_paths(params["layers"])
             if t.is_floating_point()]
    rels = {p: _leaf_rel(torch, a, b) for p, a, b in
            zip(paths, grads["pipeline"], grads["stack"])}
    worst = max(rels, key=rels.get)
    rec["qat_grad_worst_leaf"] = worst
    rec["qat_grad_worst_rel"] = rels[worst]
    check(rels[worst] <= 1e-2,
          f"pipeline qat gradient of {worst} parts from the stack's by "
          f"{rels[worst]:.3e} (> 1e-2)")
    rec["wall_s"] = time.perf_counter() - t0
    del params, staged, grads, flat, x
    torch.cuda.empty_cache()
    return rec, want_k1


def _train_elastic(torch, cfg, ckpt_dir):
    """Part (c): a full-width state (params and AdamW state, at
    ``TRAIN_RESUME_LAYERS`` layers) placed on a (2, 2) train mesh on the
    card, saved, restored onto each of ``ELASTIC_MESHES[1:]`` and
    gathered, bit-equal to the original."""
    from repro_torch.checkpoint.checkpoint import CheckpointManager
    from repro_torch.distributed import sharding
    from repro_torch.models import api
    from repro_torch.runtime.elastic import restore_for_mesh
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.tree import leaf_paths
    small = cfg.replace(num_layers=TRAIN_RESUME_LAYERS)
    params = api.init(small, seed=0, device="cuda")
    state = {"params": params, "opt": opt_lib.init_state(params)}
    gb = _state_bytes(state) / 1e9
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    placed = sharding.place_tree(state, "train",
                                 _cuda_mesh(ELASTIC_MESHES[0]))
    torch.cuda.synchronize()
    rec = {"layers": TRAIN_RESUME_LAYERS, "state_gb": gb,
           "placed_on": list(ELASTIC_MESHES[0]),
           "place_s": time.perf_counter() - t0, "restores": []}
    mgr = CheckpointManager(str(ckpt_dir), keep=1, async_save=False)
    t0 = time.perf_counter()
    mgr.save(1, placed)
    rec["save_s"] = time.perf_counter() - t0
    rec["save_gb_per_s"] = gb / rec["save_s"]
    del placed
    want = leaf_paths(state)
    for shape in ELASTIC_MESHES[1:]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = restore_for_mesh(mgr, 1, state, _cuda_mesh(shape), "train")
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        whole = sharding.gather_tree(got)
        torch.cuda.synchronize()
        gather_s = time.perf_counter() - t0
        unequal = [p for (p, a), (_, b) in zip(leaf_paths(whole), want)
                   if not _same_bits(torch, a, b)]
        check(not unequal, f"elastic restore onto {shape}: leaves differ "
                           f"{unequal[:5]}")
        rec["restores"].append({"mesh": list(shape),
                                "restore_s": restore_s,
                                "restore_gb_per_s": gb / restore_s,
                                "gather_s": gather_s, "bit_equal": True})
        del got, whole
    del state, params, want
    torch.cuda.empty_cache()
    return rec


def _train_dryrun_vs_card(torch, cfg):
    """Part (d): the dry-run record of the ``train`` phase's cell (8 x
    1024 tokens, mesh (1, 1), meta) in qat and bp_exact, against
    ``op_analysis`` around one real step of each on the card."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.launch import dryrun, op_analysis
    from repro_torch.launch.mesh import HBM_PER_CHIP, make_mesh
    from repro_torch.models import api
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.train_loop import TrainConfig, make_train_step
    total = torch.cuda.get_device_properties(0).total_memory
    check(0.95 * HBM_PER_CHIP <= total <= HBM_PER_CHIP,
          f"the card's {total} bytes do not match HBM_PER_CHIP "
          f"{HBM_PER_CHIP}")
    shape = ShapeConfig("train_8x1024", TRAIN_DATA["seq_len"],
                        TRAIN_DATA["global_batch"], "train")
    tokens = torch.as_tensor(make_batch(DataConfig(**TRAIN_DATA), 300)[
        "tokens"], device="cuda")
    rec = {"hbm_per_chip": HBM_PER_CHIP, "total_memory": total,
           "modes": {}}
    k1 = 0
    for mode in ("qat", "bp_exact"):
        c = cfg.replace(matmul_mode=mode)
        dry = dryrun.run_cell(cfg.name, shape, out_dir=None, verbose=False,
                              mesh=make_mesh((1, 1), ("data", "model"),
                                             "meta"), cfg=c)
        check(dry["ok"], f"dry run of the train cell ({mode}): "
                         f"{dry.get('error')}")
        params = api.init(c, seed=0, device="cuda")
        opt = opt_lib.init_state(params)
        batch = {"tokens": tokens}
        step = make_train_step(c, TrainConfig(
            grad_accum=1, optimizer=opt_lib.OptimizerConfig()))
        err = torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        args = {"params": params, "opt": opt, "batch": batch}
        t0 = time.perf_counter()
        with op_analysis.OpAnalysis(None, args) as oa:
            step(params, opt, err, batch, 0.0)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        real = oa.result()
        measured = torch.cuda.max_memory_allocated()
        lc = launch_counts()
        k1 += lc["bp_matmul_tile"]
        ma = dry["memory_analysis"]
        real_bytes = _state_bytes(args)
        m = {"dry_dot_flops": dry["dot_flops_per_device"],
             "dry_dot_flops_int": dry["dot_flops_int_per_device"],
             "card_dot_flops": real["dot_flops_per_device"],
             "card_dot_flops_int": real["dot_flops_int_per_device"],
             "dry_argument_bytes": ma["argument_size"],
             "card_state_bytes": real_bytes,
             "card_analysis_argument_bytes":
                 real["argument_bytes_per_device"],
             "dry_peak_bytes": ma["peak_memory"],
             "card_analysis_peak_bytes": real["peak_bytes_per_device"],
             "card_max_memory_allocated": measured,
             "peak_ratio_dry_over_card": ma["peak_memory"] / measured,
             "dry_run_s": dry["total_s"], "card_step_under_analysis_s": wall,
             "dry_kernel_calls": dry["kernel_calls"],
             "card_kernel_calls": real["kernel_calls"], "launches": lc}
        check(m["dry_dot_flops"] == m["card_dot_flops"]
              and m["dry_dot_flops_int"] == m["card_dot_flops_int"],
              f"{mode}: dry-run dot FLOPs {m['dry_dot_flops']} / "
              f"{m['dry_dot_flops_int']} against the card's "
              f"{m['card_dot_flops']} / {m['card_dot_flops_int']}")
        check(ma["argument_size"] == real_bytes,
              f"{mode}: dry-run argument bytes {ma['argument_size']} "
              f"against the state's {real_bytes}")
        if mode == "bp_exact":
            check(real["kernel_calls"].get("bp_matmul") == lc["bp_matmul"]
                  > 0, f"bp_exact: op_analysis saw "
                       f"{real['kernel_calls']} K1 calls, launched {lc}")
        rec["modes"][mode] = m
        del params, opt, step, args, oa
        torch.cuda.empty_cache()
    return rec, k1


def phase_train_dist(torch, gpu):
    """The rest of training on full-width qwen2-1.5b (module docstring,
    ``train_dist``)."""
    import shutil

    from repro_torch.configs.base import get_arch
    cfg = get_arch("qwen2-1.5b")
    out = {}
    t0 = time.perf_counter()
    out["quasi_sync"], qs_k1 = _train_quasi_sync(torch, cfg)
    emit({"phase": "train_dist", "part": "quasi_sync", "gpu": gpu,
          **out["quasi_sync"]})
    torch.cuda.reset_peak_memory_stats()
    out["pipeline"], pipe_k1 = _train_pipeline(torch, cfg)
    out["pipeline"]["peak_mem_gb"] = (torch.cuda.max_memory_allocated()
                                      / 2 ** 30)
    emit({"phase": "train_dist", "part": "pipeline", "gpu": gpu,
          **out["pipeline"]})
    ckpt_dir = ROOT / "build" / "elastic_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    try:
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        out["elastic"] = _train_elastic(torch, cfg, ckpt_dir)
        out["elastic"]["wall_s"] = time.perf_counter() - t1
        out["elastic"]["peak_mem_gb"] = (torch.cuda.max_memory_allocated()
                                         / 2 ** 30)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    emit({"phase": "train_dist", "part": "elastic", "gpu": gpu,
          **out["elastic"]})
    t1 = time.perf_counter()
    out["dryrun"], dry_k1 = _train_dryrun_vs_card(torch, cfg)
    out["dryrun"]["wall_s"] = time.perf_counter() - t1
    emit({"phase": "train_dist", "part": "dryrun", "gpu": gpu,
          **out["dryrun"], "phase_s": time.perf_counter() - t0})
    launches = {"bp_matmul_tile": qs_k1 + pipe_k1 + dry_k1,
                "bp_matmul_gemv": 0}
    return out, launches


KERNEL_SYMBOLS = {"bp_matmul_gemv": ("bp_gemv",),
                  "bp_matmul_tile": ("bp_tile", "bp_wgmma"),
                  "paged_attention": ("paged_attention_kernel",),
                  "wkv6": ("wkv6_state_kernel", "wkv6_chunk_kernel")}


def _profile_serve(torch, engine, requests, n_slots, cache_T, sched,
                   annotate=(), **serve_kw):
    """Where a serve's time goes: one more serve of ``requests`` under
    ``torch.profiler``, reduced to device-busy time against wall time, the
    number of kernels launched, each of the port's kernels' device time,
    and the kernels that take the most device time.  The profiler slows
    the host, so ``idle_share`` is an upper bound on the unprofiled run's.
    ``annotate``: (module, function name) pairs wrapped in a
    ``record_function`` of that name for the serve; each one's calls,
    device time (of the kernels launched inside) and host time are in
    ``annotated``."""
    from torch.profiler import ProfilerActivity, profile, record_function

    saved = [(mod, name, getattr(mod, name)) for mod, name in annotate]
    for mod, name, fn in saved:
        def wrapped(*a, _fn=fn, _name=name, **k):
            with record_function(_name):
                return _fn(*a, **k)
        setattr(mod, name, wrapped)
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            rep = guarded_serve(engine, requests, n_slots=n_slots,
                                cache_T=cache_T, sched_cfg=sched, **serve_kw)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return {"requests": len(requests), "decode_steps": rep.steps,
            **profile_summary(prof, wall_ms, [name for _, name, _ in saved])}


def profile_summary(prof, wall_ms, annotations=(), top=6):
    """A ``torch.profiler`` window reduced to device-busy time against
    ``wall_ms``, the number of kernels launched (every device event:
    kernels, copies, fills), each of the port's kernels' device time, and
    the ``top`` kernels by device time; ``annotations``:
    ``record_function`` names whose calls, device time (of the kernels
    launched inside, on the annotation's thread) and host time go in
    ``annotated``.  It reads the profiler's raw events: its own event tree
    (``key_averages``) took ~0.7 ms of host time per kernel launched, 32 s
    for one 45,000-kernel window; ``summary_s`` is what this reduction
    took."""
    import bisect

    from torch.autograd import DeviceType
    t0 = time.perf_counter()
    names = set(annotations)
    # host ops by correlation id: (thread, start), to place each kernel
    # inside the annotation that launched it
    ops, spans, device = {}, {n: [] for n in names}, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU:
            if not e.is_async():
                ops[e.correlation_id()] = (e.start_thread_id(), e.start_ns())
                if e.name() in names:
                    spans[e.name()].append((e.start_ns(), e.end_ns(),
                                            e.start_thread_id()))
        elif e.duration_ns() > 0 and e.name() not in names:
            # (an annotation's device-side span is not a kernel)
            device.append(e)
    per_name = {}
    for e in device:
        c = per_name.setdefault(e.name(), [0, 0])
        c[0] += 1
        c[1] += e.duration_ns()
    busy_ms = sum(ns for _, ns in per_name.values()) / 1e6
    ours = {name: sum(ns for key, (_, ns) in per_name.items()
                      if any(sym in key for sym in syms)) / 1e6
            for name, syms in KERNEL_SYMBOLS.items()}
    ranked = sorted(per_name.items(), key=lambda kv: kv[1][1],
                    reverse=True)[:top]
    annotated = {}
    for name, sp in spans.items():
        sp.sort()
        starts = [a for a, _, _ in sp]
        dev_ns = 0
        for e in device:
            thread, at = ops.get(e.linked_correlation_id(), (None, None))
            i = -1 if at is None else bisect.bisect_right(starts, at) - 1
            if i >= 0 and at <= sp[i][1] and thread == sp[i][2]:
                dev_ns += e.duration_ns()
        annotated[name] = {"count": len(sp), "device_ms": dev_ns / 1e6,
                           "host_ms": sum(b - a for a, b, _ in sp) / 1e6}
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / wall_ms,
            "kernels": sum(n for n, _ in per_name.values()),
            **{f"{name}_device_ms": ms for name, ms in ours.items()},
            "top_kernels": [{"name": key[:60], "count": n,
                             "device_ms": ns / 1e6}
                            for key, (n, ns) in ranked],
            **({"annotated": annotated} if annotations else {}),
            "summary_s": time.perf_counter() - t0}


def _flip(torch, np, engine, prompt, serve_toks, gen_toks, cache_T, rid,
          names=("serve", "generate"), tie=0.0, extra=None):
    """Where two token streams first part: the position, both tokens, and
    the top-2 margin of a fresh single-request prefill of the prompt plus
    the shared prefix (with the request's ``extra`` prefill inputs, grown
    over the prefix: ``_grow_extra``).  It is a near-tie when both tokens' logits lie
    within 4 bf16 units in the last place (at the top logit's magnitude),
    or within ``tie`` if that is larger, of the top logit.  ``names``
    label the two streams."""
    j = next((k for k in range(min(len(serve_toks), len(gen_toks)))
              if serve_toks[k] != gen_toks[k]), None)
    if j is None:       # one stream ends early: no token to compare
        return {"request": rid, "lengths": [len(serve_toks), len(gen_toks)],
                "near_tie": False}
    seq = np.concatenate([prompt, np.asarray(serve_toks[:j], np.int32)])
    logits, _ = engine.executor.prefill(
        {"tokens": seq[None], **_grow_extra(np, extra, len(seq))}, cache_T)
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


def time_chain(torch, flush, gen, m, kn, library=False, approx=False):
    """Calls of the BitParticle matmul (exact, or with ``approx`` the
    approximate mode; fused dequant) at M = m, one per (K, N) of ``kn``,
    timed back to back in this run beside the plain version and the bound:
    (ms, plain_ms, bound_ms, bound_by, max_abs_err, library).  The calls
    are one dependent chain on the main path, so their bound is the sum of
    theirs.  With ``library``, also the same chain of ``torch._int_mm``
    calls in each weight layout ({layout: ms}; empty where it refuses a
    shape)."""
    from repro_torch.kernels.bitparticle_matmul.ops import bp_matmul
    cases = [_rand_case(torch, gen, m, k, n) for k, n in kn]
    err = 0.0
    for a, w, sa, sw in cases:
        d = bp_matmul(a, w, sa, sw, approx=approx, backend="kernel") - \
            bp_matmul(a, w, sa, sw, approx=approx, backend="plain")
        err = max(err, d.abs().max().item())

    def run(backend):
        return lambda: [bp_matmul(a, w, sa, sw, approx=approx,
                                  backend=backend)
                        for a, w, sa, sw in cases]

    ms = time_ms(torch, run("kernel"), flush)
    plain_ms = time_ms(torch, run("plain"), flush, iters=10)
    bounds = [matmul_bound(m, k, n, approx) for k, n in kn]
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
    projections and its lm_head, each MoE model's five per-layer calls
    (q, k, v, o, router), its router alone and its lm_head, and each new
    family's repeating unit (``family_layer_kn``) and lm head, at the same
    M, each timed in this run beside the plain version and the bound."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    ms, plain_ms, bound_ms, bound_by, err, _ = time_chain(
        torch, flush, gen, n_slots, QWEN_LAYER_KN)
    extra = {}
    from repro_torch.configs.base import get_arch
    further = []
    for arch in MOE_SERVES:
        cfg = get_arch(arch)
        key = arch.replace("-", "_")
        d, hd = cfg.d_model, cfg.resolved_head_dim
        q, kv = (d, cfg.num_heads * hd), (d, cfg.num_kv_heads * hd)
        further += [(f"{key}_layer", (q, kv, kv, q[::-1],
                                      (d, cfg.num_experts))),
                    (f"{key}_router", ((d, cfg.num_experts),)),
                    (f"{key}_lm_head", ((d, cfg.vocab_padded),))]
    for arch in NEW_CONFIGS:
        cfg = get_arch(arch)
        key = arch.replace("-", "_").replace(".", "_")
        further += [(f"{key}_{'superblock' if cfg.attn_every else 'layer'}",
                     family_layer_kn(cfg)),
                    (f"{key}_lm_head", ((cfg.d_model, cfg.vocab_padded),))]
    for name, kn in (("rwkv6_7b_layer", RWKV_LAYER_KN),
                     ("rwkv6_7b_lm_head", ((4096, 65536),)), *further):
        r_ms, r_plain, r_bound, r_by, r_err, _ = time_chain(
            torch, flush, gen, n_slots, kn)
        err = max(err, r_err)
        extra[name] = {"kn": [list(x) for x in kn], "ms": r_ms,
                       "plain_ms": r_plain, "bound_ms": r_bound,
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


def prefill_layer_summary(torch, flush, qwen_m, rwkv_m, launches,
                          family_m=None):
    """The kernels line's numbers for bp_matmul's prefill tile kernel: the
    seven projections of one qwen2-1.5b decoder layer at the main path's
    most frequent prefill row count, and beside them one rwkv6-7b layer's
    at its serve's and each new family's repeating unit at its serve's
    (``family_m``: {arch: rows}; seamless's encoder layer at its source
    rows), each timed in this run beside the plain version, the
    bound and the same chain of ``torch._int_mm`` calls (the faster weight
    layout is ``library_ms``)."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    ms, plain_ms, bound_ms, bound_by, err, lib = time_chain(
        torch, flush, gen, qwen_m, QWEN_LAYER_KN, library=True)
    r_ms, r_plain, r_bound, r_by, r_err, r_lib = time_chain(
        torch, flush, gen, rwkv_m, RWKV_LAYER_KN, library=True)
    from repro_torch.configs.base import get_arch
    extra = {}
    for arch, m in (family_m or {}).items():
        cfg = get_arch(arch)
        kn = family_layer_kn(cfg, encoder=True)
        f_ms, f_plain, f_bound, f_by, f_err, f_lib = time_chain(
            torch, flush, gen, m, kn, library=True)
        err = max(err, f_err)
        extra[arch.replace("-", "_").replace(".", "_") + "_unit"] = {
            "m": m, "kn": [list(x) for x in kn], "ms": f_ms,
            "plain_ms": f_plain, "bound_ms": f_bound, "bound_by": f_by,
            "max_abs_err": f_err, "library_ms_by_layout": f_lib}
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
                               "library_ms_by_layout": r_lib},
            **extra}


def paged_layer_summary(torch, flush, paged_shape, launches, moe_shapes):
    """The kernels line's numbers for paged attention: one decoder layer's
    call at the paged serve's decode shape (its slots, table width and the
    per-slot positions of its median full-batch step), timed in this run
    beside the plain version, the library yardstick and the bound; beside
    it the same at each further paged serve's decode shape
    (``moe_shapes``: the MoE serves' and ``serve_vlm``'s)."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    lengths = paged_shape["lengths"]
    row = time_paged_case(torch, flush, gen, len(lengths), lengths,
                          pps=paged_shape["pages_per_seq"])
    extra = {}
    for name, sh in moe_shapes.items():
        r = time_paged_case(torch, flush, gen, len(sh["lengths"]),
                            sh["lengths"], pps=sh["pages_per_seq"],
                            dims=sh["dims"])
        extra[name] = {k: r[k] for k in (
            "H", "KH", "D", "lengths", "pages_per_seq", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "max_abs_err")}
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
                     f"on K/V gathered dense beforehand",
            **extra}


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
    ap.add_argument("--train-dist", default=None, metavar="PATH",
                    help="instead of the smoke test, build the kernels and "
                         "run the train_dist phase alone, writing its "
                         "record to this JSON file")
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
    if not ((ROOT / "src" / "repro_torch").is_dir()
            and (ROOT / "examples_torch").is_dir()):
        print(f"chip_smoke: no src/repro_torch and examples_torch beside "
              f"{__file__}; run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT / "examples_torch"))

    smi = nvidia_smi_line()
    gpu = {"name": torch.cuda.get_device_name(0), "nvidia_smi": smi,
           "sm_clock_mhz": float(nvidia_smi("clocks.max.sm", "nounits"))}
    if args.tile_sweep or args.wkv_time or args.train_dist:
        try:
            if args.tile_sweep:
                tile_sweep(torch, gpu, args.tile_sweep)
            elif args.wkv_time:
                wkv_time(torch, gpu, args.wkv_time)
            else:
                phase_device(torch, gpu)
                dist, _ = phase_train_dist(torch, gpu)
                path = pathlib.Path(args.train_dist)
                path.parent.mkdir(parents=True, exist_ok=True)
                path.write_text(json.dumps({"gpu": gpu, "train_dist": dist},
                                           indent=1))
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
        timed, verify_rows, train_row = phase_kernel_time(torch, gpu, flush)
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
        mesh_rec, mesh_launches = phase_serve_mesh(
            torch, gpu, model, paged, paged_toks, serve, serve_toks)
        records.append({"serve_mesh": mesh_rec})
        modes, modes_launches = phase_serve_modes(torch, gpu, model, flush)
        records.append({"serve_modes": modes})
        examples, examples_launches = phase_examples(torch, gpu)
        records.append({"examples": examples})
        del model
        rwkv = build_rwkv(torch)
        serve_rwkv, rwkv_launches, rwkv_shape = phase_serve_rwkv(
            torch, gpu, rwkv)
        records.append({"serve_rwkv": serve_rwkv})
        del rwkv
        torch.cuda.empty_cache()
        moe, moe_launches, moe_shapes = phase_serve_moe(torch, gpu, paged)
        records.append({"serve_moe": moe})
        fam, fam_launches, fam_shapes = phase_serve_families(torch, gpu,
                                                             paged)
        records.extend({ph: rec} for ph, rec in fam.items())
        train, train_launches = phase_train(torch, gpu)
        records.append({"train": train})
        dist, dist_launches = phase_train_dist(torch, gpu)
        records.append({"train_dist": dist})
        bp = decode_layer_summary(torch, flush, serve["n_slots"], launches)
        tile = prefill_layer_summary(
            torch, flush, launches["prefill_rows"],
            rwkv_launches["prefill_rows"], launches,
            family_m={name: fam_launches[spec["phase"]]["prefill_rows"]
                      for name, spec in FAMILY_SERVES.items()})
        tile["qwen2_verify_layer"] = verify_rows
        tile["qwen2_train_layer"] = train_row
        paths = {"serve": launches, "serve_paged": paged_launches,
                 "serve_spec": spec_launches,
                 "serve_chunked": chunked_launches,
                 "serve_probe": probe_launches,
                 "serve_chaos": chaos_launches,
                 "serve_frontdoor": door_launches,
                 "serve_mesh": mesh_launches,
                 "serve_modes": modes_launches,
                 "examples": examples_launches,
                 "serve_rwkv": rwkv_launches,
                 "serve_moe": moe_launches["moonshot-v1-16b-a3b"],
                 "serve_moe_granite": moe_launches["granite-moe-1b-a400m"],
                 **fam_launches, "train": train_launches,
                 "train_dist": dist_launches}
        pa = paged_layer_summary(
            torch, flush, paged_shape, paged_launches,
            {**moe_shapes, "qwen2-vl-7b": fam_shapes["serve_vlm"]})
        pas = state_layer_summary(torch, flush, mesh_launches["state_shape"],
                                  mesh_launches)
        for entry, key in ((bp, "bp_matmul_gemv"), (tile, "bp_matmul_tile"),
                           (pa, "paged_attention"),
                           (pas, "paged_attention_state")):
            entry["launches_by_path"] = {p: c.get(key, 0)
                                         for p, c in paths.items()}
        wk = wkv6_summary(torch, flush, gpu, rwkv_shape, rwkv_launches)
        summary = [bp, tile, pa, pas, wk]
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
            {"gpu": gpu, "records": records, "kernels": summary,
             "phase_elapsed_s": _ELAPSED},
            indent=1))
    emit({"kernels": summary})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
