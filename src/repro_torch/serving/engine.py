"""Serving engine: static batched generation + quasi-sync continuous batching
(port of ``repro/serving/engine.py``, slab and paged slices), for the dense,
mixture-of-experts and vision-language families (slab or paged store) and
the RWKV-6, hybrid and encoder-decoder families (slab store: recurrent
state has no sequence axis to page, and the cross K/V is not paged).

  * ``generate(batch)`` — the static path: one prefill, then the whole batch
    decodes in lock-step, ``decode_chunk`` tokens per executor call, with
    EOS early exit at chunk boundaries.
  * ``serve(requests)`` — continuous batching over a slot pool: finished
    sequences are evicted mid-flight and waiting requests are admitted into
    freed slots under the ``QuasiSyncScheduler``'s bounded lead window.  The
    decode cache is a slab (``cache_backend="slab"``) or block-paged
    (``"paged"``: blocks on demand, prefix sharing, copy-on-write, and
    preempt-and-replay when the pool runs dry).  Greedy outputs are
    token-identical to the static path and across the two stores.
  * per-request ``extras`` (``serve(..., extras={request_id: {...}})``):
    prefill inputs beside the tokens, stacked on a leading batch axis per
    admission group: the VLM family's ``vision_embeds`` and
    ``vision_mask``, the audio family's ``src_embeds``.  Such groups are
    exact-length, and on the paged store such requests keep their blocks
    out of the prefix trie (their K/V depends on more than the tokens).
  * speculative decoding (``draft="prompt_lookup"`` or ``"model"``) and
    chunked prefill (``prefill_chunk``) ride the multi-token verify step
    (``ServeLoop.decode_once_spec``), attention-KV families only, greedy
    only; both leave the greedy streams unchanged.

The engine is host-side orchestration; device work goes through
``serving/executor.py``.  In a ``bp_*`` matmul mode the engine quantizes
every dense weight to int8 + per-channel scale once, at construction.

Observability: a ``Telemetry`` handle (``ServeConfig.telemetry``) writes
the step records as JSONL, the spans as a Chrome trace and, with
``profile_dir``, a ``torch.profiler`` trace per serve; the report is a pure
fold of the records.  The model's spans inside a prefill get their
device time after the prefill's synchronize; each step record counts the
K1 and K2 launches since the previous one.  A ``SparsityProbe``
(``ServeConfig.probe``, dense or MoE family in a bp_* mode) runs probed
steps that measure the int8 activations' bit and value sparsity on the
device, and prices each sample through the paper's cost models into an
``hw_estimate`` record
(``ServeReport.hw_measured``); ``ServeReport.deployment`` prices the int8
weights alone.

Robustness: a ``FaultInjector`` (``ServeConfig.faults``) fires seeded
faults at the reference's sites, checked in the reference's order, so one
seed replays the same schedule in both.  Every device dispatch runs behind
``ServeLoop._dispatch``: immediate bounded retry of injected transients,
other failures wrapped into ``StepFault``, and with ``step_timeout_s`` a
wall-clock watchdog.  A failure that escapes is recovered by
rebuild-and-replay (``ServeLoop.recover``: every active request preempted
for token-exact replay, a fresh store), within ``max_recoveries``; past it
every in-flight request fails and the serve returns.  The degradation
ladder's rungs: repeated drafter faults disable speculation, repeated
recoveries from injected faults move the serve's kernels to their plain
versions (``degrade`` record ``action="plain_fallback"``, the reference's
``"xla_fallback"``), and sustained pool pressure halves the lead window.

A kernel fault is never recovered and never hidden: a hand-written
kernel's own error (``KernelError``: a failed launch, or the kernel asked
for where it cannot run) and a CUDA runtime error (``AcceleratorError``,
which poisons the context) raise out of the serve.  So the kernel rung
fires only on injected faults, where chaos testing schedules it, and it
holds for the rest of its serve alone: the loop takes a copy of the
executor on the plain backend, and the engine's executor, with every later
serve of the engine, keeps the engine's backend.

Mesh serving: ``ServeConfig.mesh_shape`` builds a ``MeshExecutor`` over
that many CUDA devices; a mesh over other devices (several shards on one
card, or the CPU) comes in as an injected ``executor=``.  The host loop is
the same for both executors, and the report and the ``run`` record carry
the executor's mesh shape.
"""

from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.core import cost_model as cost
from repro_torch.core.sparsity import per_layer_counts, sm_bit_counts
from repro_torch.device import resolve_device
from repro_torch.kernels.bitparticle_matmul import ops as k1_ops
from repro_torch.kernels.build import KernelError
from repro_torch.kernels.paged_attention import ops as k2_ops
from repro_torch.models import api
from repro_torch.models.layers import quantize_dense_params
from repro_torch.serving.block_pool import NoFreeBlocks, PagedCacheManager
from repro_torch.serving.cache_manager import make_cache_manager
from repro_torch.serving.executor import (SingleDeviceExecutor,
                                          make_executor, sample_seed,
                                          sample_tokens)
from repro_torch.serving.faults import (NULL_INJECTOR, DrafterFault,
                                        FaultInjector, InjectedFault,
                                        StepFault, StepTimeout)
from repro_torch.serving.probe import (NULL_PROBE, SparsityProbe,
                                       int8_leaves, per_layer_weight_stats,
                                       probe_supported)
from repro_torch.serving.queue import Request, RequestQueue, RequestState
from repro_torch.serving.scheduler import (QuasiSyncScheduler,
                                           SchedulerConfig,
                                           prefill_bucket_len)
from repro_torch.serving.speculative import make_drafter
from repro_torch.serving.telemetry import (SCHEMA_VERSION, Telemetry,
                                           percentiles, reduce_stream)

#: errors the serve loop survives via rebuild-and-replay recovery: injected
#: faults that exhausted their retry budget, watchdog aborts, and wrapped
#: real executor failures.  Everything else (config/user errors) raises.
RECOVERABLE_ERRORS = (InjectedFault, StepTimeout, StepFault)

#: errors of the kernels and the device that no recovery may hide: a
#: kernel's own failure, and a CUDA runtime error (sticky: every later call
#: on the context fails too)
KERNEL_ERRORS = (KernelError,) + ((torch.AcceleratorError,)
                                  if hasattr(torch, "AcceleratorError")
                                  else ())

#: consecutive drafter faults before the drafter rung disables speculation
DRAFTER_FAULT_LIMIT = 2


@dataclasses.dataclass
class ServeConfig:
    max_new_tokens: int = 32
    temperature: float = 0.0          # 0 => greedy
    eos_id: Optional[int] = None
    cache_margin: int = 8             # extra cache slots beyond prompt+new
    decode_chunk: int = 8             # tokens per static-path decode call
    # decode-cache backing store: "slab" reserves a worst-case cache_T
    # region per slot; "paged" allocates fixed-size KV blocks on demand
    # with prefix sharing + copy-on-write
    cache_backend: str = "slab"
    block_size: int = 16              # tokens per KV block (paged backend)
    # preemptions between ladder checks before the lead window is halved
    # (sustained pool pressure; 0 disables the rung)
    pool_pressure_limit: int = 8
    # chunked prefill: a prompt longer than ``prefill_chunk`` is admitted
    # on its first chunk only; the rest rides the multi-token verify step,
    # at most ``prefill_chunk`` prompt tokens per slot and step, beside
    # every other slot's decode.  Greedy-only; None = one-shot prefill
    prefill_chunk: Optional[int] = None
    # speculative decoding: "none" | "prompt_lookup" (weight-free n-gram
    # drafter) | "model" (a same-family draft model: pass draft_cfg /
    # draft_params to the engine).  Greedy-only
    draft: str = "none"
    num_draft_tokens: int = 4         # K: drafts verified per step
    telemetry: Optional[Telemetry] = None
    # hardware-cost observability: a ``SparsityProbe``; None = NULL_PROBE
    # (no probed step runs)
    probe: Optional[SparsityProbe] = None
    # fault injection: a ``FaultInjector`` threaded to the executor, the
    # cache managers, the block pool and the drafter like the telemetry
    # handle; None = the no-op NULL_INJECTOR
    faults: Optional[FaultInjector] = None
    # bounded, immediate retry on transient (injected) step faults
    max_step_retries: int = 2
    # rebuild-and-replay recoveries allowed per serve before the loop fails
    # every in-flight request and returns
    max_recoveries: int = 3
    # wall-clock watchdog: abort any single dispatch exceeding this budget
    # (None = no watchdog; the aborted step recovers like a failed one)
    step_timeout_s: Optional[float] = None
    # degradation ladder's kernel rung: recoveries from injected faults
    # before the serve's kernels move to their plain versions (0 disables
    # it; a real kernel fault raises instead)
    kernel_fault_limit: int = 2
    # (data, model) mesh shape for tensor-parallel serving over the first
    # prod(mesh_shape) CUDA devices; None = one device
    mesh_shape: Optional[Tuple[int, int]] = None


def check_family(arch_cfg, serve_cfg: ServeConfig) -> None:
    """Refuse a family that is not ported (``NotImplementedError``, from
    ``api``), and what a ported family cannot do, as the reference does:
    the multi-token verify step (speculative decoding, chunked prefill)
    needs position-indexed KV that can be rewound."""
    if api.supports_verify(arch_cfg):
        return
    if serve_cfg.draft != "none":
        api.verify_module(arch_cfg)       # raises the family's refusal
    if serve_cfg.prefill_chunk is not None:
        raise ValueError(
            f"family {arch_cfg.family!r} has no multi-token verify path: "
            f"chunked prefill feeds prompt chunks through verify_step; "
            f"serve with prefill_chunk=None")


def tokens_per_second(n_tokens: int, decode_s: float, prefill_s: float = 0.0,
                      steps: Optional[int] = None) -> float:
    """Tokens over decode wall time — or over total wall time when no decode
    step ran (everything finished at prefill)."""
    if steps == 0:
        return n_tokens / max(prefill_s + decode_s, 1e-9)
    return n_tokens / max(decode_s, 1e-9)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _launches() -> Tuple[int, int]:
    """(K1, K2) launches so far in this process (K2: both variants)."""
    return (k1_ops.LAUNCHES["bp_matmul"],
            k2_ops.LAUNCHES["paged_attention"]
            + k2_ops.LAUNCHES["paged_attention_state"])


@dataclasses.dataclass
class GenerationResult:
    tokens: np.ndarray                # (B, <=max_new_tokens)
    prefill_s: float
    decode_s: float
    steps: int

    @property
    def decode_tokens_per_s(self) -> float:
        n = self.tokens.shape[0] * self.tokens.shape[1]
        return tokens_per_second(n, self.decode_s, self.prefill_s,
                                 self.steps)


@dataclasses.dataclass
class RequestResult:
    request_id: int
    tokens: np.ndarray                # generated tokens (incl. EOS if hit)
    prompt_len: int
    arrival_time: float
    ttft_steps: Optional[float]       # decode-step clock
    latency_steps: Optional[float]
    finish_reason: str
    ttft_wall_s: Optional[float] = None   # wall clock, queue entry -> tok 0


@dataclasses.dataclass
class ServeReport:
    results: List[RequestResult]
    prefill_s: float
    decode_s: float
    steps: int                        # batched decode steps executed
    n_syncs: int                      # admission (prefill) syncs
    n_rejected: int
    total_new_tokens: int
    slot_utilization: float           # mean occupied-slot fraction per step
    max_divergence: int               # max spread of per-slot positions
    deployment: Optional[dict] = None # BitParticle per-layer cycle/energy
    cache_backend: str = "slab"
    n_preemptions: int = 0            # paged: requests requeued on pool-dry
    prefix_hit_blocks: int = 0        # paged: trie hits adopted by reference
    cow_blocks: int = 0               # paged: copy-on-write block copies
    peak_blocks_in_use: int = 0       # paged: max live blocks at any step
    peak_active_slots: int = 0
    mesh_shape: Optional[Tuple[int, int]] = None
    # speculative decoding (draft != "none")
    draft: str = "none"
    drafted_tokens: int = 0           # drafts submitted to verify steps
    accepted_tokens: int = 0          # drafts the target's argmax confirmed
    committed_tokens_per_step: float = 0.0
    ttft_wall: Optional[Dict[str, float]] = None
    itl_wall: Optional[Dict[str, float]] = None
    queue_wait: Optional[Dict[str, float]] = None
    slo_classes: Optional[Dict[str, dict]] = None
    n_cancelled: int = 0
    n_timed_out: int = 0
    n_failed: int = 0
    # chunked prefill: prompt tokens ingested through chunk steps
    chunk_tokens: int = 0
    # fault ledger: fault records (injected + detected), retries,
    # degradation-ladder transitions, rebuild-and-replay recoveries
    n_faults: int = 0
    n_injected_faults: int = 0
    n_retries: int = 0
    n_degrades: int = 0
    n_recoveries: int = 0
    # hardware-cost probe: measured-traffic means over the run's
    # ``hw_estimate`` records (None when the probe was off or never
    # sampled); ``deployment`` is the static weights-only estimate
    hw_measured: Optional[dict] = None

    @property
    def acceptance_rate(self) -> float:
        """Fraction of drafted tokens the verify step accepted."""
        if self.drafted_tokens == 0:
            return 0.0
        return self.accepted_tokens / self.drafted_tokens

    @property
    def decode_tokens_per_s(self) -> float:
        return tokens_per_second(self.total_new_tokens, self.decode_s,
                                 self.prefill_s, self.steps)


class ServeLoop:
    """Host-side orchestration state of ONE ``serve()`` call: arrival
    submission, cancellation and deadline sweeps, admission, decode
    stepping and the report.  Device work goes through ``self.executor``:
    the engine's executor, or after the kernel rung this loop's copy of it
    on the plain backend."""

    def __init__(self, engine: "ServingEngine", requests: Sequence[Request],
                 *, n_slots: int = 8, cache_T: Optional[int] = None,
                 sched_cfg: Optional[SchedulerConfig] = None,
                 extras: Optional[Dict[int, dict]] = None,
                 num_blocks: Optional[int] = None):
        self.engine = engine
        self.executor: SingleDeviceExecutor = engine.executor
        self.serve_cfg = engine.serve_cfg
        self.tel: Telemetry = (self.serve_cfg.telemetry
                               if self.serve_cfg.telemetry is not None
                               else Telemetry())
        engine.executor.set_telemetry(self.tel)
        if engine.draft_executor is not None:
            engine.draft_executor.set_telemetry(self.tel)
        # the sparsity probe: validated up front so a misconfigured probe
        # fails at loop construction, not at the first probed step
        self.probe: SparsityProbe = (self.serve_cfg.probe
                                     if self.serve_cfg.probe is not None
                                     else NULL_PROBE)
        if self.probe.enabled and not probe_supported(engine.cfg):
            raise ValueError(
                f"ServeConfig.probe: sparsity probe unsupported for "
                f"family={engine.cfg.family!r} "
                f"matmul_mode={engine.cfg.matmul_mode!r} (needs a causal-LM "
                f"family in bp_exact/bp_approx mode)")
        # the weights' bit sparsity is static during a serve (computed
        # once per engine)
        self._weight_profile = (engine.weight_sparsity_profile()
                                if self.probe.enabled else None)
        # cost hint: running mean of modeled BitParticle array cycles per
        # processed token over the probe's samples (0.0 before the first)
        self._hw_cycles_sum = 0.0
        self._hw_tokens_sum = 0
        # the in-memory step-record stream: report() is a pure fold over it
        self.stream: List[dict] = []
        self._wall0 = time.perf_counter()
        self._h2d_mark = int(self.tel.counters.get("h2d_bytes", 0))
        self._d2h_mark = int(self.tel.counters.get("d2h_bytes", 0))
        self._launch_mark = _launches()
        # fault injection rides the config like telemetry; the executor
        # gets the handle before any cache op can fire a check
        self.faults: FaultInjector = (self.serve_cfg.faults
                                      if self.serve_cfg.faults is not None
                                      else NULL_INJECTOR)
        self.faults.bind(self._emit_injected)
        engine.executor.set_faults(self.faults)
        requests = sorted(requests,
                          key=lambda r: (r.arrival_time, r.request_id))
        self.requests = list(requests)
        if cache_T is None:
            need = [r.prompt_len + r.max_new_tokens for r in requests] or [1]
            cache_T = max(need) + self.serve_cfg.cache_margin
        # chunked prefill: validate up front so a misconfigured loop fails
        # at construction, not at the first long prompt
        self.prefill_chunk = self.serve_cfg.prefill_chunk
        if self.prefill_chunk is not None:
            if self.prefill_chunk < 1:
                raise ValueError("prefill_chunk must be >= 1 (or None)")
            if not api.supports_verify(engine.cfg):
                raise ValueError(
                    f"family {engine.cfg.family!r} has no multi-token "
                    f"verify path: chunked prefill feeds prompt chunks "
                    f"through verify_step; serve with prefill_chunk=None")
            if self.serve_cfg.temperature > 0:
                raise ValueError(
                    "chunked prefill is greedy-only (temperature == 0): "
                    "the final chunk's first token comes from the verify "
                    "step's fused argmax")
            if extras:
                raise ValueError(
                    "chunked prefill does not compose with per-request "
                    "extra prefill inputs (extras ride the one-shot "
                    "prefill only)")
        # request id -> extra prefill inputs (replayed prefills after a
        # preemption or a recovery carry them again)
        self.extras: Dict[int, dict] = dict(extras or {})
        # slot -> next unfed prompt position of a request mid-chunked-
        # prefill (cleared on preemption and eviction: replay restarts the
        # chunks)
        self.chunking: Dict[int, int] = {}
        # constructor arguments kept so ``recover()`` can build a fresh store
        self.n_slots = n_slots
        self._cache_T_arg = cache_T
        self._num_blocks = num_blocks
        self.cm = self._build_cm()
        self.paged = isinstance(self.cm, PagedCacheManager)
        # prefill caches must slice into whole blocks on the paged store
        self.cache_T = self.cm.prefill_T if self.paged else cache_T
        sched_cfg = sched_cfg if sched_cfg is not None else SchedulerConfig()
        if sched_cfg.prefill_bucketing is None:
            # pow2 buckets need right-padding-safe prefill: attention KV
            # without per-request extra inputs (a recurrent state would
            # integrate the padding tokens, and extras are not padded)
            ragged_ok = not (api.is_recurrent(engine.cfg) or self.extras)
            sched_cfg = dataclasses.replace(
                sched_cfg, prefill_bucketing="pow2" if ragged_ok else "exact")
        self.rq = RequestQueue(max_waiting=sched_cfg.max_waiting,
                               on_reject=self._on_reject)
        self.sched = QuasiSyncScheduler(self.rq, self.cm, sched_cfg,
                                        telemetry=self.tel)
        self.sched.prefill_chunk = self.prefill_chunk
        self.ragged = self.sched.bucketing == "pow2"
        self.arrivals = collections.deque(requests)
        self.active: Dict[int, Request] = {}      # slot -> request
        self.last_tok = np.zeros(n_slots, np.int32)
        self.slot_seeds = np.zeros(n_slots, np.int64)
        self.now = 0.0
        self.prefill_s = 0.0
        self.decode_s = 0.0
        self.n_preemptions = 0
        self._pressure_mark = 0
        self.peak_active = 0
        self._cancel_ids: Set[int] = set()
        self._any_deadlines = any(
            r.deadline_s is not None or r.ttft_deadline_s is not None
            for r in requests)
        #: optional hook called after every loop iteration
        self.on_step_end: Optional[Callable[["ServeLoop"], None]] = None
        self._inbox: List[Request] = []
        self._inbox_lock = threading.Lock()
        self._closed = False
        # recovery and degradation-ladder counters
        self.n_recoveries = 0
        self._injected_recoveries = 0
        self._drafter_faults = 0
        # the watchdog's worker thread (made on first use, replaced after a
        # timeout abandons it, shut down when the serve ends)
        self._watchdog: Optional[concurrent.futures.ThreadPoolExecutor] = None
        #: optional streaming hook: called once per FRESHLY emitted token
        #: with (request, token, index); replayed tokens after a preemption
        #: or a recovery are not sent again, so a streaming consumer sees
        #: each position exactly once
        self.on_token: Optional[Callable[[Request, int, int], None]] = None
        # speculative decoding: a drafter proposes up to K tokens per slot,
        # one multi-token verify step checks them all, and each slot
        # commits 1..K+1 tokens per step
        self.drafter = make_drafter(self.serve_cfg, engine,
                                    n_slots=n_slots, cache_T=self.cache_T,
                                    telemetry=self.tel)
        if self.drafter is not None:
            self.drafter.faults = self.faults
        self.n_drafted = 0
        self.n_accepted = 0
        self._bind_step_fns()
        self._emit("run", cache_backend=str(self.serve_cfg.cache_backend),
                   n_slots=int(n_slots), cache_T=int(self.cache_T),
                   draft=str(self.serve_cfg.draft),
                   temperature=float(self.serve_cfg.temperature),
                   mesh_shape=(None if self.executor.mesh is None else
                               list(self.executor.mesh.devices.shape)),
                   block_size=int(self.serve_cfg.block_size),
                   probe_every=int(self.probe.probe_every))

    def _build_cm(self):
        cm = make_cache_manager(self.engine.cfg, self.n_slots,
                                self._cache_T_arg,
                                backend=self.serve_cfg.cache_backend,
                                block_size=self.serve_cfg.block_size,
                                num_blocks=self._num_blocks,
                                executor=self.executor,
                                telemetry=self.tel, faults=self.faults)
        if isinstance(cm, PagedCacheManager):
            # prefix sharing keys on tokens: a request with extra prefill
            # inputs keeps its blocks out of the trie
            cm.unshared = frozenset(rid for rid, ex in self.extras.items()
                                    if ex)
        return cm

    def _bind_step_fns(self):
        """(Re-)fetch the step functions from the executor: at construction
        and after a recovery."""
        ex = self.executor
        self._decode_fn = ex.decode_sample_fn(self.serve_cfg.temperature,
                                              paged=self.paged)
        # the verify entry point serves speculation and chunked prefill
        # alike (a chunk row feeds known prompt tokens where a decode row
        # feeds drafts); it stays bound while either needs it, since the
        # ladder may drop the drafter mid-run with chunking still on
        need_verify = (self.drafter is not None
                       or self.prefill_chunk is not None)
        if need_verify:
            self._verify_fn = ex.verify_sample_fn(paged=self.paged)
        # the probed variants, swapped in on sampled steps; the unprobed
        # functions above are the ones a probe-less serve runs
        self._decode_probe_fn = self._verify_probe_fn = None
        if self.probe.enabled:
            self._decode_probe_fn = ex.decode_sample_fn(
                self.serve_cfg.temperature, paged=self.paged, probed=True)
            if need_verify:
                self._verify_probe_fn = ex.verify_sample_fn(
                    paged=self.paged, probed=True)

    # -- telemetry plumbing --------------------------------------------------

    def _emit(self, kind: str, **fields) -> dict:
        rec = {"schema": SCHEMA_VERSION, "kind": kind,
               "ts_s": time.perf_counter() - self._wall0}
        rec.update(fields)
        self.stream.append(rec)
        self.tel.emit(rec)
        return rec

    def _on_reject(self, req: Request):
        self._emit("reject", step=int(self.sched.n_decode_steps),
                   request_id=int(req.request_id))

    def _emit_injected(self, site: str, **ctx) -> None:
        """The injector's telemetry callback: every fired injection becomes
        a ``fault`` record with ``injected=True``, so the stream accounts
        for each one."""
        self._emit("fault", step=int(self.sched.n_decode_steps), site=site,
                   injected=True, **ctx)

    def _byte_deltas(self) -> Tuple[int, int]:
        c = self.tel.counters
        h2d, d2h = int(c.get("h2d_bytes", 0)), int(c.get("d2h_bytes", 0))
        out = (h2d - self._h2d_mark, d2h - self._d2h_mark)
        self._h2d_mark, self._d2h_mark = h2d, d2h
        return out

    def _launch_deltas(self) -> dict:
        """K1 and K2 launches since the previous step record."""
        (k1, k2), (m1, m2) = _launches(), self._launch_mark
        self._launch_mark = (k1, k2)
        return {"k1_launches": k1 - m1, "k2_launches": k2 - m2}

    def _pool_gauges(self) -> dict:
        """Block-pool gauges for one step record (zeros on the slab store).
        Hit/CoW/peak counters are CUMULATIVE snapshots — monotone, so the
        stream reduction recovers the totals with a running max."""
        if not self.paged:
            return {"blocks_in_use": 0, "prefix_hit_blocks": 0,
                    "cow_blocks": 0, "peak_blocks_in_use": 0}
        pool = self.cm.pool
        return {"blocks_in_use": int(pool.n_live),
                "prefix_hit_blocks": int(pool.n_prefix_hits),
                "cow_blocks": int(pool.n_cow),
                "peak_blocks_in_use": int(pool.peak_live)}

    def _fetch_stats(self, stats: list) -> Optional[np.ndarray]:
        """A probed step's ``(L[+1], N_STATS)`` stats on the host (None on
        an unprobed step, whose function returned no stats).  The array is
        the probe's only d2h traffic: counted before the step record's
        byte snapshot so that record carries it."""
        if not stats:
            return None
        arr = stats[0].cpu().numpy()
        self.tel.count("d2h_bytes", int(arr.nbytes))
        return arr

    def _emit_hw(self, stats: np.ndarray, phase: str,
                 n_tokens: int = 1) -> None:
        """Fold one sampled step's stats through the probe's cost models
        into an ``hw_estimate`` record plus Chrome-trace counter tracks.
        ``n_tokens`` is the tokens this step processed (prompt + committed
        + chunk-fed): the denominator of the cycles-per-token cost hint."""
        fields = self.probe.fold(stats, self._weight_profile, phase)
        self._hw_cycles_sum += float(fields["array_cycles_per_step"])
        self._hw_tokens_sum += max(int(n_tokens), 1)
        self._emit("hw_estimate", step=int(self.sched.n_decode_steps),
                   **fields)
        self.tel.counter("sparsity",
                         act_bit=fields["act_bit_sparsity"],
                         act_value=fields["act_value_sparsity"],
                         weight_bit=fields["weight_bit_sparsity"])
        self.tel.counter("hw_model",
                         array_utilization=fields["array_utilization"],
                         cycles_bp_exact=fields["cycles"]["bp_exact"],
                         energy_bp_exact_pj=fields["mac_energy_pj"]
                         ["bp_exact"])

    @property
    def cost_hint_cycles_per_token(self) -> float:
        """Running mean of modeled BitParticle array cycles per processed
        token over the probe's sampled steps (0.0 with no sample or the
        probe off): the per-replica cost hint a router reads."""
        if self._hw_tokens_sum == 0:
            return 0.0
        return self._hw_cycles_sum / self._hw_tokens_sum

    # -- lifecycle: cancellation + deadlines --------------------------------

    def _live_requests(self) -> List[Request]:
        """Every request still in flight: not yet submitted, waiting, or
        active in a slot."""
        return (list(self.arrivals) + list(self.rq.peek())
                + list(self.active.values()))

    def _evict(self, slot: int) -> Request:
        """Remove ``slot``'s request from the batch and release what it
        holds (cache slot or block table, chunk state, drafter state)."""
        req = self.active.pop(slot)
        self.chunking.pop(slot, None)
        self.cm.free(slot)
        if self.drafter is not None:
            self.drafter.on_free(slot)
        return req

    def sweep(self):
        """Collect injector- and API-requested cancellations and apply
        them, then expire requests whose wall-clock deadline passed;
        evicted actives free their slot now."""
        if self.faults.enabled:
            live = [int(r.request_id) for r in self._live_requests()]
            self._cancel_ids.update(self.faults.cancel_requests(live))
        pending = self.engine._pending_cancels
        if pending:
            self._cancel_ids.update(pending)
            pending.clear()
        if self._cancel_ids:
            self._apply_cancels()
        if self._any_deadlines:
            self._apply_deadlines()

    def _finish_evicted(self, req: Request, reason: str, kind: str,
                        where: str, **fields):
        req.finish(self.now, reason)
        self._emit(kind, step=int(self.sched.n_decode_steps),
                   request_id=int(req.request_id), where=where, **fields)

    def _apply_cancels(self):
        ids, self._cancel_ids = self._cancel_ids, set()
        for req in [r for r in self.arrivals if int(r.request_id) in ids]:
            self.arrivals.remove(req)
            self._finish_evicted(req, "cancelled", "cancel", "arrivals")
        for req in [r for r in self.rq.peek() if int(r.request_id) in ids]:
            self.rq.remove(req)
            self._finish_evicted(req, "cancelled", "cancel", "waiting")
        for slot in [s for s, r in self.active.items()
                     if int(r.request_id) in ids]:
            req = self._evict(slot)
            self._finish_evicted(req, "cancelled", "cancel", "active")

    def _apply_deadlines(self):
        wall = time.perf_counter()

        def expired(req: Request) -> Optional[str]:
            t0 = req.wall_submitted_at
            if t0 is None:
                return None
            if (req.ttft_deadline_s is not None
                    and req.first_token_at is None
                    and wall - t0 >= req.ttft_deadline_s):
                return "ttft"
            if req.deadline_s is not None and wall - t0 >= req.deadline_s:
                return "total"
            return None

        for req in list(self.rq.peek()):
            which = expired(req)
            if which is not None:
                self.rq.remove(req)
                self._finish_evicted(req, "timeout", "timeout", "waiting",
                                     deadline=which)
        for slot in list(self.active):
            req = self.active[slot]
            which = expired(req)
            if which is not None:
                self._evict(slot)
                self._finish_evicted(req, "timeout", "timeout", "active",
                                     deadline=which)

    # -- fault-hardened dispatch --------------------------------------------

    def _with_watchdog(self, fn):
        """Run one device dispatch under the wall-clock watchdog.  The call
        runs on the loop's worker thread, launching on the loop's current
        stream; what is timed is the host call up to its first
        synchronizing read (the sampled tokens' copy to the host for a
        decode or verify step, a device synchronize for a prefill).  Past
        the budget the loop raises :class:`StepTimeout`, abandons the
        worker to the call and recovery builds a fresh store.  The
        abandoned call runs on and writes its step into the OLD store's
        tensors, which the loop never reads again."""
        budget = self.serve_cfg.step_timeout_s
        if budget is None:
            return fn()
        dev = self.executor.device
        stream = (torch.cuda.current_stream(dev) if dev.type == "cuda"
                  else None)

        def run():
            if stream is None:
                return fn()
            with torch.cuda.stream(stream):
                return fn()

        if self._watchdog is None:
            self._watchdog = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="serve-watchdog")
        fut = self._watchdog.submit(run)
        try:
            return fut.result(timeout=budget)
        except concurrent.futures.TimeoutError:
            self._stop_watchdog()
            raise StepTimeout(
                f"step exceeded the {budget:g}s watchdog budget") from None

    def _stop_watchdog(self) -> None:
        """Let the worker thread end once its call returns; the next
        dispatch makes a new one."""
        if self._watchdog is not None:
            self._watchdog.shutdown(wait=False, cancel_futures=True)
            self._watchdog = None

    def _dispatch(self, site: str, fn):
        """Fault boundary around one device dispatch: immediate bounded
        retry on injected transients (raised before any device work, so a
        retry is safe), and other executor failures wrapped into
        :class:`StepFault` so ``run_forever`` can tell recoverable faults
        from plain bugs.  A kernel or device fault (``KERNEL_ERRORS``)
        raises as it is: no recovery may hide it."""
        attempt = 0
        while True:
            try:
                return self._with_watchdog(fn)
            except (StepTimeout,) + KERNEL_ERRORS:
                raise
            except InjectedFault as e:
                if attempt >= self.serve_cfg.max_step_retries:
                    raise
                attempt += 1
                self._emit("retry", step=int(self.sched.n_decode_steps),
                           site=str(getattr(e, "site", site)),
                           attempt=int(attempt))
            except Exception as e:
                raise StepFault(site, e) from e

    def _maybe_inject_nan(self, step: dict, slots: List[int]) -> None:
        """Chaos only: poison the logits of injector-chosen slots with NaN
        inside the step.  The mask key is added only when an injector is
        live, so a fault-free run's step is unchanged."""
        if not self.faults.enabled:
            return
        bad = self.faults.nan_slots(slots)
        if not bad:
            return
        mask = np.zeros(self.n_slots, bool)
        mask[list(bad)] = True
        step["nan_mask"] = mask

    def _fail_slot(self, slot: int):
        """The fused finite-logits guard flagged this slot (-1 sentinel):
        fail just this request and release its slot."""
        req = self._evict(slot)
        req.finish(self.now, "failed")
        self._emit("fault", step=int(self.sched.n_decode_steps),
                   site="nan_guard", request_id=int(req.request_id),
                   slot=int(slot))

    # -- admission / preemption ---------------------------------------------

    def submit_arrivals(self):
        """Move arrivals whose time has come into the waiting queue;
        requests that can never fit the cache are rejected up front."""
        while self.arrivals and self.arrivals[0].arrival_time <= self.now:
            req = self.arrivals.popleft()
            req.wall_submitted_at = time.perf_counter()
            if not self.cm.fits(req.prompt_len, req.max_new_tokens):
                self.rq.reject(req, self.now)
                continue
            self.rq.submit(req, self.now)

    def pick_victim(self) -> Optional[int]:
        """Preemption victim: the most recently admitted active request —
        it has the least progress to replay (unreferenced prefix-cache
        blocks were already reclaimed LRU-first by the pool)."""
        cands = [(req.admitted_at or 0.0, req.request_id, slot)
                 for slot, req in self.active.items()]
        if not cands:
            return None
        return max(cands)[2]

    def preempt(self, slot: int):
        """Evict ``slot``'s request back to the queue head with its
        generated tokens queued for token-exact replay."""
        req = self.active.pop(slot)
        # a mid-chunk preemption restarts chunked prefill on re-admission
        # (the emitted-token replay list still pins token identity)
        self.chunking.pop(slot, None)
        discarded = len(req.tokens)
        with self.tel.span("preempt", slot=slot,
                           request_id=req.request_id):
            self.cm.free(slot)
            if self.drafter is not None:
                self.drafter.on_free(slot)
            req.preempt()       # -> WAITING, tokens queued for replay
            self.rq.push_front(req)
        self.n_preemptions += 1
        self._emit("preempt", step=int(self.sched.n_decode_steps),
                   slot=int(slot), request_id=int(req.request_id),
                   discarded_tokens=int(discarded))
        # degradation ladder: sustained pool pressure (preemption churn)
        # halves the lead window — smaller admission bursts trade fusion
        # for fewer evictions
        lim = self.serve_cfg.pool_pressure_limit
        if (lim and self.n_preemptions - self._pressure_mark >= lim
                and self.sched.cfg.lead_window > 0):
            self._pressure_mark = self.n_preemptions
            new_e = self.sched.cfg.lead_window // 2
            self.sched.set_lead_window(new_e)
            self._emit("degrade", step=int(self.sched.n_decode_steps),
                       action="shrink_lead_window", lead_window=int(new_e))

    def insert_with_preemption(self, slot: int, cache, req: Request,
                               src_index: int,
                               length: Optional[int] = None):
        """Install a prefill cache into ``slot``, preempting actives (newest
        first) until the paged pool can cover the miss suffix.  ``length``
        is the prefilled prefix being installed (default the whole prompt;
        a chunked admission installs its first chunk only)."""
        length = req.prompt_len if length is None else length
        share = not self.extras.get(req.request_id)
        while True:
            try:
                self.cm.insert(slot, cache, length,
                               src_index=src_index,
                               tokens=req.prompt[:length], share=share)
                return
            except NoFreeBlocks as e:
                # the inserting request holds no slot entry in `active`
                # yet, so it can never preempt itself here
                victim = self.pick_victim()
                if victim is None:
                    if isinstance(e, InjectedFault):
                        # injected exhaustion with nobody to preempt is an
                        # infrastructure fault: recoverable, not a sizing
                        # bug
                        raise
                    raise RuntimeError(
                        "paged pool cannot hold a single admitted "
                        "request; increase num_blocks")
                self.preempt(victim)

    def admit(self, group: List[Request], new_sync: bool = True):
        """Fused prefill of one admission group: run the prompts, sample
        (or replay) each request's first token, install survivors.  Under
        chunked prefill a long prompt is admitted on its first chunk only:
        it emits no token here and stays PREFILL while the rest of its
        prompt rides the verify steps."""
        engine = self.engine
        t_start = time.perf_counter()
        for req in group:
            req.transition(RequestState.PREFILL)
            req.admitted_at = self.now
            if req.wall_admitted_at is None:
                req.wall_admitted_at = t_start
        chunk = self.prefill_chunk
        eff = [r.prompt_len if chunk is None else min(r.prompt_len, chunk)
               for r in group]
        lens = np.asarray(eff, np.int32)
        pad_to = (prefill_bucket_len(int(lens.max()), self.cm.cache_T)
                  if self.ragged else int(lens.max()))
        toks = np.zeros((len(group), pad_to), np.int32)
        for j, r in enumerate(group):
            toks[j, :eff[j]] = r.prompt[:eff[j]]
        batch = {"tokens": toks, **self.group_extras(group)}
        probed = self.probe.enabled   # every admission prefill is sampled
        t0 = time.perf_counter()

        def dispatch():
            out = self.executor.prefill(
                batch, self.cache_T,
                prompt_lens=lens if self.ragged else None,
                **({"probed": True} if probed else {}))
            _sync(self.executor.device)
            self.tel.resolve_device_spans()
            return out

        with self.tel.span("prefill", group_size=len(group), pad_to=pad_to,
                           prompt_tokens=int(lens.sum())):
            logits, cache, *stats = self._dispatch("prefill", dispatch)
        wall = time.perf_counter()
        dispatch_s = wall - t0
        self.prefill_s += dispatch_s
        t_inst = time.perf_counter()
        n_emitted = 0
        with self.tel.span("install", group_size=len(group)):
            for j, req in enumerate(group):
                chunked = eff[j] < req.prompt_len
                if not chunked:
                    if req.replay:
                        tok = req.replay.pop(0)
                    else:
                        with self.tel.span("sample"):
                            arr = engine._sample(
                                logits[j:j + 1],
                                sample_seed(req.request_id, 0))
                        self.tel.count("d2h_bytes", arr.nbytes)
                        tok = int(arr[0])
                    self._append_token(req, tok, wall)
                    n_emitted += 1
                    if req.first_token_at is None:
                        req.first_token_at = self.now
                    reason = engine._finished(req, tok)
                    if reason is not None:
                        req.finish(self.now, reason)
                        continue
                slot = self.cm.alloc()
                try:
                    self.insert_with_preemption(slot, cache, req, j,
                                                length=eff[j])
                except BaseException:
                    self.cm.free(slot)   # never leak the slot
                    raise
                req.slot = slot
                self.active[slot] = req
                if chunked:
                    # no token yet: the first comes from the FINAL chunk's
                    # argmax
                    self.chunking[slot] = eff[j]
                    continue
                req.transition(RequestState.DECODE)
                self.last_tok[slot] = tok
                self.slot_seeds[slot] = req.request_id
                if self.drafter is not None:
                    self.drafter.on_admit(slot, req)
        install_s = time.perf_counter() - t_inst
        probe_stats = self._fetch_stats(stats)
        h2d, d2h = self._byte_deltas()
        self._emit("prefill", step=int(self.sched.n_decode_steps),
                   wall_s=time.perf_counter() - t_start,
                   phases={"dispatch_s": dispatch_s,
                           "install_s": install_s},
                   group_size=int(len(group)), pad_to=int(pad_to),
                   prompt_tokens=int(lens.sum()),
                   committed_tokens=int(n_emitted),
                   new_sync=bool(new_sync),
                   active_slots=int(self.cm.n_active),
                   h2d_bytes=h2d, d2h_bytes=d2h,
                   **self._launch_deltas(), **self._pool_gauges())
        if probe_stats is not None:
            self._emit_hw(probe_stats, "prefill",
                          n_tokens=int(lens.sum()) + n_emitted)

    def group_extras(self, group: List[Request]) -> dict:
        """The admission group's extra prefill inputs (host arrays), each
        stacked on a new leading batch axis; the executor puts them on the
        device and counts their bytes as h2d traffic."""
        if not self.extras:
            return {}
        per = [self.extras.get(r.request_id) or {} for r in group]
        keys = sorted({k for ex in per for k in ex})
        if "positions" in keys:
            raise NotImplementedError(
                "M-RoPE 'positions' is (3, B, S): extras are stacked on a "
                "leading batch axis and cannot express it")
        out = {}
        for k in keys:
            missing = [r.request_id for r, ex in zip(group, per)
                       if k not in ex]
            if missing:
                raise ValueError(
                    f"prefill group mixes requests with and without extra "
                    f"input {k!r} (missing for {missing})")
            out[k] = np.stack([np.asarray(ex[k]) for ex in per])
        return out

    def _append_token(self, req: Request, tok: int, wall: float):
        """Record one emitted token with its wall-clock stamp.  Replayed
        tokens keep their original stamps and are not streamed again: a
        fresh emission also goes to the ``on_token`` hook, each position
        once."""
        req.tokens.append(tok)
        if len(req.wall_token_times) < len(req.tokens):
            req.wall_token_times.append(wall)
            n = len(req.wall_token_times)
            if n == 1:
                if req.wall_submitted_at is not None:
                    self.sched.observe_ttft(req.slo_class,
                                            wall - req.wall_submitted_at)
            else:
                self.sched.observe_itl(req.slo_class,
                                       wall - req.wall_token_times[-2])
            if self.on_token is not None:
                self.on_token(req, tok, len(req.tokens) - 1)

    # -- stepping -----------------------------------------------------------

    def writable_slots(self, counts: Optional[Dict[int, int]] = None
                       ) -> List[int]:
        """Active slots that can write this step's tokens: one per slot on
        the classic path, ``counts[slot]`` (a verify step's span) on the
        verify path.  On the paged store every slot must own writable
        blocks over its span (allocate at block boundaries, copy-on-write
        shared tails); when the pool runs dry the newest admission is
        preempted and the check retried."""
        slots = list(self.active.keys())
        if not self.paged:
            return slots
        while slots:
            spans = None if counts is None else [counts.get(s, 1)
                                                for s in slots]
            if self.cm.prepare_append(slots, spans) is None:
                return slots
            self.preempt(self.pick_victim())   # newest admission goes
            slots = list(self.active.keys())
        return slots

    def decode_once(self, slots: List[int], prepare_s: float = 0.0):
        """One batched decode step over the fixed (n_slots, ...) pool: decode
        and sampling in one executor call, only the (n_slots,) tokens come
        back to the host."""
        t_start = time.perf_counter()
        counts = np.zeros(self.n_slots, np.int64)
        for s in slots:
            counts[s] = len(self.active[s].tokens)
        step = {"tokens": self.last_tok[:, None],
                "cache_len": self.cm.cache_len_vector()}
        if self.paged:
            step["block_tables"] = self.cm.block_tables_device()
        self._maybe_inject_nan(step, slots)
        self.tel.count("h2d_bytes", int(self.slot_seeds.nbytes)
                       + int(counts.nbytes))
        probed = self.probe.should_sample(int(self.sched.n_decode_steps))
        t0 = time.perf_counter()

        def dispatch():
            fn = self._decode_probe_fn if probed else self._decode_fn
            toks, new_cache, *stats = fn(self.cm.cache, step,
                                         self.slot_seeds, counts)
            # the first synchronizing read: waits for the device
            return (toks.cpu().numpy(), new_cache, *stats)

        with self.tel.span("decode", n_slots=len(slots)):
            toks_np, new_cache, *stats = self._dispatch("decode", dispatch)
        wall = time.perf_counter()
        dispatch_s = wall - t0
        self.decode_s += dispatch_s
        self.cm.update(new_cache)
        self.cm.advance(slots)
        self.sched.observe_decode_step(n_committed=len(slots))
        occupancy = self.cm.n_active / self.cm.n_slots
        divergence = int(self.cm.divergence())
        self.peak_active = max(self.peak_active, len(slots))
        self.now += 1.0
        self.tel.count("d2h_bytes", int(toks_np.nbytes))
        n_committed = 0
        t_commit = time.perf_counter()
        with self.tel.span("commit", n_slots=len(slots)):
            for slot in slots:
                req = self.active[slot]
                if req.replay:
                    tok = req.replay.pop(0)
                else:
                    tok = int(toks_np[slot])
                    if tok < 0:
                        self._fail_slot(slot)
                        continue
                self._append_token(req, tok, wall)
                self.last_tok[slot] = tok
                n_committed += 1
                reason = self.engine._finished(req, tok)
                if reason is not None:
                    del self.active[slot]
                    self.cm.free(slot)
                    req.finish(self.now, reason)
        commit_s = time.perf_counter() - t_commit
        if n_committed != len(slots):
            self.sched.n_committed_tokens -= len(slots) - n_committed
        probe_stats = self._fetch_stats(stats)
        h2d, d2h = self._byte_deltas()
        self._emit("decode", step=int(self.sched.n_decode_steps),
                   wall_s=time.perf_counter() - t_start,
                   phases={"prepare_s": float(prepare_s),
                           "dispatch_s": dispatch_s,
                           "commit_s": commit_s},
                   active_slots=int(len(slots)), n_slots=int(self.n_slots),
                   occupancy=occupancy, divergence=divergence,
                   committed_tokens=int(n_committed),
                   h2d_bytes=h2d, d2h_bytes=d2h,
                   **self._launch_deltas(), **self._pool_gauges())
        if probe_stats is not None:
            self._emit_hw(probe_stats, "decode", n_tokens=n_committed)

    def decode_once_spec(self):
        """One fused multi-token step: speculative verification and/or
        chunked prefill over ONE (n_slots, S) forward pass.

        Decode slots ride it as speculation: draft up to K tokens, verify
        them all, commit the accepted prefix plus the target's own next
        token (1..K+1 tokens per step, token-identical to classic greedy).
        Chunk slots (requests mid-chunked-prefill) feed their next <= S
        KNOWN prompt tokens instead: their K/V lands at the slot's
        positions, the mid-chunk argmaxes are ignored, and when the prompt
        is exhausted the FINAL fed position's argmax is the request's first
        generated token.  With no drafter, decode slots commit one token
        each, exactly a classic step.

        Drafts are capped by each request's remaining output budget.  S is
        K+1 for pure speculation and max(K+1, chunk) when chunk slots are
        aboard; causality makes the wider shape's extra columns inert."""
        t_start = time.perf_counter()
        # the drafter may be disabled mid-step by the degradation ladder;
        # the slot bookkeeping below keeps using the one that drafted
        drafter = self.drafter
        K = self.serve_cfg.num_draft_tokens if drafter is not None else 0
        chunk_now = dict(self.chunking)
        S = max(K + 1, self.prefill_chunk or 0) if chunk_now else K + 1
        slots = list(self.active.keys())
        dec = [s for s in slots if s not in chunk_now]
        caps = {s: max(min(K, self.active[s].max_new_tokens
                           - len(self.active[s].tokens) - 1), 0)
                for s in dec}
        t_draft = time.perf_counter()
        drafts = {}
        with self.tel.span("draft", n_slots=len(dec)):
            if drafter is not None and any(caps.values()):
                try:
                    drafts = drafter.propose_all(
                        {s: self.active[s] for s in dec}, caps)
                    self._drafter_faults = 0
                except DrafterFault:
                    # a failed drafter costs speculation, never
                    # correctness: the step runs draft-less (one committed
                    # token per slot, exactly a classic decode)
                    drafts = {}
                    self._drafter_faults += 1
                    if self._drafter_faults >= DRAFTER_FAULT_LIMIT:
                        self.drafter = None
                        self._emit("degrade",
                                   step=int(self.sched.n_decode_steps),
                                   action="disable_speculation")
        draft_s = time.perf_counter() - t_draft
        drafts = {s: np.asarray(drafts.get(s, ()), np.int32)[:caps[s]]
                  for s in dec}
        # chunk rows: the next <= S unfed prompt tokens per chunk slot
        feeds = {s: np.asarray(self.active[s].prompt[p:p + S], np.int32)
                 for s, p in chunk_now.items()}
        # the paged store needs writable blocks over each slot's append
        # span; a preemption inside may shrink the slot set
        spans = {s: len(drafts[s]) + 1 for s in dec}
        spans.update({s: len(feeds[s]) for s in chunk_now})
        t_prep = time.perf_counter()
        slots = self.writable_slots(spans)
        prepare_s = time.perf_counter() - t_prep
        if not slots:
            return
        # a preemption evicted slots (and cleared their chunk state):
        # refresh both memberships before building rows
        live = set(slots)
        dec = [s for s in dec if s in live]
        chunk_now = {s: p for s, p in chunk_now.items() if s in live}
        toks = np.zeros((self.n_slots, S), np.int32)
        for s in dec:
            toks[s, 0] = self.last_tok[s]
            d = drafts[s]
            toks[s, 1:1 + len(d)] = d
        for s in chunk_now:
            toks[s, :len(feeds[s])] = feeds[s]
        step = {"tokens": toks, "cache_len": self.cm.cache_len_vector()}
        if self.paged:
            step["block_tables"] = self.cm.block_tables_device()
        self._maybe_inject_nan(step, slots)
        probed = self.probe.should_sample(int(self.sched.n_decode_steps))
        t0 = time.perf_counter()

        def dispatch():
            fn = self._verify_probe_fn if probed else self._verify_fn
            greedy, new_cache, *stats = fn(self.cm.cache, step)
            # the first synchronizing read: waits for the device
            return (greedy.cpu().numpy(), new_cache, *stats)

        with self.tel.span("verify", n_slots=len(slots)):
            greedy_np, new_cache, *stats = self._dispatch("verify", dispatch)
        wall = time.perf_counter()
        dispatch_s = wall - t0
        self.decode_s += dispatch_s
        self.cm.update(new_cache)
        self.tel.count("d2h_bytes", int(greedy_np.nbytes))
        drafted0, accepted0 = self.n_drafted, self.n_accepted
        commits: Dict[int, int] = {}        # cache POSITIONS advanced
        finished: Dict[int, str] = {}
        n_committed = 0                     # tokens EMITTED (decode output)
        n_chunk_fed = 0                     # prompt tokens fed (chunk rows)
        t_commit = time.perf_counter()
        with self.tel.span("commit", n_slots=len(slots)):
            for slot in slots:
                req = self.active[slot]
                if slot in chunk_now:
                    # the fed prompt tokens are ground truth, so the cache
                    # always advances by the feed span; only the FINAL
                    # chunk's last argmax is an output
                    n = len(feeds[slot])
                    commits[slot] = n
                    n_chunk_fed += n
                    new_pos = chunk_now[slot] + n
                    if new_pos < req.prompt_len:
                        self.chunking[slot] = new_pos
                        continue
                    del self.chunking[slot]
                    if req.replay:
                        tok = req.replay.pop(0)
                    else:
                        tok = int(greedy_np[slot, n - 1])
                        if tok < 0:
                            finished[slot] = "failed"
                            continue
                    self._append_token(req, tok, wall)
                    if req.first_token_at is None:
                        req.first_token_at = self.now
                    req.transition(RequestState.DECODE)
                    self.last_tok[slot] = tok
                    n_committed += 1
                    if drafter is not None:
                        drafter.on_admit(slot, req)
                    reason = self.engine._finished(req, tok)
                    if reason is not None:
                        finished[slot] = reason
                    continue
                d = drafts[slot]
                # greedy accept: drafts match the target's argmax stream up
                # to the first miss; the miss position's argmax is the
                # bonus token
                m = 1
                while m <= len(d) and greedy_np[slot, m - 1] == d[m - 1]:
                    m += 1
                self.n_drafted += len(d)
                self.n_accepted += m - 1
                appended = 0
                for j in range(m):
                    if req.replay:
                        # replay equals the greedy stream (token identity
                        # holds across preemption under speculation too)
                        tok = req.replay.pop(0)
                    else:
                        tok = int(greedy_np[slot, j])
                        if tok < 0:
                            # non-finite logits: fail this slot at the
                            # poisoned position, keep the prefix
                            finished[slot] = "failed"
                            break
                    self._append_token(req, tok, wall)
                    self.last_tok[slot] = tok
                    appended += 1
                    reason = self.engine._finished(req, tok)
                    if reason is not None:
                        finished[slot] = reason
                        break
                commits[slot] = appended
                n_committed += appended
        commit_s = time.perf_counter() - t_commit
        # commit the positions, then roll the paged store's speculative
        # tail blocks back BEFORE any slot is freed (free() releases whole
        # tables; release_tail only ever touches private draft-span blocks)
        self.cm.advance(slots, [commits[s] for s in slots])
        t_rb = time.perf_counter()
        if self.paged:
            with self.tel.span("rollback", n_slots=len(slots)):
                for slot in slots:
                    self.cm.release_tail(slot)
        rollback_s = time.perf_counter() - t_rb
        self.sched.observe_decode_step(n_committed=n_committed)
        occupancy = self.cm.n_active / self.cm.n_slots
        divergence = int(self.cm.divergence())
        self.peak_active = max(self.peak_active, len(slots))
        self.now += 1.0
        for slot in slots:
            if slot in finished:
                req = self._evict(slot)
                req.finish(self.now, finished[slot])
                if finished[slot] == "failed":
                    self._emit("fault", step=int(self.sched.n_decode_steps),
                               site="nan_guard",
                               request_id=int(req.request_id),
                               slot=int(slot))
            elif drafter is not None and slot not in chunk_now:
                # chunk slots have no drafter state to rewind: mid-chunk
                # ones were never admitted into it, just-completed ones had
                # on_admit called this step with the cache at commit length
                drafter.observe_commit(slot, int(self.cm.lengths[slot]))
        probe_stats = self._fetch_stats(stats)
        h2d, d2h = self._byte_deltas()
        self._emit("verify", step=int(self.sched.n_decode_steps),
                   wall_s=time.perf_counter() - t_start,
                   phases={"draft_s": draft_s, "prepare_s": prepare_s,
                           "dispatch_s": dispatch_s, "commit_s": commit_s,
                           "rollback_s": rollback_s},
                   active_slots=int(len(slots)), n_slots=int(self.n_slots),
                   occupancy=occupancy, divergence=divergence,
                   committed_tokens=int(n_committed),
                   chunk_tokens=int(n_chunk_fed),
                   drafted_tokens=int(self.n_drafted - drafted0),
                   accepted_tokens=int(self.n_accepted - accepted0),
                   h2d_bytes=h2d, d2h_bytes=d2h,
                   **self._launch_deltas(), **self._pool_gauges())
        if probe_stats is not None:
            self._emit_hw(probe_stats, "verify",
                          n_tokens=n_committed + n_chunk_fed)

    # -- live submission ----------------------------------------------------

    def submit(self, request: Request) -> None:
        """Thread-safe dynamic submission for :meth:`run_forever`; stamps
        ``wall_received_at``."""
        with self._inbox_lock:
            if self._closed:
                raise RuntimeError("serve loop is closed; cannot submit")
            request.wall_received_at = time.perf_counter()
            self._inbox.append(request)

    def close(self) -> None:
        """Stop accepting submissions; :meth:`run_forever` returns once
        everything already in flight drains."""
        with self._inbox_lock:
            self._closed = True

    def _drain_inbox(self) -> None:
        with self._inbox_lock:
            if not self._inbox:
                return
            fresh, self._inbox = self._inbox, []
        for req in fresh:
            if req.arrival_time <= 0.0:
                req.arrival_time = self.now
            if (req.deadline_s is not None
                    or req.ttft_deadline_s is not None):
                self._any_deadlines = True
            self.requests.append(req)
            self.arrivals.append(req)

    def run(self) -> ServeReport:
        """Drain the constructor-supplied requests (a pre-closed loop)."""
        self.close()
        return self.run_forever(poll_s=0.0)

    def run_forever(self, poll_s: float = 0.001) -> ServeReport:
        """Serve until closed AND drained.  The telemetry's profiler runs
        around the whole serve; its trace and the span trace are written
        when the serve ends, also when it raises."""
        self.tel.start_profile()
        try:
            with self.tel.span("serve"):
                self.submit_arrivals()
                while True:
                    self._drain_inbox()
                    if not (self.arrivals or len(self.rq) or self.active):
                        with self._inbox_lock:
                            done = self._closed and not self._inbox
                        if done:
                            break
                        if poll_s > 0:
                            time.sleep(poll_s)
                        continue
                    self.sweep()
                    if not (self.arrivals or len(self.rq) or self.active):
                        if self.on_step_end is not None:
                            self.on_step_end(self)
                        continue
                    try:
                        self._step()
                    except RECOVERABLE_ERRORS as e:
                        self.recover(e)
                    if self.on_step_end is not None:
                        self.on_step_end(self)
            self._emit_request_records()
            return self.report()
        finally:
            self._stop_watchdog()
            self.tel.stop_profile()
            self.tel.flush()

    def _emit_request_records(self) -> None:
        step = int(self.sched.n_decode_steps)
        for req in sorted(self.requests, key=lambda r: r.request_id):
            wt = req.wall_token_times
            queue_wait = (None if req.wall_submitted_at is None
                          or req.wall_admitted_at is None
                          else req.wall_admitted_at - req.wall_submitted_at)
            ttft_wall = (None if req.wall_submitted_at is None or not wt
                         else wt[0] - req.wall_submitted_at)
            inbox_wait = (None if req.wall_received_at is None
                          or req.wall_submitted_at is None
                          else req.wall_submitted_at - req.wall_received_at)
            self._emit("request", step=step,
                       request_id=int(req.request_id),
                       slo_class=str(req.slo_class),
                       finish_reason=req.finish_reason,
                       n_tokens=int(len(req.tokens)),
                       queue_wait_s=queue_wait,
                       ttft_wall_s=ttft_wall,
                       inbox_wait_s=inbox_wait,
                       itl_wall_s=[b - a for a, b in zip(wt, wt[1:])])

    def _step(self):
        """One loop iteration: admissions, then one batched decode (or one
        verify step, while a drafter or a chunked prefill needs it).
        Raising out of here with a recoverable error leaves no partial
        state: failed admissions are rolled back to the queue head."""
        groups = self.sched.plan_admissions()
        try:
            for gi, group in enumerate(groups):
                self.admit(group, new_sync=(gi == 0))
        except RECOVERABLE_ERRORS:
            self._rollback_admissions(groups)
            raise
        if not self.active:
            if not len(self.rq) and self.arrivals:
                # idle: jump the virtual clock to the next arrival
                self.now = max(self.now, self.arrivals[0].arrival_time)
                self.submit_arrivals()
            return
        if self.drafter is not None or self.chunking:
            self.decode_once_spec()
        else:
            t_prep = time.perf_counter()
            slots = self.writable_slots()
            prepare_s = time.perf_counter() - t_prep
            if not slots:
                return
            self.decode_once(slots, prepare_s=prepare_s)
        self.submit_arrivals()

    def _rollback_admissions(self, groups: List[List[Request]]):
        """A recoverable fault escaped mid-admission: return every
        not-yet-installed request to the queue head (tokens it already
        emitted ride the replay list), in the original admission order."""
        queued = set(map(id, self.rq.peek()))
        for group in reversed(groups):
            for req in reversed(group):
                if req.state is RequestState.PREFILL:
                    req.preempt()          # -> WAITING, tokens -> replay
                    self.rq.push_front(req)
                elif (req.state is RequestState.WAITING
                      and id(req) not in queued):
                    # WAITING and already queued happens when the faulting
                    # insert preempted a groupmate: preempt() requeued it,
                    # a second push would admit it twice
                    self.rq.push_front(req)
                # DECODE (already installed) and terminal states stay put

    # -- recovery -----------------------------------------------------------

    def recover(self, error: BaseException):
        """Rebuild-and-replay after a recoverable step failure: preempt
        every active request (token-exact replay), build a FRESH store and
        let the loop re-admit.  The old store is dropped unread, so a step
        the watchdog abandoned may still write into it.  Past
        ``max_recoveries`` the loop fails every in-flight request so the
        serve always returns.  After ``kernel_fault_limit`` recoveries from
        injected faults the rest of this serve runs the kernels' plain
        versions (the ``plain_fallback`` degrade record; the reference's
        ``xla_fallback``): the loop and its drafter take executors on the
        plain backend, and the engine's stay as they are."""
        step = int(self.sched.n_decode_steps)
        site = str(getattr(error, "site", "executor"))
        if not isinstance(error, InjectedFault):
            # injected faults were recorded when they fired; real failures
            # (StepFault, StepTimeout) get their record here
            self._emit("fault", step=step, site=site,
                       error=f"{type(error).__name__}: {error}")
        self.n_recoveries += 1
        self._injected_recoveries += isinstance(error, InjectedFault)
        if self.n_recoveries > self.serve_cfg.max_recoveries:
            self._fail_inflight(error)
            return
        with self.tel.span("recover", site=site):
            n_requeued = 0
            while self.active:
                self.preempt(self.pick_victim())
                n_requeued += 1
            lim = self.serve_cfg.kernel_fault_limit
            if (lim and self._injected_recoveries >= lim
                    and self.executor.resolved_matmul_backend != "plain"):
                self.executor = self.executor.with_matmul_backend("plain")
                if self.drafter is not None:
                    self.drafter.use_matmul_backend("plain")
                self._emit("degrade", step=step, action="plain_fallback")
            self.cm = self._build_cm()
            self.sched.cache_mgr = self.cm
            self._bind_step_fns()
        self._emit("recover", step=step, n_requeued=int(n_requeued))

    def _fail_inflight(self, error: BaseException):
        """Terminal degradation: the recovery budget is spent.  Fail every
        in-flight request (releasing all slots and blocks) so the loop
        drains and the serve returns a report instead of raising."""
        self._emit("degrade", step=int(self.sched.n_decode_steps),
                   action="abort",
                   error=f"{type(error).__name__}: {error}")
        for slot in list(self.active):
            req = self._evict(slot)
            req.finish(self.now, "failed")
        for req in self.rq.pop(len(self.rq)):
            req.finish(self.now, "failed")
        while self.arrivals:
            self.arrivals.popleft().finish(self.now, "failed")

    def report(self) -> ServeReport:
        """The report as a pure reduction over the step-record stream, plus
        the per-request results and wall-clock latency percentiles."""

        def ttft_wall(r: Request) -> Optional[float]:
            if not r.wall_token_times or r.wall_submitted_at is None:
                return None
            return r.wall_token_times[0] - r.wall_submitted_at

        results = [
            RequestResult(
                request_id=r.request_id,
                tokens=np.asarray(r.tokens, np.int64),
                prompt_len=r.prompt_len,
                arrival_time=r.arrival_time,
                ttft_steps=r.ttft,
                latency_steps=r.latency,
                finish_reason=r.finish_reason or "unknown",
                ttft_wall_s=ttft_wall(r),
            )
            for r in sorted(self.requests, key=lambda r: r.request_id)
        ]
        itl = [b - a for r in self.requests
               for a, b in zip(r.wall_token_times, r.wall_token_times[1:])]
        s = reduce_stream(self.stream)
        hw = None
        if s.n_hw_samples:
            n = s.n_hw_samples
            hw = {"n_samples": int(n),
                  "probe_every": int(self.probe.probe_every),
                  "act_bit_sparsity": s.hw_act_bit_sparsity / n,
                  "act_value_sparsity": s.hw_act_value_sparsity / n,
                  "weight_bit_sparsity": s.hw_weight_bit_sparsity / n,
                  "array_utilization": s.hw_array_utilization / n,
                  "cycles": {k: v / n for k, v in s.hw_cycles.items()},
                  "mac_energy_pj": {k: v / n for k, v
                                    in s.hw_mac_energy_pj.items()}}
        names = sorted(set(s.slo_ttft_samples) | set(s.slo_itl_samples))
        slo = ({name: {"n": len(s.slo_ttft_samples.get(name, ())),
                       "ttft_wall": percentiles(
                           s.slo_ttft_samples.get(name, ())),
                       "itl_wall": percentiles(
                           s.slo_itl_samples.get(name, ()))}
                for name in names} or None)
        return ServeReport(
            results=results,
            prefill_s=s.prefill_s,
            decode_s=s.decode_s,
            steps=s.steps,
            n_syncs=s.n_syncs,
            n_rejected=s.n_rejected,
            total_new_tokens=s.total_new_tokens,
            slot_utilization=s.slot_utilization,
            max_divergence=s.max_divergence,
            deployment=self.engine.deployment_estimate(),
            hw_measured=hw,
            cache_backend=self.serve_cfg.cache_backend,
            n_preemptions=s.n_preemptions,
            prefix_hit_blocks=s.prefix_hit_blocks,
            cow_blocks=s.cow_blocks,
            peak_blocks_in_use=s.peak_blocks_in_use,
            peak_active_slots=s.peak_active_slots,
            mesh_shape=(None if self.executor.mesh is None
                        else tuple(self.executor.mesh.devices.shape)),
            draft=self.serve_cfg.draft,
            drafted_tokens=s.drafted_tokens,
            accepted_tokens=s.accepted_tokens,
            chunk_tokens=s.chunk_tokens,
            committed_tokens_per_step=s.committed_tokens_per_step,
            ttft_wall=percentiles([ttft_wall(r) for r in self.requests]),
            itl_wall=percentiles(itl),
            queue_wait=percentiles(s.queue_wait_samples),
            slo_classes=slo,
            n_cancelled=s.n_cancelled,
            n_timed_out=s.n_timed_out,
            n_failed=sum(1 for r in results if r.finish_reason == "failed"),
            n_faults=s.n_faults,
            n_injected_faults=s.n_injected_faults,
            n_retries=s.n_retries,
            n_degrades=s.n_degrades,
            n_recoveries=s.n_recoveries,
        )


class ServingEngine:
    def __init__(self, arch_cfg, params,
                 serve_cfg: Optional[ServeConfig] = None,
                 executor: Optional[SingleDeviceExecutor] = None,
                 draft_cfg=None, draft_params=None, *, device="cuda"):
        """Build the engine on ``device`` (default the GPU; raises when
        CUDA is absent unless ``device="cpu"``).  ``params`` must already
        lie on that device.  In a bp_* mode every dense weight is quantized
        to int8 once, here (already-int8 weights pass through).
        ``draft_cfg``/``draft_params``: a same-family draft model for
        ``ServeConfig.draft == "model"``, run by a draft executor on the
        engine's device, over the target executor's mesh when it has
        one."""
        self.cfg = arch_cfg
        self.serve_cfg = ServeConfig() if serve_cfg is None else serve_cfg
        check_family(arch_cfg, self.serve_cfg)
        if executor is None:
            device = resolve_device(device)
            if arch_cfg.matmul_mode in ("bp_exact", "bp_approx"):
                with torch.no_grad():
                    params = quantize_dense_params(params)
            executor = make_executor(arch_cfg, params, device=device,
                                     mesh_shape=self.serve_cfg.mesh_shape)
        self.executor = executor
        self.device = executor.device
        self.matmul_backend = executor.matmul_backend
        self.draft_cfg = draft_cfg
        self.draft_executor: Optional[SingleDeviceExecutor] = None
        if draft_cfg is not None:
            if draft_params is None:
                raise ValueError("draft_cfg given without draft_params")
            if draft_cfg.matmul_mode in ("bp_exact", "bp_approx"):
                with torch.no_grad():
                    draft_params = quantize_dense_params(draft_params)
            self.draft_executor = make_executor(draft_cfg, draft_params,
                                                device=self.device,
                                                mesh=executor.mesh)
        self._deployment_cache: Dict[int, Optional[dict]] = {}
        self._weight_profile: Optional[dict] = None
        if (self.serve_cfg.probe is not None and self.serve_cfg.probe.enabled
                and arch_cfg.matmul_mode in ("bp_exact", "bp_approx")):
            # compute the probe's static weight factor now, so the first
            # sampled step folds without a stall
            self.weight_sparsity_profile()
        # request ids queued for cancellation (drained by the loop's sweep)
        self._pending_cancels: Set[int] = set()

    def cancel(self, request_id: int) -> None:
        """Request cancellation of an in-flight request, applied at the
        serve loop's next sweep (unknown or finished ids are ignored)."""
        self._pending_cancels.add(int(request_id))

    @property
    def params(self):
        return self.executor.params

    def _sample(self, logits: torch.Tensor, seed: int) -> np.ndarray:
        tok = sample_tokens(logits, self.serve_cfg.temperature,
                            [seed] * logits.shape[0])
        return tok.cpu().numpy()

    def _finished(self, req: Request, token: int) -> Optional[str]:
        eos = self.serve_cfg.eos_id
        if eos is not None and token == eos:
            return "eos"
        if len(req.tokens) >= req.max_new_tokens:
            return "length"
        return None

    # ------------------------------------------------------------------
    # Static path
    # ------------------------------------------------------------------

    def generate(self, batch: dict, seed: int = 0, *,
                 max_new_tokens: Optional[int] = None,
                 cache_T: Optional[int] = None) -> GenerationResult:
        """batch: {"tokens": (B, S_prompt) (host array or tensor)[,
        "vision_embeds", "vision_mask", "positions" (3, B, S),
        "src_embeds" (host arrays)]}; the whole batch goes to the
        prefill."""
        prompt = np.asarray(batch["tokens"].cpu()
                            if isinstance(batch["tokens"], torch.Tensor)
                            else batch["tokens"])
        B, S = prompt.shape
        max_new = (self.serve_cfg.max_new_tokens if max_new_tokens is None
                   else max_new_tokens)
        if max_new < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if cache_T is None:
            cache_T = S + max_new + self.serve_cfg.cache_margin
        eos = self.serve_cfg.eos_id
        temperature = self.serve_cfg.temperature
        chunk_pref = max(1, self.serve_cfg.decode_chunk)
        dev = self.device

        t0 = time.perf_counter()
        logits, cache = self.executor.prefill(dict(batch, tokens=prompt),
                                              cache_T)
        _sync(dev)
        t1 = time.perf_counter()

        tok = sample_tokens(logits, temperature,
                            [sample_seed(seed, r) for r in range(B)])
        done = torch.zeros(B, dtype=torch.bool, device=dev)
        chunks = [tok[:, None]]
        start, n_steps = 0, max_new - 1
        while start < n_steps:
            if eos is not None and bool((done | (tok == eos)).all()):
                break
            remaining = n_steps - start
            chunk = (chunk_pref if remaining >= chunk_pref
                     else 1 << (remaining.bit_length() - 1))
            scan = self.executor.decode_scan_fn(chunk, temperature, eos)
            tok, cache, done, toks = scan(tok, cache, done, seed, S + start,
                                          1 + start)
            chunks.append(toks.T)
            start += chunk
        mat = torch.cat(chunks, dim=1).cpu().numpy()
        t2 = time.perf_counter()
        if eos is not None:
            col_done = (np.cumsum(mat == eos, axis=1) > 0).all(axis=0)
            if col_done.any():
                mat = mat[:, :int(np.argmax(col_done)) + 1]
        return GenerationResult(tokens=mat, prefill_s=t1 - t0,
                                decode_s=t2 - t1, steps=mat.shape[1])

    # ------------------------------------------------------------------
    # Continuous batching
    # ------------------------------------------------------------------

    def make_loop(self, requests: Sequence[Request], *, n_slots: int = 8,
                  cache_T: Optional[int] = None,
                  sched_cfg: Optional[SchedulerConfig] = None,
                  extras: Optional[Dict[int, dict]] = None,
                  num_blocks: Optional[int] = None) -> ServeLoop:
        """Build (without running) the orchestration loop of one serve."""
        return ServeLoop(self, requests, n_slots=n_slots, cache_T=cache_T,
                         sched_cfg=sched_cfg, extras=extras,
                         num_blocks=num_blocks)

    def serve(self, requests: Sequence[Request], *, n_slots: int = 8,
              cache_T: Optional[int] = None,
              sched_cfg: Optional[SchedulerConfig] = None,
              extras: Optional[Dict[int, dict]] = None,
              num_blocks: Optional[int] = None) -> ServeReport:
        """Continuously-batched generation over a request stream;
        ``arrival_time`` is on the decode-step clock, so runs are
        deterministic and replayable.  ``extras`` maps request_id -> extra
        prefill inputs (``vision_embeds`` and ``vision_mask`` for the VLM
        family, ``src_embeds`` for the audio family), stacked on a new
        leading batch axis per admission group; M-RoPE ``positions``
        ((3, B, S)) cannot ride there and raise ``NotImplementedError``.
        On the paged store ``num_blocks`` caps the pool (default: the
        slab's footprint, plus the trash block); when it runs dry the
        newest admission is preempted and replayed token-exactly."""
        return self.make_loop(requests, n_slots=n_slots, cache_T=cache_T,
                              sched_cfg=sched_cfg, extras=extras,
                              num_blocks=num_blocks).run()

    # ------------------------------------------------------------------
    # BitParticle deployment estimate
    # ------------------------------------------------------------------

    def deployment_estimate(self, n_mc: int = 20_000) -> Optional[dict]:
        """Per-layer modeled cycles/energy of the int8 weights on the
        BitParticle array (None unless a bp_* matmul mode is active).
        Cached: it depends only on the immutable params.  A layer's bit
        sparsity is the mean of its weight matrices' (each matrix weighs
        the same); -1 is the unstacked weights (an untied lm head)."""
        mode = self.cfg.matmul_mode
        if mode not in ("bp_exact", "bp_approx"):
            return None
        if n_mc in self._deployment_cache:
            return self._deployment_cache[n_mc]
        L = self.cfg.num_layers
        per_layer_bs: Dict[int, List[float]] = {}
        for _, leaf in int8_leaves(self.params):
            stacked = leaf.ndim >= 2 and leaf.shape[0] == L
            rows = (per_layer_counts(leaf) if stacked
                    else sm_bit_counts(leaf)[None]).cpu().numpy()
            for l, (zb, n, _) in enumerate(rows):
                per_layer_bs.setdefault(l if stacked else -1, []).append(
                    float(zb) / (7.0 * max(float(n), 1.0)))
        if not per_layer_bs:
            return None
        layers = []
        for l in sorted(per_layer_bs):
            bs = float(np.mean(per_layer_bs[l]))
            layers.append({
                "layer": l,
                "bit_sparsity": bs,
                "avg_cycles_per_mac": cost.modeled_avg_cycles(mode, bs,
                                                              n=n_mc),
                "mac_energy_pj": cost.mac_energy_pj(mode, bs),
            })
        est = {
            "mode": mode,
            "per_layer": layers,
            "mean_bit_sparsity": float(
                np.mean([e["bit_sparsity"] for e in layers])),
            "mean_cycles_per_mac": float(
                np.mean([e["avg_cycles_per_mac"] for e in layers])),
            "mean_mac_energy_pj": float(
                np.mean([e["mac_energy_pj"] for e in layers])),
        }
        self._deployment_cache[n_mc] = est
        return est

    def weight_sparsity_profile(self) -> dict:
        """Element-weighted weight bit/value sparsity of the int8 params,
        once per engine (the probe's static factor).  Unlike
        ``deployment_estimate``'s per-matrix mean, these rates weight every
        int8 element equally: the reduction the probe applies to
        activations, so the two factors compare directly."""
        if self._weight_profile is None:
            stacked, tail = per_layer_weight_stats(self.params,
                                                   self.cfg.num_layers)
            rows = (stacked if tail is None
                    else np.concatenate([stacked, tail[None, :]]))
            total = rows.sum(axis=0)
            n = max(float(total[1]), 1.0)
            per_n = np.maximum(stacked[:, 1], 1.0)
            self._weight_profile = {
                "bit_sparsity": float(total[0] / (7.0 * n)),
                "value_sparsity": float(total[2] / n),
                "per_layer_bit_sparsity":
                    (stacked[:, 0] / (7.0 * per_n)).tolist(),
                "tail_bit_sparsity":
                    (None if tail is None
                     else float(tail[0] / (7.0 * max(tail[1], 1.0)))),
            }
        return self._weight_profile
