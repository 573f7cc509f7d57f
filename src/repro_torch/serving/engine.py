"""Serving engine: static batched generation + quasi-sync continuous batching
(port of ``repro/serving/engine.py``, slab slice).

  * ``generate(batch)`` — the static path: one prefill, then the whole batch
    decodes in lock-step, ``decode_chunk`` tokens per executor call, with
    EOS early exit at chunk boundaries.
  * ``serve(requests)`` — continuous batching over a slab slot pool: finished
    sequences are evicted mid-flight and waiting requests are admitted into
    freed slots under the ``QuasiSyncScheduler``'s bounded lead window.
    Greedy outputs are token-identical to the static path.

The engine is host-side orchestration; device work goes through
``serving/executor.py``.  In a ``bp_*`` matmul mode the engine quantizes
every dense weight to int8 + per-channel scale once, at construction.

Not ported yet, and refused with ``NotImplementedError`` when asked for:
the paged cache backend, speculative decoding, chunked prefill, the
sparsity probe, fault injection and its recovery / degradation ladder, mesh
serving, and telemetry sinks.  ``ServeReport.deployment`` is None until the
BitParticle cost models are ported.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.layers import quantize_dense_params
from repro_torch.serving.cache_manager import make_cache_manager
from repro_torch.serving.executor import (SingleDeviceExecutor,
                                          make_executor, sample_seed,
                                          sample_tokens)
from repro_torch.serving.queue import Request, RequestQueue, RequestState
from repro_torch.serving.scheduler import (QuasiSyncScheduler,
                                           SchedulerConfig,
                                           prefill_bucket_len)
from repro_torch.serving.telemetry import (SCHEMA_VERSION, Telemetry,
                                           percentiles, reduce_stream)


@dataclasses.dataclass
class ServeConfig:
    max_new_tokens: int = 32
    temperature: float = 0.0          # 0 => greedy
    eos_id: Optional[int] = None
    cache_margin: int = 8             # extra cache slots beyond prompt+new
    decode_chunk: int = 8             # tokens per static-path decode call
    # the fields below select features that are not ported yet; anything
    # but the default raises NotImplementedError when the engine is built
    cache_backend: str = "slab"
    mesh_shape: Optional[Tuple[int, int]] = None
    prefill_chunk: Optional[int] = None
    draft: str = "none"
    telemetry: Optional[Telemetry] = None
    probe: Optional[object] = None
    faults: Optional[object] = None


def check_ported(serve_cfg: ServeConfig) -> None:
    """Refuse every ServeConfig feature the port does not implement yet."""
    unported = []
    if serve_cfg.cache_backend != "slab":
        unported.append(f"cache_backend={serve_cfg.cache_backend!r}")
    if serve_cfg.mesh_shape is not None:
        unported.append("mesh_shape")
    if serve_cfg.prefill_chunk is not None:
        unported.append("prefill_chunk")
    if serve_cfg.draft != "none":
        unported.append(f"draft={serve_cfg.draft!r}")
    if serve_cfg.probe is not None:
        unported.append("probe")
    if serve_cfg.faults is not None:
        unported.append("faults")
    if unported:
        raise NotImplementedError(
            f"not ported yet: {', '.join(unported)}")


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
    deployment: Optional[dict] = None # None until the cost models are ported
    cache_backend: str = "slab"
    peak_active_slots: int = 0
    mesh_shape: Optional[Tuple[int, int]] = None
    committed_tokens_per_step: float = 0.0
    ttft_wall: Optional[Dict[str, float]] = None
    itl_wall: Optional[Dict[str, float]] = None
    queue_wait: Optional[Dict[str, float]] = None
    slo_classes: Optional[Dict[str, dict]] = None
    n_cancelled: int = 0
    n_timed_out: int = 0
    n_failed: int = 0

    @property
    def decode_tokens_per_s(self) -> float:
        return tokens_per_second(self.total_new_tokens, self.decode_s,
                                 self.prefill_s, self.steps)


class ServeLoop:
    """Host-side orchestration state of ONE ``serve()`` call: arrival
    submission, cancellation and deadline sweeps, admission, decode
    stepping and the report.  Device work goes through
    ``engine.executor``."""

    def __init__(self, engine: "ServingEngine", requests: Sequence[Request],
                 *, n_slots: int = 8, cache_T: Optional[int] = None,
                 sched_cfg: Optional[SchedulerConfig] = None):
        self.engine = engine
        self.executor: SingleDeviceExecutor = engine.executor
        self.serve_cfg = engine.serve_cfg
        check_ported(self.serve_cfg)
        self.tel: Telemetry = (self.serve_cfg.telemetry
                               if self.serve_cfg.telemetry is not None
                               else Telemetry())
        engine.executor.set_telemetry(self.tel)
        # the in-memory step-record stream: report() is a pure fold over it
        self.stream: List[dict] = []
        self._wall0 = time.perf_counter()
        self._h2d_mark = int(self.tel.counters.get("h2d_bytes", 0))
        self._d2h_mark = int(self.tel.counters.get("d2h_bytes", 0))
        requests = sorted(requests,
                          key=lambda r: (r.arrival_time, r.request_id))
        self.requests = list(requests)
        if cache_T is None:
            need = [r.prompt_len + r.max_new_tokens for r in requests] or [1]
            cache_T = max(need) + self.serve_cfg.cache_margin
        self.n_slots = n_slots
        self.cache_T = cache_T
        self.cm = make_cache_manager(engine.cfg, n_slots, cache_T,
                                     backend=self.serve_cfg.cache_backend,
                                     executor=engine.executor,
                                     telemetry=self.tel)
        sched_cfg = sched_cfg if sched_cfg is not None else SchedulerConfig()
        if sched_cfg.prefill_bucketing is None:
            # attention KV families are right-padding safe: pow2 buckets
            sched_cfg = dataclasses.replace(sched_cfg,
                                            prefill_bucketing="pow2")
        self.rq = RequestQueue(max_waiting=sched_cfg.max_waiting,
                               on_reject=self._on_reject)
        self.sched = QuasiSyncScheduler(self.rq, self.cm, sched_cfg,
                                        telemetry=self.tel)
        self.ragged = self.sched.bucketing == "pow2"
        self.arrivals = collections.deque(requests)
        self.active: Dict[int, Request] = {}      # slot -> request
        self.last_tok = np.zeros(n_slots, np.int32)
        self.slot_seeds = np.zeros(n_slots, np.int64)
        self.now = 0.0
        self.prefill_s = 0.0
        self.decode_s = 0.0
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
        self._decode_fn = engine.executor.decode_sample_fn(
            self.serve_cfg.temperature)
        self._emit("run", cache_backend=str(self.serve_cfg.cache_backend),
                   n_slots=int(n_slots), cache_T=int(self.cache_T),
                   draft="none",
                   temperature=float(self.serve_cfg.temperature),
                   mesh_shape=None)

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

    def _byte_deltas(self) -> Tuple[int, int]:
        c = self.tel.counters
        h2d, d2h = int(c.get("h2d_bytes", 0)), int(c.get("d2h_bytes", 0))
        out = (h2d - self._h2d_mark, d2h - self._d2h_mark)
        self._h2d_mark, self._d2h_mark = h2d, d2h
        return out

    # -- lifecycle: cancellation + deadlines --------------------------------

    def _evict(self, slot: int) -> Request:
        req = self.active.pop(slot)
        self.cm.free(slot)
        return req

    def sweep(self):
        """Apply API-requested cancellations, then expire requests whose
        wall-clock deadline passed; evicted actives free their slot now."""
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

    def _fail_slot(self, slot: int):
        """The fused finite-logits guard flagged this slot (-1 sentinel):
        fail just this request and release its slot."""
        req = self._evict(slot)
        req.finish(self.now, "failed")

    # -- admission ------------------------------------------------------------

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

    def admit(self, group: List[Request], new_sync: bool = True):
        """Fused prefill of one admission group: run the prompts, sample
        (or replay) each request's first token, install survivors."""
        engine = self.engine
        t_start = time.perf_counter()
        for req in group:
            req.transition(RequestState.PREFILL)
            req.admitted_at = self.now
            if req.wall_admitted_at is None:
                req.wall_admitted_at = t_start
        lens = np.asarray([r.prompt_len for r in group], np.int32)
        pad_to = (prefill_bucket_len(int(lens.max()), self.cm.cache_T)
                  if self.ragged else int(lens.max()))
        toks = np.zeros((len(group), pad_to), np.int32)
        for j, r in enumerate(group):
            toks[j, :r.prompt_len] = r.prompt
        t0 = time.perf_counter()
        with self.tel.span("prefill", group_size=len(group), pad_to=pad_to):
            logits, cache = self.executor.prefill(
                {"tokens": toks}, self.cache_T,
                prompt_lens=lens if self.ragged else None)
            _sync(self.executor.device)
        wall = time.perf_counter()
        dispatch_s = wall - t0
        self.prefill_s += dispatch_s
        t_inst = time.perf_counter()
        n_emitted = 0
        with self.tel.span("install", group_size=len(group)):
            for j, req in enumerate(group):
                if req.replay:
                    tok = req.replay.pop(0)
                else:
                    arr = engine._sample(logits[j:j + 1],
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
                    self.cm.insert(slot, cache, req.prompt_len, src_index=j)
                except BaseException:
                    self.cm.free(slot)   # never leak the slot
                    raise
                req.slot = slot
                self.active[slot] = req
                req.transition(RequestState.DECODE)
                self.last_tok[slot] = tok
                self.slot_seeds[slot] = req.request_id
        install_s = time.perf_counter() - t_inst
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
                   blocks_in_use=0, prefix_hit_blocks=0, cow_blocks=0,
                   peak_blocks_in_use=0)

    def _append_token(self, req: Request, tok: int, wall: float):
        """Record one emitted token with its wall-clock stamp (replayed
        tokens keep their original stamps)."""
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

    # -- stepping -----------------------------------------------------------

    def writable_slots(self) -> List[int]:
        """Active slots that can write this step's token (every one on the
        slab store)."""
        return list(self.active.keys())

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
        self.tel.count("h2d_bytes", int(self.slot_seeds.nbytes)
                       + int(counts.nbytes))
        t0 = time.perf_counter()
        with self.tel.span("decode", n_slots=len(slots)):
            toks, new_cache = self._decode_fn(self.cm.cache, step,
                                              self.slot_seeds, counts)
            toks_np = toks.cpu().numpy()     # waits for the device
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
                   blocks_in_use=0, prefix_hit_blocks=0, cow_blocks=0,
                   peak_blocks_in_use=0)

    # -- live submission ----------------------------------------------------

    def submit(self, request: Request) -> None:
        """Thread-safe dynamic submission for :meth:`run_forever`."""
        with self._inbox_lock:
            if self._closed:
                raise RuntimeError("serve loop is closed; cannot submit")
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
        """Serve until closed AND drained."""
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
                self._step()
                if self.on_step_end is not None:
                    self.on_step_end(self)
        self._emit_request_records()
        return self.report()

    def _emit_request_records(self) -> None:
        step = int(self.sched.n_decode_steps)
        for req in sorted(self.requests, key=lambda r: r.request_id):
            wt = req.wall_token_times
            queue_wait = (None if req.wall_submitted_at is None
                          or req.wall_admitted_at is None
                          else req.wall_admitted_at - req.wall_submitted_at)
            ttft_wall = (None if req.wall_submitted_at is None or not wt
                         else wt[0] - req.wall_submitted_at)
            self._emit("request", step=step,
                       request_id=int(req.request_id),
                       slo_class=str(req.slo_class),
                       finish_reason=req.finish_reason,
                       n_tokens=int(len(req.tokens)),
                       queue_wait_s=queue_wait,
                       ttft_wall_s=ttft_wall,
                       itl_wall_s=[b - a for a, b in zip(wt, wt[1:])])

    def _step(self):
        """One loop iteration: admissions, then one batched decode."""
        groups = self.sched.plan_admissions()
        for gi, group in enumerate(groups):
            self.admit(group, new_sync=(gi == 0))
        if not self.active:
            if not len(self.rq) and self.arrivals:
                # idle: jump the virtual clock to the next arrival
                self.now = max(self.now, self.arrivals[0].arrival_time)
                self.submit_arrivals()
            return
        t_prep = time.perf_counter()
        slots = self.writable_slots()
        prepare_s = time.perf_counter() - t_prep
        if slots:
            self.decode_once(slots, prepare_s=prepare_s)
        self.submit_arrivals()

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
            deployment=None,
            cache_backend=self.serve_cfg.cache_backend,
            peak_active_slots=s.peak_active_slots,
            committed_tokens_per_step=s.committed_tokens_per_step,
            ttft_wall=percentiles([ttft_wall(r) for r in self.requests]),
            itl_wall=percentiles(itl),
            queue_wait=percentiles(s.queue_wait_samples),
            slo_classes=slo,
            n_cancelled=s.n_cancelled,
            n_timed_out=s.n_timed_out,
            n_failed=sum(1 for r in results if r.finish_reason == "failed"),
        )


class ServingEngine:
    def __init__(self, arch_cfg, params,
                 serve_cfg: Optional[ServeConfig] = None,
                 executor: Optional[SingleDeviceExecutor] = None, *,
                 device="cuda"):
        """Build the engine on ``device`` (default the GPU; raises when
        CUDA is absent unless ``device="cpu"``).  ``params`` must already
        lie on that device.  In a bp_* mode every dense weight is quantized
        to int8 once, here (already-int8 weights pass through)."""
        if arch_cfg.family != "dense":
            raise NotImplementedError(
                f"family {arch_cfg.family!r} is not ported")
        self.cfg = arch_cfg
        self.serve_cfg = ServeConfig() if serve_cfg is None else serve_cfg
        check_ported(self.serve_cfg)
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
        """batch: {"tokens": (B, S_prompt)} (host array or tensor)."""
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
        logits, cache = self.executor.prefill({"tokens": prompt}, cache_T)
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
                  sched_cfg: Optional[SchedulerConfig] = None) -> ServeLoop:
        """Build (without running) the orchestration loop of one serve."""
        return ServeLoop(self, requests, n_slots=n_slots, cache_T=cache_T,
                         sched_cfg=sched_cfg)

    def serve(self, requests: Sequence[Request], *, n_slots: int = 8,
              cache_T: Optional[int] = None,
              sched_cfg: Optional[SchedulerConfig] = None) -> ServeReport:
        """Continuously-batched generation over a request stream;
        ``arrival_time`` is on the decode-step clock, so runs are
        deterministic and replayable."""
        return self.make_loop(requests, n_slots=n_slots, cache_T=cache_T,
                              sched_cfg=sched_cfg).run()
