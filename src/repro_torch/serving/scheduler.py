"""Quasi-synchronous continuous-batching scheduler (port of
``repro/serving/scheduler.py``, unchanged: pure Python policy).

The paper's MAC array lets synchronization groups drift up to E steps apart
(inter-group elasticity) so heterogeneous-latency work units stop wasting
lock-step capacity.  Serving has the same problem one level up: a static
batch decodes until its *slowest* request finishes while finished slots burn
compute and arrivals wait for a full drain.

This scheduler is the request-level mirror of the array schedule:

  * slots ~ synchronization groups — each advances at its own sequence
    position (per-slot ``cache_len``), evicted the moment it finishes;
  * the admission queue ~ per-PE operand queues (depth = ``max_waiting``);
  * ``lead_window`` ~ the paper's E: an admissible request (arrived + free
    capacity) may be deferred at most E decode steps so that several
    admissions share one prefill sync, exactly as the array's weight buffer
    holds E+1 weight versions to amortize group re-sync.  E = 0 degenerates
    to admit-immediately (sync every step); E -> inf with ``n_slots``
    arrivals degenerates to static batching.

Admissibility is delegated to the cache manager
(``admissible_prefix``): the slab store admits one request per free slot
(worst-case reservation); the paged store admits by **free-block budget**
with prefix-sharing hits counted — the elastic unit shrinks from a whole
slot drain to a single block.

Prefill fusion buckets admissions by padded power-of-two prompt length
(``prefill_bucketing="pow2"``), so heterogeneous prompts share one prefill
sync and the engine compiles O(log S) prefill shape variants instead of one
per distinct length.  Recurrent-state families use ``"exact"`` buckets
(right padding would corrupt their state).

The scheduler is pure policy: it never touches device state, so the same
scheduler drives every execution layer (single-device or mesh-sharded —
``serving/executor.py``).  The engine's ``ServeLoop`` asks it each
iteration what to admit; prefills, eviction, preemption, and decode are
the loop's job, and all device work is the executor's.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional

from repro_torch.serving.cache_manager import BaseCacheManager
from repro_torch.serving.queue import Request, RequestQueue


@dataclasses.dataclass(frozen=True)
class SLOClass:
    """One priority class with optional latency service-level objectives.

    ``priority`` orders admission under the scheduler's ``"slo"`` policy
    (higher admits first; ties keep FIFO order).  ``ttft_target_s`` /
    ``itl_target_s`` are wall-clock targets: the scheduler folds the live
    p90 of each class's recent samples (the same ``telemetry.percentiles``
    rule the report uses) and, on a breach, turns the knob it owns —
    TTFT breach collapses the lead window to 0 (admit immediately, no
    deferred fusion), ITL breach throttles admission burst size (the
    decode batch stops growing until inter-token latency recovers)."""

    name: str = "default"
    priority: int = 0
    ttft_target_s: Optional[float] = None
    itl_target_s: Optional[float] = None


@dataclasses.dataclass
class SchedulerConfig:
    lead_window: int = 4          # E: max decode steps an admission may wait
    max_waiting: int = 256        # admission-queue depth (Q analogue)
    max_prefill_batch: int = 8    # admissions fused into one prefill call
    # prefill fusion buckets: "pow2" pads prompts up to the next power of
    # two so heterogeneous lengths share one prefill; "exact" fuses only
    # equal lengths; None = engine picks per family (pow2 where right
    # padding is safe, exact for recurrent state / extra prefill inputs)
    prefill_bucketing: Optional[str] = None
    # admission policy: "fifo" (the classic lead-window scheduler; ignores
    # request priorities) or "slo" (priority classes + live TTFT/ITL
    # percentile control — see :class:`SLOClass`)
    policy: str = "fifo"
    # name -> SLOClass for the "slo" policy; requests whose ``slo_class``
    # is not listed get priority 0 and no targets
    slo_classes: Optional[Dict[str, SLOClass]] = None
    # rolling window of wall-clock samples kept per class for the live
    # percentile control inputs
    slo_window: int = 64


def prefill_bucket_len(prompt_len: int, cache_T: Optional[int] = None) -> int:
    """Padded power-of-two prefill length for ``prompt_len`` (clamped to the
    cache capacity so a bucket never exceeds what prefill can hold)."""
    b = 1 << max(prompt_len - 1, 0).bit_length()
    if cache_T is not None:
        b = min(b, cache_T)
    return max(b, 1)


class QuasiSyncScheduler:
    def __init__(self, queue: RequestQueue, cache_mgr: BaseCacheManager,
                 cfg: SchedulerConfig = None, *, telemetry=None):
        from repro_torch.serving.telemetry import NULL_TELEMETRY
        self.queue = queue
        self.cache_mgr = cache_mgr
        self.telemetry = telemetry if telemetry is not None else NULL_TELEMETRY
        self.cfg = cfg if cfg is not None else SchedulerConfig()
        if self.cfg.prefill_bucketing not in (None, "exact", "pow2"):
            raise ValueError(
                f"unknown prefill_bucketing "
                f"{self.cfg.prefill_bucketing!r}; expected 'pow2', 'exact' "
                f"or None (auto)")
        self.bucketing = self.cfg.prefill_bucketing or "exact"
        if self.cfg.policy not in ("fifo", "slo"):
            raise ValueError(f"unknown scheduler policy {self.cfg.policy!r};"
                             f" expected 'fifo' or 'slo'")
        self.pending_wait = 0     # decode steps the current admissible set waited
        self.n_syncs = 0
        self.n_decode_steps = 0
        self.n_committed_tokens = 0
        self.occupancy_sum = 0.0
        self.max_divergence = 0
        # chunked prefill (set by the serve loop): the effective prefill
        # length of a long prompt is its first chunk, so bucketing and
        # fusion group by that, not by the full prompt
        self.prefill_chunk: Optional[int] = None
        # live SLO control state: rolling wall-clock samples per class
        win = max(int(self.cfg.slo_window), 1)
        self._ttft_samples: Dict[str, collections.deque] = (
            collections.defaultdict(lambda: collections.deque(maxlen=win)))
        self._itl_samples: Dict[str, collections.deque] = (
            collections.defaultdict(lambda: collections.deque(maxlen=win)))

    # -- policy -------------------------------------------------------------

    def _bucket(self, prompt_len: int) -> int:
        if self.prefill_chunk is not None:
            prompt_len = min(prompt_len, self.prefill_chunk)
        if self.bucketing == "pow2":
            return prefill_bucket_len(prompt_len,
                                      getattr(self.cache_mgr, "cache_T", None))
        return prompt_len

    def _priority(self, req: Request) -> int:
        cls = (self.cfg.slo_classes or {}).get(req.slo_class)
        return cls.priority if cls is not None else 0

    def _breached(self, samples: Dict[str, collections.deque],
                  target_of) -> bool:
        """True when any class's live p90 exceeds its target — the
        report-only wall-clock percentiles become a control input here."""
        from repro_torch.serving.telemetry import percentiles
        for name, cls in (self.cfg.slo_classes or {}).items():
            target = target_of(cls)
            if target is None:
                continue
            pct = percentiles(samples.get(name, ()), qs=(90,))
            if pct is not None and pct["p90"] > target:
                return True
        return False

    def _effective_lead_window(self) -> int:
        """E under live SLO control: a TTFT breach in any targeted class
        collapses the window to 0 (admit at the first opportunity; the
        fusion saving is what's costing first-token latency)."""
        if self.cfg.policy == "slo" and self._breached(
                self._ttft_samples, lambda c: c.ttft_target_s):
            return 0
        return self.cfg.lead_window

    def plan_admissions(self) -> List[List[Request]]:
        """Decide which WAITING requests to admit *now*.

        Returns prefill groups (same length bucket, fused into one prefill
        call), or [] to keep decoding and let admissible requests wait —
        bounded by the lead window E.  Under the "slo" policy the waiting
        set is ordered priority-first (stable: FIFO within a class) before
        the admissible prefix is sized, and live percentile breaches steer
        E and the admission burst size.
        """
        slo = self.cfg.policy == "slo"
        waiting = self.queue.peek()
        if slo and waiting:
            waiting = sorted(waiting, key=self._priority, reverse=True)
        admissible = self.cache_mgr.admissible_prefix(waiting)
        if admissible == 0:
            self.pending_wait = 0
            return []
        batch_empty = self.cache_mgr.n_active == 0
        fills_all_slots = admissible >= self.cache_mgr.n_free
        if not (batch_empty or fills_all_slots
                or self.pending_wait >= self._effective_lead_window()):
            # elastic deferral: keep the batch running, admissions ride the
            # next sync (<= E steps away)
            self.pending_wait += 1
            return []
        if (slo and not batch_empty and self._breached(
                self._itl_samples, lambda c: c.itl_target_s)):
            # ITL breach: inter-token latency scales with the decode batch,
            # so stop growing it — admit the minimum burst and let the
            # percentile window recover before resuming full admission
            admissible = 1
        self.pending_wait = 0
        self.n_syncs += 1
        self.telemetry.instant("admission_sync", admitted=admissible,
                               n_free_slots=self.cache_mgr.n_free)
        if slo:
            admits = self.queue.pop_selected(waiting[:admissible])
        else:
            admits = self.queue.pop(admissible)
        groups: Dict[int, List[Request]] = {}
        for req in admits:
            groups.setdefault(self._bucket(req.prompt_len), []).append(req)
        out = []
        for _, reqs in sorted(groups.items()):
            for i in range(0, len(reqs), self.cfg.max_prefill_batch):
                out.append(reqs[i:i + self.cfg.max_prefill_batch])
        return out

    # -- live SLO control inputs --------------------------------------------

    def observe_ttft(self, slo_class: str, ttft_s: float) -> None:
        """Feed one first-token wall latency into the class's rolling
        window (called by the loop as each first token commits)."""
        self._ttft_samples[slo_class].append(float(ttft_s))

    def observe_itl(self, slo_class: str, itl_s: float) -> None:
        """Feed one inter-token wall gap into the class's rolling window."""
        self._itl_samples[slo_class].append(float(itl_s))

    def set_lead_window(self, lead_window: int) -> None:
        """Shrink/grow E at runtime (degradation ladder: sustained pool
        pressure trades admission fusion for fewer preemptions)."""
        self.cfg = dataclasses.replace(self.cfg,
                                       lead_window=max(int(lead_window), 0))

    # -- metrics ------------------------------------------------------------

    def observe_decode_step(self, n_committed: Optional[int] = None):
        """Record one batched decode/verify step.  ``n_committed`` is the
        number of tokens actually COMMITTED this step across all slots —
        under speculative decoding a slot commits 1..K+1 tokens per step,
        so throughput accounting must count commits, not assume one token
        per active slot.  ``None`` keeps the classic 1-per-active-slot
        rule (the non-speculative decode step)."""
        self.n_decode_steps += 1
        self.n_committed_tokens += (self.cache_mgr.n_active
                                    if n_committed is None else n_committed)
        self.occupancy_sum += self.cache_mgr.n_active / self.cache_mgr.n_slots
        self.max_divergence = max(self.max_divergence,
                                  self.cache_mgr.divergence())

    @property
    def slot_utilization(self) -> float:
        """Mean fraction of occupied slots per decode step — the serving
        analogue of the array simulator's PE utilization."""
        if self.n_decode_steps == 0:
            return 0.0
        return self.occupancy_sum / self.n_decode_steps

    @property
    def committed_tokens_per_step(self) -> float:
        """Mean tokens committed per batched step (> n_active mean under
        speculation with a positive acceptance rate)."""
        if self.n_decode_steps == 0:
            return 0.0
        return self.n_committed_tokens / self.n_decode_steps
