"""Request lifecycle + bounded admission queue (port of
``repro/serving/queue.py``, unchanged: numpy and the standard library).

Each request walks a strict state machine

    WAITING -> PREFILL -> DECODE -> DONE

(PREFILL may jump straight to DONE when the first sampled token already
terminates the request).  Three extra terminal states are reachable from
every non-terminal state — CANCELLED (explicit ``engine.cancel`` or chaos
injection), TIMED_OUT (per-request ``deadline_s`` / ``ttft_deadline_s``
wall-clock budgets), FAILED (NaN guard or exhausted recovery) — see
``docs/robustness.md``.  The ``RequestQueue`` is the serving analogue of the
quasi-sync array's per-PE operand queue: a bounded FIFO that decouples
arrivals from the lock-step decode batch.  Submissions beyond ``max_waiting``
are rejected (admission control) rather than growing latency unboundedly.
"""

from __future__ import annotations

import dataclasses
import enum
import itertools
from typing import List, Optional

import numpy as np

_REQUEST_IDS = itertools.count()


class RequestState(enum.Enum):
    WAITING = "waiting"
    PREFILL = "prefill"
    DECODE = "decode"
    DONE = "done"
    CANCELLED = "cancelled"
    TIMED_OUT = "timed_out"
    FAILED = "failed"


#: terminal states a request may be evicted into from any live state
_TERMINAL = {RequestState.DONE, RequestState.CANCELLED,
             RequestState.TIMED_OUT, RequestState.FAILED}

_ALLOWED = {
    RequestState.WAITING: {RequestState.PREFILL} | _TERMINAL,
    # PREFILL -> WAITING is the admission-failure rollback: a fault while
    # installing the group requeues the request for a token-exact replay
    RequestState.PREFILL: {RequestState.DECODE, RequestState.WAITING}
                          | _TERMINAL,
    # DECODE -> WAITING is preemption: the paged backend reclaims the
    # request's blocks and requeues it for a token-exact replay
    RequestState.DECODE: {RequestState.WAITING} | _TERMINAL,
    RequestState.DONE: set(),
    RequestState.CANCELLED: set(),
    RequestState.TIMED_OUT: set(),
    RequestState.FAILED: set(),
}

#: finish_reason -> terminal state (anything else, e.g. "eos" / "length"
#: / "rejected", lands in DONE)
_REASON_STATE = {
    "cancelled": RequestState.CANCELLED,
    "timeout": RequestState.TIMED_OUT,
    "failed": RequestState.FAILED,
}


@dataclasses.dataclass(eq=False)
class Request:
    """One generation request plus its lifecycle bookkeeping.

    ``eq=False``: requests compare (and hash) by IDENTITY.  The generated
    field-wise ``__eq__`` would compare numpy prompts elementwise and
    break every ``in`` / ``remove`` the queues and sweeps rely on.

    Times are in scheduler-clock units (decode steps) so that runs are
    deterministic and replayable; wall-clock throughput is measured by the
    engine separately.
    """

    prompt: np.ndarray                       # (S,) int32 prompt tokens
    max_new_tokens: int = 32
    arrival_time: float = 0.0
    request_id: int = dataclasses.field(
        default_factory=lambda: next(_REQUEST_IDS))
    state: RequestState = RequestState.WAITING
    slot: Optional[int] = None
    tokens: List[int] = dataclasses.field(default_factory=list)
    admitted_at: Optional[float] = None      # prefill (admission sync) time
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None
    # "eos" | "length" | "rejected" | "cancelled" | "timeout" | "failed"
    finish_reason: Optional[str] = None
    # wall-clock budgets, measured from wall_submitted_at (None = no
    # budget): total completion deadline, and a tighter first-token
    # deadline that only applies while the request is still waiting
    deadline_s: Optional[float] = None
    ttft_deadline_s: Optional[float] = None
    # SLO priority class (``scheduler.SLOClass`` name).  Under the
    # scheduler's "slo" policy higher-priority classes are admitted first
    # and their TTFT/ITL targets steer the lead window; the default FIFO
    # policy ignores it entirely.
    slo_class: str = "default"
    # tokens generated before a preemption, re-emitted verbatim on replay
    # (the engine forces them over the resampled ones, so a preempted
    # request finishes with exactly the tokens it would have produced)
    replay: List[int] = dataclasses.field(default_factory=list)
    n_preemptions: int = 0
    # wall-clock trace (time.perf_counter): when the request entered the
    # waiting queue and when each token was emitted — the step-clock fields
    # above stay the deterministic/replayable record, these feed the
    # ServeReport latency percentiles (TTFT / inter-token)
    wall_submitted_at: Optional[float] = None
    wall_admitted_at: Optional[float] = None
    wall_token_times: List[float] = dataclasses.field(default_factory=list)

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def ttft(self) -> Optional[float]:
        if self.first_token_at is None:
            return None
        return self.first_token_at - self.arrival_time

    @property
    def latency(self) -> Optional[float]:
        if self.finished_at is None:
            return None
        return self.finished_at - self.arrival_time

    def transition(self, new_state: RequestState):
        if new_state not in _ALLOWED[self.state]:
            raise ValueError(
                f"request {self.request_id}: illegal transition "
                f"{self.state.value} -> {new_state.value}")
        self.state = new_state

    @property
    def is_terminal(self) -> bool:
        return self.state in _TERMINAL

    def finish(self, now: float, reason: str):
        self.transition(_REASON_STATE.get(reason, RequestState.DONE))
        self.finished_at = now
        self.finish_reason = reason
        self.slot = None

    def preempt(self):
        """Back to WAITING with generated-so-far tokens queued for replay
        (prepended to any replay tail a double preemption left behind)."""
        self.transition(RequestState.WAITING)
        self.replay = self.tokens + self.replay
        self.tokens = []
        self.slot = None
        self.n_preemptions += 1


class RequestQueue:
    """Bounded FIFO of WAITING requests (admission control at submit).

    ``on_reject`` is an optional callback invoked with each rejected
    request — the serve loop uses it to emit a ``reject`` record into the
    telemetry stream from the ONE central rejection path (both the
    capacity rejection in ``submit`` and the engine's explicit
    cannot-ever-fit rejection funnel through :meth:`reject`)."""

    def __init__(self, max_waiting: Optional[int] = None, on_reject=None):
        if max_waiting is not None and max_waiting < 1:
            raise ValueError("max_waiting must be >= 1 (or None)")
        self.max_waiting = max_waiting
        self.on_reject = on_reject
        self._waiting: List[Request] = []
        self.n_rejected = 0

    def __len__(self) -> int:
        return len(self._waiting)

    def peek(self) -> List[Request]:
        """The waiting requests in FIFO order (not dequeued) — the
        scheduler sizes its admissible prefix against this."""
        return list(self._waiting)

    def push_front(self, request: Request):
        """Requeue a preempted request at the head (it was already admitted
        once; it does not count against ``max_waiting`` again)."""
        if request.state is not RequestState.WAITING:
            raise ValueError(
                f"cannot requeue request in state {request.state}")
        self._waiting.insert(0, request)

    def remove(self, request: Request) -> bool:
        """Drop one waiting request (cancellation / deadline sweep);
        returns False when it is not queued."""
        try:
            self._waiting.remove(request)
            return True
        except ValueError:
            return False

    def reject(self, request: Request, now: float):
        """Mark a request rejected (admission control) and count it."""
        self.n_rejected += 1
        request.finish(now, "rejected")
        if self.on_reject is not None:
            self.on_reject(request)

    def submit(self, request: Request, now: float = 0.0) -> bool:
        """Enqueue; returns False (and marks the request rejected) when the
        queue is at capacity."""
        if request.state is not RequestState.WAITING:
            raise ValueError(f"cannot submit request in state {request.state}")
        if self.max_waiting is not None and len(self._waiting) >= self.max_waiting:
            self.reject(request, now)
            return False
        self._waiting.append(request)
        return True

    def pop(self, k: int) -> List[Request]:
        """Dequeue up to ``k`` requests in FIFO order."""
        popped, self._waiting = self._waiting[:k], self._waiting[k:]
        return popped

    def pop_selected(self, requests: List[Request]) -> List[Request]:
        """Dequeue a specific set of waiting requests (identity match),
        preserving the caller's order — the SLO scheduler admits a
        priority-ordered subset instead of the FIFO prefix.  Requests not
        currently queued raise (a scheduling bug, not a race: the planner
        selects from ``peek()`` under the same loop iteration)."""
        for req in requests:
            if not self.remove(req):
                raise ValueError(
                    f"request {req.request_id} is not waiting; cannot "
                    f"admit it")
        return list(requests)
