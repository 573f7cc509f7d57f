"""Seeded, deterministic fault injection for the serving stack (port of
``repro/serving/faults.py``; standard library only, so the code is the
reference's, line for line).

A ``FaultInjector`` is threaded through the stack like ``Telemetry``
(ServeConfig -> ServeLoop -> executor / cache managers / block pool /
drafter), with ``NULL_INJECTOR`` as the no-op default, and fires
deterministic faults at named sites:

========  ==============================================================
site      effect
========  ==============================================================
step      transient exception raised before an executor decode/verify
          dispatch (retry-safe: nothing has touched the cache yet)
prefill   transient exception raised before a prefill dispatch
oom       simulated device OOM on a cache op (slot/paged insert, CoW
          block copy)
pool      forced block-pool exhaustion on ``BlockPool.alloc``
nan       NaN logits injected for a slot inside the decode / verify step
          (exercises the fused finite-logits guard)
drafter   drafter failure during ``propose_all``
slow      latency spike (sleep) before a decode dispatch, for the
          wall-clock watchdog
cancel    chaos-monkey cancellation of a live request
========  ==============================================================

Faults fire either at a fixed ``rates[site]`` probability per check
(seeded ``random.Random``, so a given seed replays the same schedule for
a fixed call sequence) or at explicit ``schedule`` points ``(site, n)``
meaning "fire on the n-th check of that site" (0-based).  Both can be
bounded by ``max_faults``.  The serve loop checks its sites in the
reference's order and number, so one seed fires the same faults in both.

Every fired fault is appended to ``injector.injected`` and, when the
injector is bound to a ServeLoop, emitted as a telemetry ``fault`` record
with ``injected=True``.
"""

from __future__ import annotations

import random
import time
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple


class InjectedFault(RuntimeError):
    """Base class for every injector-raised fault (recoverable by design)."""

    site = "generic"


class TransientStepFault(InjectedFault):
    """Transient executor failure before a step dispatch (retry-safe)."""

    site = "step"


class DeviceOOM(InjectedFault):
    """Simulated device allocator failure on a cache op."""

    site = "oom"


class DrafterFault(InjectedFault):
    """Simulated drafter failure during proposal."""

    site = "drafter"


class StepTimeout(RuntimeError):
    """A dispatched step exceeded the wall-clock watchdog budget."""


class StepFault(RuntimeError):
    """Wrapper for a *real* (non-injected) executor failure.

    Carries the original exception as ``__cause__``; the serve loop
    treats it as non-retryable (the donated cache may be consumed) and
    goes straight to rebuild-and-replay recovery.
    """

    def __init__(self, site: str, cause: BaseException):
        super().__init__(f"{site}: {type(cause).__name__}: {cause}")
        self.site = site
        self.__cause__ = cause


class FaultInjector:
    """Deterministic fault source.

    Parameters
    ----------
    seed:
        Seeds the per-injector RNG; a fixed seed + fixed call sequence
        replays the identical fault schedule.
    rates:
        ``{site: probability}`` — each check of ``site`` fires with this
        probability.
    schedule:
        Explicit ``(site, n)`` pairs: fire on the n-th check (0-based)
        of ``site``.  Composes with ``rates``.
    max_faults:
        Stop firing after this many total injections (None = unbounded).
    slow_s:
        Sleep duration for ``slow`` site fires.
    """

    enabled = True

    def __init__(self, seed: int = 0,
                 rates: Optional[Dict[str, float]] = None,
                 schedule: Optional[Iterable[Tuple[str, int]]] = None,
                 *, max_faults: Optional[int] = None,
                 slow_s: float = 0.05):
        self.rng = random.Random(seed)
        self.rates = dict(rates or {})
        self.schedule = set(schedule or ())
        self.max_faults = max_faults
        self.slow_s = float(slow_s)
        #: every fired fault, in order: (site, check_index, ctx)
        self.injected: List[Tuple[str, int, dict]] = []
        self._checks: Dict[str, int] = {}
        self._cancelled: set = set()
        self._emit: Optional[Callable[..., None]] = None

    # -- wiring ---------------------------------------------------------
    def bind(self, emit: Optional[Callable[..., None]]) -> None:
        """Attach a telemetry callback called as ``emit(site=...)``."""
        self._emit = emit

    # -- core -----------------------------------------------------------
    def fire(self, site: str, **ctx) -> bool:
        """One check of ``site``; returns True when a fault should fire."""
        n = self._checks.get(site, 0)
        self._checks[site] = n + 1
        if self.max_faults is not None and len(self.injected) >= self.max_faults:
            return False
        hit = (site, n) in self.schedule
        rate = self.rates.get(site, 0.0)
        if not hit and rate > 0.0:
            hit = self.rng.random() < rate
        if hit:
            self.injected.append((site, n, ctx))
            if self._emit is not None:
                self._emit(site=site, **ctx)
        return hit

    # -- raising / side-effecting helpers -------------------------------
    def check(self, site: str, **ctx) -> None:
        """Raise the typed fault for ``site`` when a check fires."""
        if self.fire(site, **ctx):
            exc = {"step": TransientStepFault, "prefill": TransientStepFault,
                   "oom": DeviceOOM, "drafter": DrafterFault}.get(
                       site, InjectedFault)
            raise exc(f"injected {site} fault (check #{self._checks[site] - 1})")

    def delay(self, **ctx) -> None:
        """Sleep ``slow_s`` when a ``slow`` check fires (latency spike)."""
        if self.fire("slow", **ctx):
            time.sleep(self.slow_s)

    def nan_slots(self, slots: Sequence[int], **ctx) -> List[int]:
        """Subset of ``slots`` whose logits should be NaN'd this step."""
        return [s for s in slots if self.fire("nan", slot=int(s), **ctx)]

    def cancel_requests(self, request_ids: Sequence[str], **ctx) -> List[str]:
        """Subset of live ``request_ids`` to chaos-cancel (each at most once)."""
        out = []
        for rid in request_ids:
            if rid in self._cancelled:
                continue
            if self.fire("cancel", request_id=rid, **ctx):
                self._cancelled.add(rid)
                out.append(rid)
        return out


class _NullInjector(FaultInjector):
    """Disabled injector: every check is a strict no-op."""

    enabled = False

    def __init__(self):
        super().__init__(seed=0)

    def bind(self, emit) -> None:  # pragma: no cover - trivial
        pass

    def fire(self, site: str, **ctx) -> bool:
        return False

    def check(self, site: str, **ctx) -> None:
        pass

    def delay(self, **ctx) -> None:
        pass

    def nan_slots(self, slots, **ctx):
        return []

    def cancel_requests(self, request_ids, **ctx):
        return []


#: shared disabled injector — safe default everywhere a FaultInjector is
#: accepted; pinned a strict no-op by token-identity tests.
NULL_INJECTOR = _NullInjector()
