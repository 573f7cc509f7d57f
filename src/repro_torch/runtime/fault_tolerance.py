"""Fault tolerance: preemption-safe saves, NaN/spike step rejection,
bounded retry with exponential backoff, auto-resume (a copy of
``repro/runtime/fault_tolerance.py``, which needs nothing of JAX).
"""

from __future__ import annotations

import dataclasses
import logging
import signal
import time
from typing import Callable, Optional

import numpy as np

log = logging.getLogger("repro_torch.runtime")


class PreemptionGuard:
    """SIGTERM/SIGINT => finish the current step, checkpoint, exit cleanly."""

    def __init__(self, install: bool = True):
        self.requested = False
        self._prev = {}
        if install:
            for sig in (signal.SIGTERM, signal.SIGINT):
                try:
                    self._prev[sig] = signal.signal(sig, self._handler)
                except ValueError:      # non-main thread (tests)
                    pass

    def _handler(self, signum, frame):
        log.warning("preemption signal %s received; draining", signum)
        self.requested = True

    def restore(self):
        for sig, h in self._prev.items():
            signal.signal(sig, h)


@dataclasses.dataclass
class SpikeGuardConfig:
    window: int = 32            # running-median window
    spike_factor: float = 4.0   # reject loss > factor x median
    max_consecutive_skips: int = 8


class SpikeGuard:
    """Rejects steps whose loss is NaN/Inf or a large spike vs the running
    median (skips the optimizer update — the params/opt state for a rejected
    step are simply not committed)."""

    def __init__(self, cfg: SpikeGuardConfig = SpikeGuardConfig()):
        self.cfg = cfg
        self.history: list[float] = []
        self.consecutive_skips = 0
        self.total_skips = 0

    def should_commit(self, loss: float) -> bool:
        ok = bool(np.isfinite(loss))
        if ok and len(self.history) >= self.cfg.window // 2:
            med = float(np.median(self.history[-self.cfg.window:]))
            ok = loss <= self.cfg.spike_factor * max(med, 1e-9)
        if ok:
            self.history.append(float(loss))
            self.consecutive_skips = 0
            return True
        self.consecutive_skips += 1
        self.total_skips += 1
        if self.consecutive_skips > self.cfg.max_consecutive_skips:
            raise RuntimeError(
                f"{self.consecutive_skips} consecutive rejected steps — "
                "training has diverged; restore from checkpoint")
        log.warning("rejecting step with loss=%s (skip #%d)", loss,
                    self.total_skips)
        return False


def with_retries(fn: Callable, *, max_attempts: int = 3, base_delay: float = 0.5,
                 retriable=(IOError, OSError), on_retry: Optional[Callable] = None):
    """Run ``fn`` with exponential backoff on transient (I/O-class) failures —
    wraps checkpoint writes / data fetches against flaky storage."""
    for attempt in range(max_attempts):
        try:
            return fn()
        except retriable as e:
            if attempt == max_attempts - 1:
                raise
            delay = base_delay * (2 ** attempt)
            log.warning("attempt %d failed (%s); retrying in %.1fs",
                        attempt + 1, e, delay)
            if on_retry is not None:
                on_retry(attempt, e)
            time.sleep(delay)
