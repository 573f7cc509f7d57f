"""Serving telemetry, the part the report needs (port of
``repro/serving/telemetry.py``).

Ported: the disabled :class:`Telemetry` handle (``span`` / ``instant`` /
``counter`` / ``emit`` are no-ops; ``count`` keeps host<->device byte
counters), :func:`percentiles`, :class:`StreamSummary` and
:func:`reduce_stream`, the pure fold from the serve loop's step records to
the ``ServeReport`` aggregates.  The JSONL metrics and Chrome-trace sinks
are not ported yet; asking for them raises.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

SCHEMA_VERSION = 1


def percentiles(samples, qs=(50, 90, 99)) -> Optional[Dict[str, float]]:
    """{p50, p90, p99} (or custom ``qs``) of a sample set, or None when no
    sample exists."""
    xs = np.asarray([s for s in samples if s is not None], np.float64)
    if xs.size == 0:
        return None
    return {f"p{q}": float(np.percentile(xs, q)) for q in qs}


class _NullSpan:
    """Shared do-nothing context manager: the disabled-telemetry span."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


class Telemetry:
    """The disabled observability handle.  Spans and records go nowhere;
    ``counters`` tracks cumulative host<->device bytes so the step records
    carry them exactly as in the reference."""

    def __init__(self, metrics_path: Optional[str] = None,
                 trace_path: Optional[str] = None, *,
                 profile_dir: Optional[str] = None):
        if metrics_path or trace_path or profile_dir:
            raise NotImplementedError(
                "telemetry sinks (metrics JSONL, trace, profiler) are not "
                "ported yet")
        self.counters: Dict[str, int] = {"h2d_bytes": 0, "d2h_bytes": 0}

    @property
    def enabled(self) -> bool:
        return False

    def span(self, name: str, **args):
        return NULL_SPAN

    def instant(self, name: str, **args):
        pass

    def counter(self, name: str, **values):
        pass

    def emit(self, record: dict):
        pass

    def count(self, key: str, n) -> None:
        self.counters[key] = self.counters.get(key, 0) + int(n)


#: Shared disabled handle for components constructed without one.
NULL_TELEMETRY = Telemetry()


@dataclasses.dataclass
class StreamSummary:
    """Aggregates of one serve call's step-record stream (the ported record
    kinds: prefill, decode, verify, preempt, reject, cancel, timeout,
    request)."""

    prefill_s: float = 0.0            # sum of prefill dispatch walls
    decode_s: float = 0.0             # sum of decode/verify dispatch walls
    steps: int = 0                    # decode + verify records
    n_syncs: int = 0                  # prefill records opening a sync
    total_new_tokens: int = 0         # emitted - discarded-at-preemption
    committed_decode_tokens: int = 0  # decode/verify commits only
    slot_utilization: float = 0.0
    committed_tokens_per_step: float = 0.0
    max_divergence: int = 0
    n_preemptions: int = 0
    n_rejected: int = 0
    drafted_tokens: int = 0           # drafts submitted to verify steps
    accepted_tokens: int = 0          # drafts the target's argmax confirmed
    # prompt tokens a chunked prefill fed through verify steps
    chunk_tokens: int = 0
    peak_active_slots: int = 0
    prefix_hit_blocks: int = 0
    cow_blocks: int = 0
    peak_blocks_in_use: int = 0
    h2d_bytes: int = 0
    d2h_bytes: int = 0
    n_cancelled: int = 0
    n_timed_out: int = 0
    n_requests: int = 0
    queue_wait_samples: List[float] = dataclasses.field(default_factory=list)
    slo_ttft_samples: Dict[str, List[float]] = dataclasses.field(
        default_factory=dict)
    slo_itl_samples: Dict[str, List[float]] = dataclasses.field(
        default_factory=dict)


def reduce_stream(records) -> StreamSummary:
    """Fold a step-record stream (dicts, in emission order) into the
    ``ServeReport`` aggregates, as the reference does."""
    s = StreamSummary()
    occupancy_sum = 0.0
    emitted = 0
    discarded = 0
    for r in records:
        kind = r.get("kind")
        if kind == "prefill":
            s.prefill_s += r["phases"]["dispatch_s"]
            if r["new_sync"]:
                s.n_syncs += 1
            emitted += r["committed_tokens"]
        elif kind in ("decode", "verify"):
            s.steps += 1
            s.decode_s += r["phases"]["dispatch_s"]
            occupancy_sum += r["occupancy"]
            s.committed_decode_tokens += r["committed_tokens"]
            emitted += r["committed_tokens"]
            s.max_divergence = max(s.max_divergence, int(r["divergence"]))
            s.peak_active_slots = max(s.peak_active_slots,
                                      int(r["active_slots"]))
            if kind == "verify":
                s.drafted_tokens += int(r["drafted_tokens"])
                s.accepted_tokens += int(r["accepted_tokens"])
                s.chunk_tokens += int(r["chunk_tokens"])
        elif kind == "preempt":
            s.n_preemptions += 1
            discarded += int(r["discarded_tokens"])
            continue
        elif kind == "reject":
            s.n_rejected += 1
            continue
        elif kind == "cancel":
            s.n_cancelled += 1
            continue
        elif kind == "timeout":
            s.n_timed_out += 1
            continue
        elif kind == "request":
            s.n_requests += 1
            cls = str(r["slo_class"])
            if r["queue_wait_s"] is not None:
                s.queue_wait_samples.append(float(r["queue_wait_s"]))
            if r["ttft_wall_s"] is not None:
                s.slo_ttft_samples.setdefault(cls, []).append(
                    float(r["ttft_wall_s"]))
            if r["itl_wall_s"]:
                s.slo_itl_samples.setdefault(cls, []).extend(
                    float(v) for v in r["itl_wall_s"])
            continue
        else:
            continue
        # pool gauges are cumulative snapshots; max == final (monotone)
        s.prefix_hit_blocks = max(s.prefix_hit_blocks,
                                  int(r["prefix_hit_blocks"]))
        s.cow_blocks = max(s.cow_blocks, int(r["cow_blocks"]))
        s.peak_blocks_in_use = max(s.peak_blocks_in_use,
                                   int(r["peak_blocks_in_use"]))
        s.h2d_bytes += int(r["h2d_bytes"])
        s.d2h_bytes += int(r["d2h_bytes"])
    s.total_new_tokens = emitted - discarded
    if s.steps:
        s.slot_utilization = occupancy_sum / s.steps
        s.committed_tokens_per_step = s.committed_decode_tokens / s.steps
    return s
