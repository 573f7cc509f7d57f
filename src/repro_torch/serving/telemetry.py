"""Serving observability: per-step metrics stream, span tracing, reduction
(port of ``repro/serving/telemetry.py``).

  * :class:`MetricsLogger`: a dependency-free JSONL sink, ONE
    schema-versioned record per prefill / decode / verify step plus the
    lifecycle, fault-ladder and ``hw_estimate`` records
    (:data:`STEP_SCHEMA`, the reference's golden key sets).
  * :class:`Tracer` (``repro_torch.tracing``): Chrome-trace-event JSON
    ("X" complete events) around admission, prefill, draft, verify,
    commit, preemption and block-pool operations, and, while the executor
    runs a step, around the model's attention and dense projections (with
    their device time in a prefill); the file loads in
    https://ui.perfetto.dev, on the clock of a ``torch.profiler`` trace.
    With ``annotate_device=True`` every span also enters
    ``torch.profiler.record_function`` so host spans line up with the
    device trace that ``profile_dir`` captures.
  * :func:`reduce_stream`: the PURE fold from step records to the
    ``ServeReport`` aggregates.  ``ServeLoop.report()`` calls exactly this
    over exactly the records it emitted, so the report and the JSONL file
    agree (``reduce_stream(read_jsonl(path))`` folds to the same numbers:
    every emitted value is a plain Python scalar, and JSON round-trips
    binary64 exactly).

The :class:`Telemetry` handle bundles the sinks and rides
``ServeConfig.telemetry`` through the engine into the scheduler, cache
managers, block pool, drafters and executors.  Built with no sink it is a
no-op: spans are a shared null context manager and ``emit`` writes
nothing.  Unlike the reference, a sink that was asked for and fails (the
profiler, the device annotation) raises instead of falling silent.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional

import numpy as np

from repro_torch.tracing import NULL_SPAN, Tracer  # noqa: F401 (re-export)

SCHEMA_VERSION = 1

#: Required keys per record kind: the reference's golden schema, verbatim
#: (``tests/test_torch_telemetry.py`` holds it against the reference's).
#: Extending a record is fine (consumers must ignore unknown keys);
#: removing or renaming one of these is a breaking change and must bump
#: :data:`SCHEMA_VERSION`.
#: The prefill, decode and verify records also carry ``k1_launches`` and
#: ``k2_launches`` (additive): the launches of the BitParticle matmul kernel
#: and of the paged-attention kernel (either variant) since the previous
#: such record, from the kernels' process-wide ``LAUNCHES`` counters (so
#: with two serve loops in one process, as replicas on threads, each
#: loop's records also count the other's launches).
_STEP_KEYS = {"schema", "kind", "ts_s", "step", "wall_s", "phases",
              "active_slots", "committed_tokens", "h2d_bytes", "d2h_bytes",
              "blocks_in_use", "prefix_hit_blocks", "cow_blocks",
              "peak_blocks_in_use"}
STEP_SCHEMA: Dict[str, set] = {
    "run": {"schema", "kind", "ts_s", "cache_backend", "n_slots", "draft",
            "temperature", "mesh_shape", "block_size"},
    "prefill": _STEP_KEYS | {"group_size", "pad_to", "prompt_tokens",
                             "new_sync"},
    "decode": _STEP_KEYS | {"n_slots", "occupancy", "divergence"},
    # ``chunk_tokens`` (additive): prompt tokens a chunked prefill fed
    # through this verify step (0 on pure speculative steps)
    "verify": _STEP_KEYS | {"n_slots", "occupancy", "divergence",
                            "drafted_tokens", "accepted_tokens",
                            "chunk_tokens"},
    "preempt": {"schema", "kind", "ts_s", "step", "slot", "request_id",
                "discarded_tokens"},
    "reject": {"schema", "kind", "ts_s", "step", "request_id"},
    # robustness records (additive, schema stays v1): lifecycle evictions,
    # fault-injection / fault-detection events, and recovery transitions
    "cancel": {"schema", "kind", "ts_s", "step", "request_id", "where"},
    "timeout": {"schema", "kind", "ts_s", "step", "request_id", "where",
                "deadline"},
    "fault": {"schema", "kind", "ts_s", "step", "site"},
    "retry": {"schema", "kind", "ts_s", "step", "site", "attempt"},
    "degrade": {"schema", "kind", "ts_s", "step", "action"},
    "recover": {"schema", "kind", "ts_s", "step", "n_requeued"},
    # hardware-cost observability (additive, schema stays v1): per sampled
    # step the SparsityProbe prices measured activation/weight bit sparsity
    # through the paper's cost models
    "hw_estimate": {"schema", "kind", "ts_s", "step", "phase", "n_layers",
                    "act_bit_sparsity", "act_value_sparsity",
                    "weight_bit_sparsity", "per_layer_act_bit_sparsity",
                    "per_layer_act_value_sparsity", "cycles",
                    "array_utilization", "array_cycles_per_step",
                    "mac_energy_pj"},
    # per-request lifecycle summary (additive, schema stays v1): one record
    # per submitted request, emitted as the loop drains.  ``queue_wait_s``
    # is wall time from queue entry to admission, ``ttft_wall_s`` from
    # queue entry to first token, ``itl_wall_s`` the request's pairwise
    # inter-token gaps: the raw samples behind the report's per-SLO-class
    # percentiles, so the file reduction reproduces them exactly.
    # ``inbox_wait_s`` (additive) is wall time from ``ServeLoop.submit`` to
    # queue entry (None for a request the loop was constructed with)
    "request": {"schema", "kind", "ts_s", "step", "request_id", "slo_class",
                "finish_reason", "n_tokens", "queue_wait_s", "ttft_wall_s",
                "itl_wall_s"},
}


def percentiles(samples, qs=(50, 90, 99)) -> Optional[Dict[str, float]]:
    """{p50, p90, p99} (or custom ``qs``) of a sample set, or None when no
    sample exists."""
    xs = np.asarray([s for s in samples if s is not None], np.float64)
    if xs.size == 0:
        return None
    return {f"p{q}": float(np.percentile(xs, q)) for q in qs}


class MetricsLogger:
    """Append-only JSONL sink: one line per record, flushed per write so a
    crashed run still leaves a readable stream.  Also a context manager
    that closes the file on exit."""

    def __init__(self, path: str):
        self.path = path
        d = os.path.dirname(os.path.abspath(path))
        if d:
            os.makedirs(d, exist_ok=True)
        self._f = open(path, "a", encoding="utf-8")

    def log(self, record: dict):
        self._f.write(json.dumps(record) + "\n")
        self._f.flush()

    def close(self):
        if not self._f.closed:
            self._f.flush()
            self._f.close()

    def __enter__(self) -> "MetricsLogger":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


class Telemetry:
    """The serving observability handle: metrics + trace + profiler sinks.

    Construct with no arguments for the disabled no-op handle.  ``span`` /
    ``instant`` / ``emit`` are safe to call unconditionally.  ``counters``
    tracks cumulative host<->device bytes (the loop snapshots deltas per
    step record); counting stays on with the sinks off so the step stream
    is identical either way.  ``profile_dir``: each serve runs under
    ``torch.profiler.profile`` (CPU activity, and CUDA where a GPU is
    present) and writes its Chrome trace there when it stops
    (``profile_paths`` lists the files)."""

    def __init__(self, metrics_path: Optional[str] = None,
                 trace_path: Optional[str] = None, *,
                 profile_dir: Optional[str] = None,
                 annotate_device: bool = False):
        self.metrics = MetricsLogger(metrics_path) if metrics_path else None
        self.trace_path = trace_path
        self.tracer = (Tracer(annotate_device=annotate_device)
                       if (trace_path or annotate_device) else None)
        self.profile_dir = profile_dir
        self.profile_paths: List[str] = []
        self.counters: Dict[str, int] = {"h2d_bytes": 0, "d2h_bytes": 0}
        self._profiler = None

    @property
    def enabled(self) -> bool:
        return (self.metrics is not None or self.tracer is not None
                or self.profile_dir is not None)

    # -- sinks ---------------------------------------------------------------

    def span(self, name: str, **args):
        if self.tracer is None:
            return NULL_SPAN
        return self.tracer.span(name, **args)

    def instant(self, name: str, **args):
        if self.tracer is not None:
            self.tracer.instant(name, **args)

    def counter(self, name: str, **values):
        if self.tracer is not None:
            self.tracer.counter(name, **values)

    def resolve_device_spans(self) -> None:
        """Give the spans timed on the device their ``device_s`` (called
        after a sync: see ``Tracer.resolve_device_spans``)."""
        if self.tracer is not None:
            self.tracer.resolve_device_spans()

    def emit(self, record: dict):
        if self.metrics is not None:
            self.metrics.log(record)

    def count(self, key: str, n) -> None:
        self.counters[key] = self.counters.get(key, 0) + int(n)

    # -- device profiler hooks ----------------------------------------------

    def start_profile(self):
        """Start a ``torch.profiler`` trace (no-op without ``profile_dir``
        or while one runs)."""
        if self.profile_dir is None or self._profiler is not None:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
        self._profiler = prof

    def stop_profile(self):
        """Stop the running trace and write it into ``profile_dir``."""
        prof, self._profiler = self._profiler, None
        if prof is None:
            return
        prof.stop()
        os.makedirs(self.profile_dir, exist_ok=True)
        path = os.path.join(
            self.profile_dir,
            f"torch_trace_{os.getpid()}_{len(self.profile_paths)}.json")
        prof.export_chrome_trace(path)
        self.profile_paths.append(path)

    def flush(self):
        if self.tracer is not None and self.trace_path:
            self.tracer.write(self.trace_path)

    def close(self):
        self.stop_profile()
        self.flush()
        if self.metrics is not None:
            self.metrics.close()

    def __enter__(self) -> "Telemetry":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


#: Shared disabled handle for components constructed without one.  Its
#: counters are a write-only sink nothing reads.
NULL_TELEMETRY = Telemetry()


# ---------------------------------------------------------------------------
# Stream reduction: step records -> ServeReport aggregates
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class StreamSummary:
    """Aggregates of one serve call's step-record stream.  Every field maps
    onto a ``ServeReport`` counter; ``ServeLoop.report()`` is a pure
    function of this object plus the per-request results."""

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
    peak_active_slots: int = 0
    prefix_hit_blocks: int = 0
    cow_blocks: int = 0
    peak_blocks_in_use: int = 0
    h2d_bytes: int = 0
    d2h_bytes: int = 0
    # robustness counters (cancel / timeout / fault / retry / degrade /
    # recover records)
    n_cancelled: int = 0
    n_timed_out: int = 0
    n_faults: int = 0                 # fault records (injected + detected)
    n_injected_faults: int = 0        # fault records with injected=True
    n_retries: int = 0
    n_degrades: int = 0
    n_recoveries: int = 0
    # hw_estimate records (sparsity-probe samples): order-preserving sums;
    # the report divides by n_hw_samples for the measured-traffic means
    n_hw_samples: int = 0
    hw_act_bit_sparsity: float = 0.0
    hw_act_value_sparsity: float = 0.0
    hw_weight_bit_sparsity: float = 0.0
    hw_array_utilization: float = 0.0
    hw_cycles: Dict[str, float] = dataclasses.field(default_factory=dict)
    hw_mac_energy_pj: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    # prompt tokens a chunked prefill fed through verify steps
    chunk_tokens: int = 0
    # per-request lifecycle records: the wall-clock samples behind the
    # report's queue-wait and per-SLO-class latency percentiles
    n_requests: int = 0
    queue_wait_samples: List[float] = dataclasses.field(default_factory=list)
    slo_ttft_samples: Dict[str, List[float]] = dataclasses.field(
        default_factory=dict)
    slo_itl_samples: Dict[str, List[float]] = dataclasses.field(
        default_factory=dict)


def reduce_stream(records) -> StreamSummary:
    """Fold a step-record stream (dicts, in emission order) into the
    ``ServeReport`` aggregates.  Live records and records parsed back from
    the JSONL file fold to the same numbers: the float math is
    order-preserving sums of the recorded values."""
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
                s.chunk_tokens += int(r.get("chunk_tokens", 0))
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
        elif kind == "fault":
            s.n_faults += 1
            if r.get("injected"):
                s.n_injected_faults += 1
            continue
        elif kind == "retry":
            s.n_retries += 1
            continue
        elif kind == "degrade":
            s.n_degrades += 1
            continue
        elif kind == "recover":
            s.n_recoveries += 1
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
        elif kind == "hw_estimate":
            s.n_hw_samples += 1
            s.hw_act_bit_sparsity += r["act_bit_sparsity"]
            s.hw_act_value_sparsity += r["act_value_sparsity"]
            s.hw_weight_bit_sparsity += r["weight_bit_sparsity"]
            s.hw_array_utilization += r["array_utilization"]
            for k, v in r["cycles"].items():
                s.hw_cycles[k] = s.hw_cycles.get(k, 0.0) + v
            for k, v in r["mac_energy_pj"].items():
                s.hw_mac_energy_pj[k] = s.hw_mac_energy_pj.get(k, 0.0) + v
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


def read_jsonl(path: str) -> List[dict]:
    """Parse a metrics JSONL file back into the record stream."""
    out = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out
