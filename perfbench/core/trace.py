"""Reduction of a ``torch.profiler`` window to busy time, device time by
kernel and idle gaps by what the host was doing.

It reads the profiler's raw kineto events (the smoke script's
``profile_summary`` rule): the profiler's own event tree,
``key_averages()``, costs ~0.7 ms of host time per kernel launched.  Busy
time is the union of the device events' intervals, so overlapping events
count once.
"""

from __future__ import annotations

import bisect
import collections
from typing import Dict, List, Tuple

#: a host event shorter than this is not taken as what the host was doing
#: during a gap (it is an op's own launch, not the work around it)
MIN_HOST_NS = 20_000
#: the idle gaps named by their host event (the rest are pooled)
NAMED_GAPS = 400


def reduce_profile(prof, annotations=(), top: int = 10) -> dict:
    """{"busy_s", "kernels": {name: seconds}, "device_ops": [[name, s]...],
    "idle_gaps": [[name, s]...]} of a stopped profiler.  Every idle gap is named by the innermost of the program's spans
    (``annotations``: the names its ``record_function`` ranges carry) that
    covers its middle; outside them the longest gaps are named by the
    innermost host event of 20 us or more, and the rest pooled."""
    from torch.autograd import DeviceType

    device: List[Tuple[int, int, str]] = []
    host: List[Tuple[int, int, str]] = []
    spans: List[Tuple[int, int, str]] = []
    host_names = set()
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU:
            host_names.add(e.name())
            if e.name() in annotations:
                spans.append((e.start_ns(), e.end_ns(), e.name()))
            elif not e.is_async() and e.duration_ns() >= MIN_HOST_NS:
                host.append((e.start_ns(), e.end_ns(), e.name()))
        elif e.duration_ns() > 0:
            device.append((e.start_ns(), e.end_ns(), e.name()))
    # a host annotation (``record_function``) is mirrored on the device as
    # a span over the kernels it launched: it is no device operation
    device = [d for d in device if d[2] not in host_names]
    per_name: Dict[str, int] = collections.defaultdict(int)
    for a, b, name in device:
        per_name[name] += b - a
    device.sort()
    busy, gaps = 0, []
    cur_a = cur_b = None
    for a, b, _ in device:
        if cur_b is None:
            cur_a, cur_b = a, b
        elif a > cur_b:
            busy += cur_b - cur_a
            gaps.append((a - cur_b, cur_b, a))
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        busy += cur_b - cur_a
    named, outside = _in_spans(gaps, spans)
    longest = sorted(outside, reverse=True)[:NAMED_GAPS]
    for name, ns in _name_gaps(longest, host).items():
        named[name] += ns
    pooled = sum(g for g, _, _ in outside) - sum(g for g, _, _ in longest)
    if pooled > 0:
        named[f"shorter gaps outside spans "
              f"({len(outside) - len(longest)})"] += pooled
    ranked = sorted(per_name.items(), key=lambda kv: kv[1], reverse=True)
    return {
        "busy_s": busy / 1e9,
        "kernels": {k: ns / 1e9 for k, ns in per_name.items()},
        "device_ops": [[k[:120], ns / 1e9] for k, ns in ranked[:top]],
        "idle_gaps": [[k[:120], ns / 1e9] for k, ns in sorted(
            named.items(), key=lambda kv: kv[1], reverse=True)[:top]],
    }


def _in_spans(gaps, spans):
    """(idle ns by the innermost span covering each gap's middle, the gaps
    no span covers).  The spans nest (one host thread), so one sweep in
    time order with a stack of open spans finds the innermost."""
    spans.sort()
    named: Dict[str, int] = collections.defaultdict(int)
    outside, stack, i = [], [], 0
    for g in sorted(gaps, key=lambda g: g[1] + g[2]):
        mid = (g[1] + g[2]) // 2
        while i < len(spans) and spans[i][0] <= mid:
            while stack and stack[-1][1] < spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        if stack:
            named[f"in {stack[-1][2]}"] += g[0]
        else:
            outside.append(g)
    return named, outside


def _name_gaps(gaps, host) -> Dict[str, int]:
    """Idle nanoseconds by the innermost host event that covers each gap's
    middle ("python" where none does)."""
    host.sort()
    starts = [a for a, _, _ in host]
    out: Dict[str, int] = collections.defaultdict(int)
    for g, a, b in gaps:
        mid = (a + b) // 2
        i = bisect.bisect_right(starts, mid)
        best = None
        # the covering events start at or before the middle; scan back
        # over a bounded window of them
        for j in range(i - 1, max(i - 4000, -1), -1):
            s, e, name = host[j]
            if e >= mid and (best is None or e - s < best[0]):
                best = (e - s, name)
        out[best[1] if best else "python"] += g
    return out


def kernel_seconds(kernels: Dict[str, float], patterns) -> float:
    """Device seconds of every kernel whose name holds one of
    ``patterns``."""
    return sum(s for name, s in kernels.items()
               if any(p in name for p in patterns))
