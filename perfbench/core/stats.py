"""Percentiles, window rates and spreads: the arithmetic every metric uses.

A tail is taken over every sample of the window, never over medians of
chunks or steps.  A sample that is missing (a request that failed) is
``None`` and counts as larger than every measured one.
"""

from __future__ import annotations

import math
import statistics
from typing import Iterable, Optional, Sequence


def percentile(samples: Iterable[Optional[float]], q: float) -> float:
    """The nearest-rank ``q``-th percentile (0 < q <= 100) of ``samples``:
    the smallest sample that at least ``q`` % of them do not exceed.  A
    ``None`` (missing) sample sorts above every number, so the result is
    ``inf`` once more than ``100 - q`` % are missing.  Raises on no
    samples."""
    xs = [math.inf if s is None else float(s) for s in samples]
    if not xs:
        raise ValueError("percentile of no samples")
    if not 0 < q <= 100:
        raise ValueError(f"percentile {q} outside (0, 100]")
    xs.sort()
    rank = max(math.ceil(q / 100.0 * len(xs)), 1)
    return xs[rank - 1]


def window_rate(stamps: Iterable[float], t0: float, t1: float) -> float:
    """Events stamped in [t0, t1) per second of that window."""
    if t1 <= t0:
        raise ValueError("empty window")
    return sum(1 for t in stamps if t0 <= t < t1) / (t1 - t0)


def spread(values: Sequence[float]) -> float:
    """The distance between the first and third quartile as a share of the
    median, with ``statistics.quantiles(values, n=4)``'s quartiles."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med
