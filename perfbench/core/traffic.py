"""What the traffic generators share.  Each mix is a data file of parameters
in ``perfbench/traffic/`` that names its ``kind``; the generator of a kind
is the file ``perfbench/traffic/<kind>.py`` (``run.generator``).

Sizes are drawn as a grid: ``n`` values at the mid-quantiles of the
stated distribution, shuffled by the seed.  So every seed gets the same
set of sizes (and of inter-arrival gaps) in another order, and two seeds
do the same amount of work; token contents come from the seed.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed), *stream]))


def quantile(dist: dict, u: np.ndarray) -> np.ndarray:
    """Values of ``dist`` at quantiles ``u`` in (0, 1)."""
    kind = dist["dist"]
    if kind == "log_uniform":
        lo, hi = math.log(dist["low"]), math.log(dist["high"])
        return np.exp(lo + u * (hi - lo))
    if kind == "uniform":
        return dist["low"] + u * (dist["high"] - dist["low"])
    raise ValueError(f"unknown distribution {kind!r}")


def grid(dist: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    """``n`` integer sizes at the mid-quantiles of ``dist``, shuffled."""
    u = (np.arange(n) + 0.5) / n
    vals = np.rint(quantile(dist, u)).astype(np.int64)
    return rng.permutation(vals)


def dealt(values: np.ndarray, segments: int,
          rng: np.random.Generator) -> np.ndarray:
    """``values`` in an order drawn from ``rng`` in which each of
    ``segments`` consecutive runs (``np.array_split``'s sizes) holds the
    same share of every quantile range: each group of ``segments`` values
    in sorted order goes one to a run, the runs in random order, and each
    run is shuffled."""
    n = len(values)
    order = np.argsort(values, kind="stable")
    run_of = np.empty(n, np.int64)
    for g0 in range(0, n, segments):
        m = min(segments, n - g0)
        run_of[g0:g0 + m] = rng.permutation(m)
    runs = [rng.permutation(order[run_of == j]) for j in range(segments)]
    return values[np.concatenate(runs)]


def arrival_offsets(rate: float, seconds: float, rng,
                    segments: int = 1) -> np.ndarray:
    """Poisson arrivals at ``rate`` per second: round(rate * seconds)
    gaps at the exponential's mid-quantiles, dealt into ``segments`` equal
    runs and each run scaled to last ``seconds / segments``; the offsets
    (first at 0) all lie in [0, seconds)."""
    n = max(1, int(round(rate * seconds)))
    gaps = dealt(-np.log1p(-(np.arange(n) + 0.5) / n), segments, rng)
    for run in np.array_split(np.arange(n), segments):
        gaps[run] *= (seconds / segments) / gaps[run].sum()
    return np.concatenate([[0.0], np.cumsum(gaps)[:-1]])


@dataclasses.dataclass
class Item:
    """One request of a schedule: due ``due_s`` after the window opens."""
    index: int
    due_s: float
    prompt: np.ndarray
    max_new_tokens: int
    measured: bool
