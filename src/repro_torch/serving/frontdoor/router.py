"""Multi-replica request router (port of
``repro/serving/frontdoor/router.py``: numpy and the standard library,
the same policies and picks).

Policies:

``"affinity"`` (default)
    Prefix-affinity with load spill: the routing key is a hash of the
    prompt's LEADING blocks (``affinity_blocks * block_size`` tokens —
    the same granularity the paged ``BlockPool`` deduplicates at), so
    requests sharing a system prompt land on the replica whose prefix
    trie already holds those pages and admit by reference instead of
    recomputing prefill KV.  A key's home replica is sticky (LRU-capped
    map); when the home's queue depth exceeds the lightest replica's by
    more than ``max_imbalance`` the request SPILLS to the least-loaded
    replica without re-homing — transient hot spots shed load, the
    prefix home (and its cached pages) stays put.

``"least_loaded"``
    Smallest queue depth, ties broken by the modeled cost hint
    (``cost_hint_cycles_per_token`` from the hw_estimate probe stream)
    then name — the first step toward cost-aware admission.

``"round_robin"`` / ``"random"``
    Baselines (``random`` is seeded — benchmarks stay reproducible).
"""

from __future__ import annotations

import collections
import hashlib
import random
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.serving.frontdoor.replica import Replica

POLICIES = ("affinity", "least_loaded", "round_robin", "random")


class Router:
    def __init__(self, replicas: Sequence[Replica], *,
                 policy: str = "affinity", affinity_blocks: int = 2,
                 max_imbalance: int = 4, max_keys: int = 4096,
                 seed: int = 0):
        if not replicas:
            raise ValueError("router needs at least one replica")
        if policy not in POLICIES:
            raise ValueError(f"unknown router policy {policy!r}; "
                             f"expected one of {POLICIES}")
        if affinity_blocks < 1:
            raise ValueError("affinity_blocks must be >= 1")
        self.replicas: List[Replica] = list(replicas)
        self.policy = policy
        self.affinity_blocks = affinity_blocks
        self.max_imbalance = max_imbalance
        self.max_keys = max_keys
        self._rng = random.Random(seed)
        self._rr = 0
        # affinity key -> replica index, LRU-evicted past max_keys (a
        # dropped key just re-homes on its next request)
        self._home: "collections.OrderedDict[str, int]" = (
            collections.OrderedDict())
        self.n_spills = 0

    # -- policy -------------------------------------------------------------

    def _key(self, prompt) -> str:
        n = self.affinity_blocks * self.replicas[0].block_size
        head = np.asarray(prompt, np.int32).reshape(-1)[:n]
        return hashlib.sha1(head.tobytes()).hexdigest()

    def _depths(self) -> List[int]:
        return [r.stats()["queue_depth"] for r in self.replicas]

    def _least_loaded(self) -> int:
        ranked = []
        for i, r in enumerate(self.replicas):
            s = r.stats()
            ranked.append((s["queue_depth"], s["cost_hint_cycles_per_token"],
                           s["name"], i))
        return min(ranked)[3]

    def pick(self, prompt) -> Replica:
        """Choose the replica for one prompt (pure routing decision; the
        caller submits to it)."""
        if self.policy == "round_robin":
            i = self._rr % len(self.replicas)
            self._rr += 1
            return self.replicas[i]
        if self.policy == "random":
            return self.replicas[self._rng.randrange(len(self.replicas))]
        if self.policy == "least_loaded":
            return self.replicas[self._least_loaded()]
        # affinity
        key = self._key(prompt)
        home = self._home.get(key)
        if home is None:
            home = self._least_loaded()
            self._home[key] = home
            while len(self._home) > self.max_keys:
                self._home.popitem(last=False)
        else:
            self._home.move_to_end(key)
        depths = self._depths()
        if depths[home] - min(depths) > self.max_imbalance:
            self.n_spills += 1
            return self.replicas[self._least_loaded()]
        return self.replicas[home]

    def submit(self, request, on_token=None, on_finish=None):
        """Route + submit in one call; returns ``(replica, request_id)``."""
        replica = self.pick(request.prompt)
        rid = replica.submit(request, on_token=on_token,
                             on_finish=on_finish)
        return replica, rid

    # -- observability ------------------------------------------------------

    def stats(self) -> dict:
        return {"policy": self.policy,
                "n_spills": int(self.n_spills),
                "n_affinity_keys": len(self._home),
                "replicas": [r.stats() for r in self.replicas]}
