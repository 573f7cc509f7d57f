"""Decode-cache managers: slot accounting base + the slab backing store
(port of ``repro/serving/cache_manager.py``).

  * **slab** (:class:`CacheManager`): ONE pooled decode cache of
    ``n_slots`` slots, each a fixed worst-case ``cache_T`` region.
  * **paged** (:class:`repro_torch.serving.block_pool.PagedCacheManager`):
    fixed-size KV blocks allocated on demand through per-slot block tables,
    with prefix sharing, copy-on-write and preemption when the pool runs
    dry.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


class BaseCacheManager:
    """Slot accounting shared by every backing store: occupancy, per-slot
    sequence positions, and the vectorized position bookkeeping that both
    ``advance`` and ``divergence`` read."""

    def __init__(self, cfg, n_slots: int):
        if n_slots < 1:
            raise ValueError("n_slots must be >= 1")
        self.cfg = cfg
        self.n_slots = n_slots
        self.lengths = np.zeros(n_slots, np.int32)   # per-slot seq position
        self._free_slots: List[int] = list(range(n_slots - 1, -1, -1))
        self._occupied = np.zeros(n_slots, bool)

    @property
    def n_free(self) -> int:
        return len(self._free_slots)

    @property
    def n_active(self) -> int:
        return self.n_slots - len(self._free_slots)

    def alloc(self, slot: Optional[int] = None) -> int:
        """Claim a free slot (LIFO order), or that specific ``slot``."""
        if not self._free_slots:
            raise RuntimeError("no free slot")
        if slot is None:
            slot = self._free_slots.pop()
        elif slot in self._free_slots:
            self._free_slots.remove(slot)
        else:
            raise RuntimeError(f"slot {slot} is not free")
        self._occupied[slot] = True
        return slot

    def free(self, slot: int):
        if not self._occupied[slot]:
            raise ValueError(f"slot {slot} is not occupied")
        self._occupied[slot] = False
        self.lengths[slot] = 0
        self._free_slots.append(slot)

    def advance(self, slots, counts=None):
        """Bump the sequence position of the given slots by one token each,
        or by per-slot ``counts``."""
        idx = np.asarray(list(slots), np.intp)
        if counts is None:
            np.add.at(self.lengths, idx, 1)
        else:
            np.add.at(self.lengths, idx,
                      np.asarray(list(counts), np.int32))

    def cache_len_vector(self) -> np.ndarray:
        """(n_slots,) per-slot positions for ``decode_step`` (host array;
        the executor moves it to the device).  Free slots sit at 0: their
        writes land in regions never read for an admitted request
        (overwritten by the next ``insert`` in the slab store, pointed at
        the trash block in the paged store)."""
        return self.lengths.copy()

    def divergence(self) -> int:
        """Spread of active-slot positions (the quasi-sync E analogue)."""
        active = self.lengths[self._occupied]
        if active.size == 0:
            return 0
        return int(active.max() - active.min())

    def admissible_prefix(self, requests) -> int:
        """How many front-of-queue requests could be admitted right now:
        one free slot per request."""
        return min(len(requests), self.n_free)


class CacheManager(BaseCacheManager):
    """Slab store: fixed-capacity per-slot KV.  Device work (allocation and
    the in-place slot insert) goes through the ``executor``."""

    def __init__(self, cfg, n_slots: int, cache_T: int, executor,
                 telemetry=None):
        from repro_torch.serving.telemetry import NULL_TELEMETRY
        super().__init__(cfg, n_slots)
        self.cache_T = cache_T
        self.telemetry = telemetry if telemetry is not None else NULL_TELEMETRY
        self.executor = executor
        self.cache = executor.zeros_cache(n_slots, cache_T)

    def fits(self, prompt_len: int, max_new_tokens: int) -> bool:
        """Does prompt + generation fit in one slot's capacity?"""
        return prompt_len + max_new_tokens <= self.cache_T

    def insert(self, slot: int, src_cache, length: int, src_index: int = 0,
               tokens=None):
        """Install request ``src_index`` of a prefill cache (padded to this
        pool's cache_T) into ``slot`` and set its sequence position.
        ``tokens`` is accepted for interface parity and ignored."""
        if not self._occupied[slot]:
            raise ValueError(f"slot {slot} must be alloc()ed before insert")
        with self.telemetry.span("slot_insert", slot=slot, length=length):
            self.cache = self.executor.slot_insert(self.cache, src_cache,
                                                   slot, src_index)
        self.lengths[slot] = length

    def update(self, new_cache):
        """Adopt the cache returned by a batched decode step (the same
        tensors, updated in place)."""
        self.cache = new_cache


def make_cache_manager(cfg, n_slots: int, cache_T: int, *,
                       backend: str = "slab", block_size: int = 16,
                       num_blocks: Optional[int] = None, executor,
                       telemetry=None, faults=None) -> BaseCacheManager:
    """Build the backing store selected by ``backend``, with its device ops
    routed through ``executor``, its spans on ``telemetry`` (None ->
    no-op) and, paged only, its pool allocations checked against the
    ``faults`` injector (None -> no-op).  ``block_size`` and
    ``num_blocks`` size the paged pool (``num_blocks`` None: the slab's
    footprint)."""
    if backend == "slab":
        return CacheManager(cfg, n_slots, cache_T, executor=executor,
                            telemetry=telemetry)
    if backend == "paged":
        from repro_torch.serving.block_pool import PagedCacheManager
        return PagedCacheManager(cfg, n_slots, cache_T,
                                 block_size=block_size, num_blocks=num_blocks,
                                 executor=executor, telemetry=telemetry,
                                 faults=faults)
    raise ValueError(f"unknown cache_backend {backend!r}; "
                     f"expected 'slab' or 'paged'")

