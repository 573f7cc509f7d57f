"""Paged KV-cache memory subsystem: BlockPool accounting + PagedCacheManager
(port of ``repro/serving/block_pool.py``; host logic on numpy, device work
through the executor).

The slab backend (``cache_manager.CacheManager``) reserves a full worst-case
``cache_T`` region per slot, so admission is governed by
``prompt_len + max_new_tokens`` even when most requests finish early — the
serving-memory analogue of the paper's "one factor's sparsity is completely
wasted" problem.  This module partializes that variable-size reservation into
fixed-size **blocks** (``block_size`` tokens each), allocated on demand, with
cheap control logic:

  * ``BlockPool`` — pure host-side accounting: a free list, per-block
    reference counts, and a hash-trie over *full* prompt-token blocks that
    makes prefix sharing automatic (two requests with the same system prompt
    map their shared prefix onto the same physical blocks).  Blocks whose
    refcount drops to zero but that are registered in the trie are retained
    in an LRU "cached" list and only really evicted when the pool runs dry.
  * ``PagedCacheManager`` — the device-facing manager with the same slot
    interface as the slab ``CacheManager`` (alloc/free/insert/advance/...),
    plus per-slot block tables, copy-on-write on the first divergent write
    into a shared block, and the block-budget accounting the scheduler uses
    for admission.

Physical layout: every KV leaf is paged as ``(L, num_blocks, block_size,
heads...)``; a request's logical positions ``[0, len)`` live at
``pages[:, table[i], pos % block_size]`` with ``i = pos // block_size``.
Block id 0 is reserved as a trash/scratch block: unused table entries point
at it, so every gather/scatter stays in-range at fixed shapes (writes that
must go nowhere land there, reads of it are masked by ``cache_len``).
"""

from __future__ import annotations

import collections
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.models import api
from repro_torch.serving.cache_manager import BaseCacheManager
from repro_torch.serving.faults import NULL_INJECTOR, InjectedFault

TRASH_BLOCK = 0  # reserved scratch block id (never allocated, never shared)


class NoFreeBlocks(RuntimeError):
    """Raised when an allocation cannot be satisfied even after evicting
    every unreferenced cached block (the engine preempts a request then)."""


class InjectedPoolExhaustion(NoFreeBlocks, InjectedFault):
    """Injected pool exhaustion: rides the normal ``NoFreeBlocks``
    preempt-and-retry path, but, being an :class:`InjectedFault`, stays
    recoverable when no preemption victim exists (a REAL exhaustion with
    no victim is a sizing error and keeps raising)."""

    site = "pool"


class BlockPool:
    """Host-side accounting for a pool of fixed-size KV blocks.

    Pure control logic — never touches device memory.  The paged cache
    manager (and its tests) drive it; the device-side pages are indexed by
    the block ids this pool hands out.
    """

    def __init__(self, num_blocks: int, block_size: int, *, faults=None):
        if num_blocks < 2:
            raise ValueError("num_blocks must be >= 2 (block 0 is reserved)")
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.faults = faults if faults is not None else NULL_INJECTOR
        # block 0 is the trash block; ids [1, num_blocks) are allocatable
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        self.refcount = np.zeros(num_blocks, np.int32)
        # hash-trie over full prompt blocks: key = (parent_key, tokens);
        # the root parent is None.  node key -> block id, plus the children
        # map used for partial-suffix matching.
        self._trie: Dict[tuple, int] = {}
        self._children: Dict[Optional[tuple], Dict[tuple, int]] = {}
        self._block_key: Dict[int, tuple] = {}     # block id -> trie key
        # refcount-0 blocks still registered in the trie, LRU order
        # (oldest first); they are reclaimed only when the free list is dry.
        self._cached: "collections.OrderedDict[int, None]" = \
            collections.OrderedDict()
        self.n_evictions = 0
        self.n_cow = 0
        self.n_prefix_hits = 0
        self.peak_live = 0        # high-water mark of referenced blocks

    # -- capacity -----------------------------------------------------------

    @property
    def n_free(self) -> int:
        """Blocks allocatable right now (free list + evictable cached)."""
        return len(self._free) + len(self._cached)

    @property
    def n_live(self) -> int:
        """Blocks with at least one live reference."""
        return int((self.refcount > 0).sum())

    # -- alloc / refcount ---------------------------------------------------

    def alloc(self) -> int:
        """Allocate a private (refcount 1, unregistered) block; evicts the
        LRU cached prefix block if the free list is empty."""
        if self.faults.fire("pool"):
            raise InjectedPoolExhaustion("injected pool exhaustion")
        if self._free:
            bid = self._free.pop()
        elif self._cached:
            bid, _ = self._cached.popitem(last=False)   # LRU eviction
            self._forget(bid)
            self.n_evictions += 1
        else:
            raise NoFreeBlocks(
                f"pool of {self.num_blocks - 1} blocks exhausted")
        assert self.refcount[bid] == 0, bid
        self.refcount[bid] = 1
        self.peak_live = max(self.peak_live, self.n_live)
        return bid

    def incref(self, bid: int):
        if bid == TRASH_BLOCK:
            raise ValueError("cannot reference the trash block")
        if self.refcount[bid] == 0:
            # resurrecting a cached prefix block
            if bid not in self._cached:
                raise ValueError(f"block {bid} is free, cannot incref")
            del self._cached[bid]
            self.refcount[bid] = 1
            self.peak_live = max(self.peak_live, self.n_live)
            return
        self.refcount[bid] += 1

    def decref(self, bid: int):
        if bid == TRASH_BLOCK:
            return
        if self.refcount[bid] <= 0:
            raise ValueError(f"double free of block {bid}")
        self.refcount[bid] -= 1
        if self.refcount[bid] == 0:
            if bid in self._block_key:
                # registered prefix block: retain content, LRU-evictable
                self._cached[bid] = None
            else:
                self._free.append(bid)

    def is_registered(self, bid: int) -> bool:
        """Is this block's content indexed by the prefix trie?  Registered
        blocks are immutable — writers must copy-on-write them."""
        return bid in self._block_key

    def _forget(self, bid: int):
        """Drop a block's trie registration (its content is being reused)."""
        key = self._block_key.pop(bid, None)
        if key is None:
            return
        if self._trie.get(key) == bid:
            del self._trie[key]
            parent, toks = key
            kids = self._children.get(parent)
            if kids is not None and kids.get(toks) == bid:
                del kids[toks]
                if not kids:
                    self._children.pop(parent, None)

    # -- prefix trie --------------------------------------------------------

    def register(self, parent_key: Optional[tuple], tokens: Tuple[int, ...],
                 bid: int) -> Tuple[tuple, int]:
        """Register a *full* block's token content under its parent chain.

        Returns ``(key, canonical_bid)``.  If an identical block is already
        registered (e.g. two requests with the same prompt admitted in one
        prefill group), the existing block is the canonical one: the caller
        should swap its table entry to it (incref canonical / decref own).
        """
        if len(tokens) != self.block_size:
            raise ValueError("only full blocks are registered in the trie")
        key = (parent_key, tuple(int(t) for t in tokens))
        existing = self._trie.get(key)
        if existing is not None and existing != bid:
            return key, existing
        self._trie[key] = bid
        self._children.setdefault(parent_key, {})[key[1]] = bid
        self._block_key[bid] = key
        return key, bid

    def match_prefix(self, tokens: Sequence[int], *, peek: bool = False):
        """Longest shared prefix of ``tokens`` present in the trie.

        ``peek`` inspects without side effects (no LRU touch, no hit
        counting) — the scheduler's admission budget uses it every step.

        Returns ``(full_ids, partial)``:
          * ``full_ids`` — block ids covering the first
            ``len(full_ids) * block_size`` tokens (each LRU-touched, NOT
            incref'ed — the caller adopts them via :meth:`incref`);
          * ``partial`` — ``(bid, n)`` when the remaining suffix (shorter
            than a block) is a prefix of some registered block's content: its
            first ``n`` positions hold exactly the K/V this prompt needs
            (K/V at position p depends only on tokens <= p).  Adopting it
            shares a *partial* block, so the first append into it must
            copy-on-write.  ``None`` when no such block exists.
        """
        bs = self.block_size
        toks = [int(t) for t in tokens]
        full_ids: List[int] = []
        parent: Optional[tuple] = None
        i = 0
        while i + bs <= len(toks):
            key = (parent, tuple(toks[i:i + bs]))
            bid = self._trie.get(key)
            if bid is None:
                break
            if not peek:
                self._touch(bid)
            full_ids.append(bid)
            parent = key
            i += bs
        partial = None
        rem = tuple(toks[i:])
        if rem and i + bs <= len(toks):
            rem = ()      # broke on a full-block miss: no partial to match
        if rem:
            for child_toks, bid in self._children.get(parent, {}).items():
                if child_toks[:len(rem)] == rem:
                    if not peek:
                        self._touch(bid)
                    partial = (bid, len(rem))
                    break
        if not peek and (full_ids or partial):
            self.n_prefix_hits += len(full_ids) + (1 if partial else 0)
        return full_ids, partial

    def _touch(self, bid: int):
        if bid in self._cached:
            self._cached.move_to_end(bid)


class PagedCacheManager(BaseCacheManager):
    """Block-paged decode cache with the slab manager's slot interface.

    Supported families: those whose decode cache is purely position-indexed
    KV (dense / moe / vlm).  Recurrent families (ssm / hybrid) have O(1)
    state per slot — paging buys nothing there; use the slab backend.  The
    audio family's cross K/V is not paged either.

    Prefix sharing keys on tokens alone, so a request whose prefill has
    inputs beside its tokens (per-request ``extras``: a VLM request's
    image) must neither adopt nor register trie blocks: its K/V at a
    position depends on more than the tokens up to it.  The serve loop
    lists such requests in ``unshared`` (request ids; ``admissible_prefix``
    counts no hit for them) and inserts them with ``share=False``.  The
    reference keys them on tokens too, and a VLM request there adopts the
    blocks of another request with the same tokens and another image.
    """

    def __init__(self, cfg, n_slots: int, cache_T: int, *,
                 block_size: int = 16, num_blocks: Optional[int] = None,
                 executor, telemetry=None, faults=None):
        from repro_torch.serving.telemetry import NULL_TELEMETRY
        if not api.supports_paged(cfg):
            raise ValueError(
                f"cache_backend='paged' supports position-indexed KV "
                f"families (dense/moe/vlm), not {cfg.family!r}; use 'slab'")
        self.telemetry = telemetry if telemetry is not None else NULL_TELEMETRY
        self.block_size = block_size
        # blocks per sequence: logical capacity rounded up to whole blocks
        self.blocks_per_seq = -(-cache_T // block_size)
        if num_blocks is None:
            # same HBM as the slab pool by default (+1 for the trash block)
            num_blocks = n_slots * self.blocks_per_seq + 1
        super().__init__(cfg, n_slots)
        self.num_blocks = num_blocks
        self.pool = BlockPool(num_blocks, block_size, faults=faults)
        # device ops (page allocation, the in-place scatter insert and the
        # copy-on-write block copy) live behind the executor
        self.executor = executor
        self.pages = executor.zeros_paged_cache(num_blocks, block_size)
        # per-slot block tables, unset entries point at the trash block
        self.tables = np.full((n_slots, self.blocks_per_seq), TRASH_BLOCK,
                              np.int32)
        self._n_blocks_of = np.zeros(n_slots, np.int32)   # live table entries
        self.n_preemptions = 0
        #: request ids that neither match nor register trie blocks
        self.unshared: frozenset = frozenset()

    # -- capacity / admission budget ---------------------------------------

    @property
    def cache_T(self) -> int:
        """Max logical context per sequence (for fits/bucketing), bounded by
        both the per-slot table and the whole pool."""
        return min(self.blocks_per_seq,
                   max(self.num_blocks - 1, 1)) * self.block_size

    @property
    def prefill_T(self) -> int:
        """Prefill caches must pad to whole blocks so ``paged_insert`` can
        slice them: the per-slot table span, in tokens."""
        return self.blocks_per_seq * self.block_size

    def fits(self, prompt_len: int, max_new_tokens: int) -> bool:
        return prompt_len + max_new_tokens <= self.cache_T

    @property
    def n_free_blocks(self) -> int:
        return self.pool.n_free

    def admissible_prefix(self, requests) -> int:
        """How many front-of-queue requests fit the current block budget
        (prefix-sharing hits counted) and free slots — the paged admission
        rule: by free-*block* budget, not worst-case slot reservation.

        The budget (``pool.n_free``) counts refcount-0 cached blocks as
        allocatable-by-eviction; a cached block CLAIMED as a prefix hit for
        an earlier request in the plan must stop counting (evicting it
        would destroy the hit that made that admission cheap), so each
        newly-claimed cached hit also debits the budget."""
        bs = self.pool.block_size
        budget = self.pool.n_free
        claimed: set = set()
        slots = self.n_free
        n = 0
        for req in requests:
            if slots == 0:
                break
            toks = req.prompt.tolist()
            hit_ids, partial = (([], None) if req.request_id in self.unshared
                                else self.pool.match_prefix(toks, peek=True))
            full, rem = divmod(len(toks), bs)
            # a partial hit ADOPTS a shared tail block, so the remainder
            # costs no fresh block at insert time (CoW pays later)
            need = (full - len(hit_ids)) + (1 if rem and partial is None
                                            else 0)
            reserve = 0
            for bid in hit_ids + ([partial[0]] if partial else []):
                if self.pool.refcount[bid] == 0 and bid not in claimed:
                    claimed.add(bid)
                    reserve += 1
            if need + reserve > budget:
                break
            budget -= need + reserve
            slots -= 1
            n += 1
        return n

    # -- slot lifecycle -----------------------------------------------------

    def free(self, slot: int):
        k = int(self._n_blocks_of[slot])
        for bid in self.tables[slot, :k]:
            self.pool.decref(int(bid))
        self.tables[slot] = TRASH_BLOCK
        self._n_blocks_of[slot] = 0
        super().free(slot)

    # -- prefill insert with prefix sharing --------------------------------

    def insert(self, slot: int, src_cache, length: int, src_index: int = 0,
               tokens: Optional[Sequence[int]] = None, share: bool = True):
        """Install request ``src_index`` of a prefill cache into ``slot``.

        ``tokens`` (the prompt) drives prefix sharing: full blocks already in
        the trie are adopted by reference (never re-written — their content
        is identical since K/V at position p depends only on tokens <= p);
        a partial-suffix hit adopts a shared block copy-on-write.  Freshly
        written full blocks are registered for future requests.  With
        ``share=False`` (a prefill with inputs beside its tokens) every
        block is private: no hit is adopted and none is registered.
        Raises :class:`NoFreeBlocks` when the pool cannot cover the miss
        suffix — the engine preempts a request and retries.
        """
        if not self._occupied[slot]:
            raise ValueError(f"slot {slot} must be alloc()ed before insert")
        if tokens is None:
            raise ValueError("paged insert needs the prompt tokens")
        bs = self.block_size
        with self.telemetry.span("match_prefix", n_tokens=int(length)):
            toks = [int(t) for t in tokens][:length]
            full_ids, partial = (self.pool.match_prefix(toks) if share
                                 else ([], None))
        n_counted_hits = len(full_ids) + (1 if partial is not None else 0)
        n_hit = len(full_ids)
        for bid in full_ids:
            self.pool.incref(bid)
        table: List[int] = list(full_ids)
        keys: List[Optional[tuple]] = [None]
        for j, bid in enumerate(full_ids):
            keys.append((keys[j], tuple(toks[j * bs:(j + 1) * bs])))
        n_total = -(-length // bs)
        fresh: List[int] = []
        adopted_partial = partial is not None
        if adopted_partial:
            # match_prefix only returns a partial when every full block hit,
            # so this is always the request's final (tail) block
            self.pool.incref(partial[0])
            table.append(partial[0])
        try:
            while len(table) < n_total:
                bid = self.pool.alloc()
                fresh.append(bid)
                table.append(bid)
        except NoFreeBlocks:
            for bid in table:
                self.pool.decref(bid)
            # roll back the hit count too: the engine preempts and RETRIES
            # this insert, which re-counts the same hits — without this the
            # prefix-sharing metric inflates under memory pressure
            self.pool.n_prefix_hits -= n_counted_hits
            raise
        # one scatter at fixed (blocks_per_seq,) shape: hit blocks are
        # redirected to the trash block so they are NEVER written in place
        ids = np.full(self.blocks_per_seq, TRASH_BLOCK, np.int32)
        skip = n_hit + (1 if adopted_partial else 0)
        ids[skip:n_total] = table[skip:n_total]
        try:
            with self.telemetry.span("block_insert", slot=slot,
                                     n_blocks=n_total - skip,
                                     prefix_hits=n_counted_hits):
                self.pages = self.executor.paged_insert(self.pages, src_cache,
                                                        ids, src_index)
        except Exception:
            # the device scatter failed (e.g. out of memory) AFTER the table
            # refs were taken: release them or the pool leaks every block
            # this request claimed
            for bid in table:
                self.pool.decref(bid)
            self.pool.n_prefix_hits -= n_counted_hits
            raise
        # register freshly written FULL blocks; on a same-content collision
        # (two identical prompts in one prefill group) swap to the canonical
        # block so the copies share
        with self.telemetry.span("register", n_blocks=n_total - skip):
            for j in range(skip, n_total if share else skip):
                if (j + 1) * bs > length:
                    break   # trailing partial block: content not yet final
                key, canon = self.pool.register(keys[j], tuple(
                    toks[j * bs:(j + 1) * bs]), table[j])
                if canon != table[j]:
                    self.pool.incref(canon)
                    self.pool.decref(table[j])
                    table[j] = canon
                keys.append(key)
        self.tables[slot, :n_total] = table
        self.tables[slot, n_total:] = TRASH_BLOCK
        self._n_blocks_of[slot] = n_total
        self.lengths[slot] = length

    # -- decode-step support ------------------------------------------------

    def prepare_append(self, slots, counts=None) -> Optional[int]:
        """Make sure every slot in ``slots`` can write its next ``n``
        tokens (positions ``lengths[slot] .. lengths[slot] + n - 1``; ``n``
        is 1 for the classic decode step, ``counts[i]`` per slot for a
        speculative verify that appends the committed token plus drafts):
        allocate new tail blocks at block boundaries, copy-on-write a
        shared tail block on first divergent write.  Speculative overhang
        past the per-slot table span is NOT an error — those writes
        redirect to the trash block in ``decode_step_paged``/``verify_step_
        paged`` and can never be committed (``fits`` bounds the committed
        length).  Returns the first slot that could NOT be satisfied (pool
        dry — caller preempts and retries), or None when all are ready."""
        if counts is None:
            counts = [1] * len(slots)
        for s, n in zip(slots, counts):
            pos = int(self.lengths[s])
            first_bi = pos // self.block_size
            last_bi = (pos + max(int(n), 1) - 1) // self.block_size
            for bi in range(first_bi, last_bi + 1):
                if bi >= self.blocks_per_seq:
                    if bi == first_bi:
                        # even the COMMITTED next token has no table entry
                        # left: a real capacity bug, not spec overhang
                        raise RuntimeError(
                            f"slot {s} exceeded its block table")
                    break
                if bi >= self._n_blocks_of[s]:
                    try:
                        bid = self.pool.alloc()
                    except NoFreeBlocks:
                        return s
                    self.tables[s, bi] = bid
                    self._n_blocks_of[s] = bi + 1
                else:
                    bid = int(self.tables[s, bi])
                    if (self.pool.refcount[bid] > 1
                            or self.pool.is_registered(bid)):
                        # shared (or registered immutable prefix) block:
                        # first divergent write copies it — never write in
                        # place
                        try:
                            new = self.pool.alloc()
                        except NoFreeBlocks:
                            return s
                        try:
                            with self.telemetry.span("cow", slot=s,
                                                     src=bid, dst=new):
                                self.pages = self.executor.copy_block(
                                    self.pages, new, bid)
                        except Exception:
                            # device copy failed: the fresh private block
                            # would leak (nothing references it yet)
                            self.pool.decref(new)
                            raise
                        self.pool.decref(bid)
                        self.tables[s, bi] = new
                        self.pool.n_cow += 1
        return None

    def release_tail(self, slot: int):
        """Speculative rollback: free whole blocks past the slot's last
        committed position (``lengths[slot]`` counts valid K/V entries).
        A freed block was by construction allocated privately for the
        rejected draft span — ``prepare_append`` copies any shared or
        trie-registered block before the verify step writes it, so a
        rewind can never mutate or release shared content in place; this
        is asserted, not assumed."""
        n_keep = -(-int(self.lengths[slot]) // self.block_size)
        k = int(self._n_blocks_of[slot])
        if k > n_keep:
            self.telemetry.instant("release_tail", slot=slot,
                                   n_blocks=k - n_keep)
        for bi in range(n_keep, k):
            bid = int(self.tables[slot, bi])
            if (self.pool.refcount[bid] != 1
                    or self.pool.is_registered(bid)):
                raise RuntimeError(
                    f"speculative rollback would release shared block "
                    f"{bid} (slot {slot}): CoW invariant violated")
            self.pool.decref(bid)
            self.tables[slot, bi] = TRASH_BLOCK
        self._n_blocks_of[slot] = min(k, n_keep)

    def block_tables_device(self) -> torch.Tensor:
        """The (n_slots, blocks_per_seq) int32 tables on the device (a copy:
        the host tables change while a step may still read them)."""
        return self.executor.put(self.tables.copy())

    def update(self, new_cache):
        self.pages = new_cache

    @property
    def cache(self):
        return self.pages

    # -- introspection ------------------------------------------------------

    def blocks_in_use(self) -> int:
        return self.pool.n_live
