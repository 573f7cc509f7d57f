"""Speculative decoding: drafters for the multi-token verify step (port of
``repro/serving/speculative.py``).

A cheap **drafter** guesses the next K tokens per slot, one batched
``verify_step`` checks all of them in a single target-model forward pass,
and each slot **commits a variable number of tokens per step** (1 when the
first draft misses, up to K+1 when every draft lands): BitParticle's
variable per-unit work, one level up, absorbed by the per-slot
``cache_len`` machinery.

  * :class:`PromptLookupDrafter`: weight-free n-gram lookup over the slot's
    own context (prompt + generated).  Pure numpy, no device work.
  * :class:`ModelDrafter`: a same-family draft model (its own config and
    params) runs K+1 greedy one-token decode steps over its OWN
    slot-aligned slab cache, batched across slots, through a draft
    :class:`~repro_torch.serving.executor.SingleDeviceExecutor`.

With greedy decoding the accept rule commits exactly the token stream the
non-speculative engine would emit, so speculation changes step counts,
never outputs; drafting is greedy-only.  Rollback lives in the cache
managers: the slab store advances ``cache_len`` by the committed count, the
paged store also releases whole tail blocks past it (``release_tail``).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from repro_torch.serving.cache_manager import CacheManager
from repro_torch.serving.faults import NULL_INJECTOR
from repro_torch.serving.scheduler import prefill_bucket_len
from repro_torch.serving.telemetry import NULL_TELEMETRY


class Drafter:
    """Per-slot draft-token proposer driven by the ``ServeLoop``.

    The lifecycle hooks mirror the target cache manager's slot lifecycle so
    a stateful drafter (the model drafter's own KV cache) stays aligned with
    the slots it drafts for; the weight-free drafter ignores them.
    ``propose_all`` is called once per verify step with every decode slot
    that rides it and returns at most ``caps[slot]`` tokens per slot."""

    # fault-injection handle (threaded by the serve loop like telemetry);
    # ``propose_all`` implementations check the "drafter" site on entry:
    # the loop catches the raised ``DrafterFault`` and runs the step
    # draft-less (degrading to no speculation after repeats)
    faults = NULL_INJECTOR

    name = "none"

    def propose_all(self, requests: Dict[int, object],
                    caps: Dict[int, int]) -> Dict[int, np.ndarray]:
        raise NotImplementedError

    def on_admit(self, slot: int, req) -> None:     # noqa: B027
        """A request was installed into ``slot`` (after target prefill)."""

    def on_free(self, slot: int) -> None:           # noqa: B027
        """``slot`` was released (finish or preemption)."""

    def observe_commit(self, slot: int, committed_len: int) -> None:  # noqa: B027
        """The verify step committed tokens: the slot's valid context
        length (prompt + generated - 1 unfed token) is now
        ``committed_len``.  Stateful drafters rewind here."""

    def use_matmul_backend(self, backend: str) -> None:  # noqa: B027
        """The kernel rung moved this serve's kernels to ``backend``; a
        drafter that runs a model follows it."""


def _context(req) -> np.ndarray:
    """The slot's full token context: prompt + every generated token
    (including the last, not-yet-fed one)."""
    return np.concatenate([np.asarray(req.prompt, np.int64),
                           np.asarray(req.tokens, np.int64)])


class PromptLookupDrafter(Drafter):
    """Weight-free prompt-lookup (n-gram) drafting: the longest suffix
    n-gram of the context (``max_ngram`` down to ``min_ngram``) is searched
    for an earlier occurrence, the rightmost one wins, and the tokens that
    followed it are the proposal."""

    name = "prompt_lookup"

    def __init__(self, num_draft_tokens: int, *, max_ngram: int = 3,
                 min_ngram: int = 1):
        if not 1 <= min_ngram <= max_ngram:
            raise ValueError("need 1 <= min_ngram <= max_ngram")
        self.k = int(num_draft_tokens)
        self.max_ngram = int(max_ngram)
        self.min_ngram = int(min_ngram)

    def _lookup(self, ctx: np.ndarray, k: int) -> np.ndarray:
        L = len(ctx)
        for n in range(min(self.max_ngram, L - 1), self.min_ngram - 1, -1):
            pat = ctx[L - n:]
            # rightmost earlier occurrence of the suffix n-gram; the tokens
            # that followed it are the proposal (they may reach into the
            # suffix itself: that is how a repeat extends)
            for i in range(L - n - 1, -1, -1):
                if np.array_equal(ctx[i:i + n], pat):
                    return ctx[i + n:i + n + k].astype(np.int32)
        return np.zeros(0, np.int32)

    def propose_all(self, requests, caps):
        self.faults.check("drafter")
        return {slot: self._lookup(_context(req),
                                   min(self.k, caps.get(slot, self.k)))
                for slot, req in requests.items()}


class ModelDrafter(Drafter):
    """A same-family draft model with its own slot-aligned slab cache.

    ``on_admit`` prefills the prompt through the draft executor;
    ``propose_all`` runs K+1 batched greedy decode steps (feeding each
    slot's last committed token, then its own proposals): the extra feed
    integrates the K-th proposal's K/V, so a full acceptance (K+1 commits)
    still leaves the draft cache covering every committed position.
    ``observe_commit`` rewinds the draft ``cache_len`` to the committed
    context length, which IS the rollback (a slab cache masks everything
    past ``cache_len``)."""

    name = "model"

    def __init__(self, draft_cfg, executor, n_slots: int, cache_T: int,
                 num_draft_tokens: int, target_cfg=None, telemetry=None):
        if target_cfg is not None:
            if draft_cfg.family != target_cfg.family:
                raise ValueError(
                    f"draft family {draft_cfg.family!r} != target family "
                    f"{target_cfg.family!r}: the draft must propose from "
                    f"the same token space")
            if draft_cfg.vocab_size != target_cfg.vocab_size:
                raise ValueError(
                    f"draft vocab {draft_cfg.vocab_size} != target vocab "
                    f"{target_cfg.vocab_size}")
        self.cfg = draft_cfg
        self.executor = executor
        self.telemetry = telemetry if telemetry is not None else NULL_TELEMETRY
        self.k = int(num_draft_tokens)
        # the draft cache must absorb the full speculative overhang
        # (cache_len transiently reaches committed + K + 1 during a
        # proposal run)
        self.cm = CacheManager(draft_cfg, n_slots, cache_T + self.k + 1,
                               executor=executor)
        self.n_slots = n_slots
        self._decode = executor.decode_sample_fn(0.0)   # greedy, slab
        self._zero_seeds = np.zeros(n_slots, np.int64)
        self._zero_counts = np.zeros(n_slots, np.int64)

    # -- lifecycle ----------------------------------------------------------

    def on_admit(self, slot: int, req):
        self.cm.alloc(slot)     # draft slots mirror target slots 1:1
        # right-pad the prompt to its pow2 bucket (ragged prefill: only the
        # cache matters here)
        L = req.prompt_len
        pad_to = prefill_bucket_len(L, self.cm.cache_T)
        toks = np.zeros((1, pad_to), np.int32)
        toks[0, :L] = np.asarray(req.prompt, np.int32)
        with self.telemetry.span("draft_prefill", slot=slot, pad_to=pad_to):
            _, cache = self.executor.prefill({"tokens": toks},
                                             self.cm.cache_T,
                                             prompt_lens=np.asarray([L]))
            self.cm.insert(slot, cache, L)

    def on_free(self, slot: int):
        if self.cm._occupied[slot]:
            self.cm.free(slot)

    def observe_commit(self, slot: int, committed_len: int):
        self.cm.lengths[slot] = committed_len

    def use_matmul_backend(self, backend: str):
        self.executor = self.executor.with_matmul_backend(backend)
        self.cm.executor = self.executor
        self._decode = self.executor.decode_sample_fn(0.0)

    # -- drafting -----------------------------------------------------------

    def propose_all(self, requests, caps):
        self.faults.check("drafter")
        slots = list(requests.keys())
        if not slots:
            return {}
        feed = np.zeros(self.n_slots, np.int32)
        for s, req in requests.items():
            feed[s] = req.tokens[-1]        # last committed, not yet fed
        rows = []
        with self.telemetry.span("draft_propose", n_slots=len(slots),
                                 k=self.k):
            for _ in range(self.k + 1):
                step = {"tokens": feed[:, None],
                        "cache_len": self.cm.cache_len_vector()}
                toks, new_cache = self._decode(self.cm.cache, step,
                                               self._zero_seeds,
                                               self._zero_counts)
                self.cm.update(new_cache)
                self.cm.advance(slots)
                feed = toks.cpu().numpy().astype(np.int32)
                self.telemetry.count("d2h_bytes", feed.nbytes)
                rows.append(feed)
        grid = np.stack(rows, axis=1)       # (n_slots, K+1) greedy chain
        return {s: grid[s, :min(self.k, caps.get(s, self.k))].astype(np.int32)
                for s in slots}


def make_drafter(serve_cfg, engine, *, n_slots: int, cache_T: int,
                 telemetry=None) -> Optional[Drafter]:
    """Build the drafter selected by ``ServeConfig.draft`` for one serve
    loop (``None`` for ``draft='none'``).  The model drafter runs on the
    engine's draft executor (``ServingEngine.draft_executor``)."""
    draft = getattr(serve_cfg, "draft", "none") or "none"
    if draft == "none":
        return None
    from repro_torch.models import api
    if not api.supports_verify(engine.cfg):
        raise ValueError(
            f"family {engine.cfg.family!r} has no multi-token verify path: "
            f"speculative decoding needs position-indexed KV that can be "
            f"rewound on rejection; serve with draft='none'")
    if serve_cfg.temperature > 0:
        raise ValueError(
            "speculative decoding is greedy-only (temperature == 0): the "
            "accept rule compares argmax streams; temperature sampling "
            "would need rejection resampling")
    k = int(serve_cfg.num_draft_tokens)
    if k < 1:
        raise ValueError("num_draft_tokens must be >= 1 when drafting")
    if draft == "prompt_lookup":
        return PromptLookupDrafter(k)
    if draft == "model":
        executor = engine.draft_executor
        if executor is None:
            raise ValueError(
                "draft='model' needs a draft model: construct the engine "
                "with draft_cfg=<small ArchConfig> and draft_params")
        return ModelDrafter(engine.draft_cfg, executor, n_slots, cache_T,
                            k, target_cfg=engine.cfg, telemetry=telemetry)
    raise ValueError(f"unknown draft {draft!r}; expected "
                     f"'none', 'prompt_lookup' or 'model'")
