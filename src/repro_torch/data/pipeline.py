"""Synthetic, deterministic, restartable token pipeline (a copy of
``repro/data/pipeline.py``: numpy only, so batches are bit-identical to
the reference's for every (seed, step, host)).

Production properties that matter at 1000+ nodes, all present here:

  * **Deterministic addressing**: batch(step, host) is a pure function of
    (seed, step, host) — restart/resume replays identically, and elastic
    re-scaling re-partitions the same global stream.
  * **Host sharding**: each host draws only its slice of the global batch.
  * **Prefetch queue**: a background thread keeps ``Q`` batches ready — the
    cluster-level analogue of the paper's per-PE operand queue (intra-group
    elasticity): compute never waits on the host if the queue is non-empty.
  * **Zero/padding awareness**: a fraction of tokens is PAD (id 0) with a
    loss mask — the value-sparsity hook (zero-value filtering analogue).

The synthetic distribution is Zipf unigrams + copy/induction motifs, so small
models measurably learn (``chip_smoke.py``'s ``train`` phase shows the loss
going down).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator, Optional

import numpy as np

PAD_ID = 0


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    motif_len: int = 8
    pad_fraction: float = 0.02
    num_hosts: int = 1
    host_id: int = 0

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.num_hosts == 0
        return self.global_batch // self.num_hosts


def _rng_for(cfg: DataConfig, step: int, host: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, host]))


def make_batch(cfg: DataConfig, step: int) -> dict:
    """The (step, host)-addressed batch: {"tokens", "loss_mask"}."""
    rng = _rng_for(cfg, step, cfg.host_id)
    b, s, v = cfg.host_batch, cfg.seq_len, cfg.vocab_size
    # Zipf unigrams over [2, v): ids 0 (pad) and 1 (bos) reserved
    toks = rng.zipf(cfg.zipf_a, size=(b, s))
    toks = 2 + (toks - 1) % (v - 2)
    # plant copy motifs: sequence repeats a short window later (induction)
    if s > 2 * cfg.motif_len + 1:
        n_motifs = max(1, s // (4 * cfg.motif_len))
        for i in range(b):
            for _ in range(n_motifs):
                src = rng.integers(0, s - 2 * cfg.motif_len)
                dst = rng.integers(src + cfg.motif_len, s - cfg.motif_len + 1)
                toks[i, dst:dst + cfg.motif_len] = toks[i, src:src + cfg.motif_len]
    mask = rng.random((b, s)) >= cfg.pad_fraction
    toks = np.where(mask, toks, PAD_ID)
    toks[:, 0] = 1  # bos
    return {"tokens": toks.astype(np.int32), "loss_mask": mask}


class PrefetchingLoader:
    """Background-thread prefetcher with bounded queue depth Q.

    ``loader.stats()`` exposes (produced, consumed, stall_events) so the
    quasi-sync trainer can report input-pipeline pressure.
    """

    def __init__(self, cfg: DataConfig, start_step: int = 0, q_depth: int = 2):
        self.cfg = cfg
        self._q: "queue.Queue[dict]" = queue.Queue(maxsize=max(q_depth, 1))
        self._step = start_step
        self._stop = threading.Event()
        self._stalls = 0
        self._consumed = 0
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = self._step
        while not self._stop.is_set():
            batch = make_batch(self.cfg, step)
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __next__(self) -> dict:
        if self._q.empty():
            self._stalls += 1
        out = self._q.get()
        self._consumed += 1
        return out

    def __iter__(self) -> Iterator[dict]:
        return self

    def stats(self):
        return {"consumed": self._consumed, "stall_events": self._stalls,
                "queue_depth": self._q.qsize()}

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
