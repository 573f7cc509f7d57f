"""Open-loop traffic: requests due at wall-clock times, submitted when due
by a client thread whatever the program's progress (``docqa``)."""

from __future__ import annotations

from typing import List

import numpy as np

from perfbench.core.traffic import (Item, arrival_offsets, dealt, grid,
                                    rng_for)

#: the serving cell drives it from a client thread
HARNESS = "serve_open"


def schedule(mix: dict, vocab: int, seed: int, seconds: float,
             block: int) -> List[Item]:
    """Block ``block`` of an open-loop document-QA schedule: block 0 is
    the measured window [0, seconds); later blocks keep the same load
    running after it, unmeasured, until the window's requests are done.
    Each document is asked ``asks_per_document`` times by requests placed
    independently in the block; a prompt is the document then a question.
    With ``segments``, each equal run of the block gets the same share of
    gaps, document, question and answer sizes (seeds then differ in order
    within a run, not in how the load clusters)."""
    rng = rng_for(seed, 1, block)
    k = int(mix.get("segments", 1))
    due = arrival_offsets(mix["rate_per_s"], seconds, rng, k) \
        + block * seconds
    n = len(due)
    asks = int(mix.get("asks_per_document", 1))
    n_docs = -(-n // asks)
    doc_len = grid(mix["document_tokens"], n_docs, rng)
    asked = rng.permutation(np.repeat(np.arange(n_docs), asks))[:n]
    by_len = np.argsort(doc_len[asked], kind="stable")
    owner = asked[by_len[dealt(np.arange(n), k, rng)]]
    q_len = dealt(grid(mix["question_tokens"], n, rng), k, rng)
    ans = dealt(grid(mix["answer_tokens"], n, rng), k, rng)
    docs = [rng.integers(0, vocab, size=int(m), dtype=np.int64)
            for m in doc_len]
    items = []
    for i in range(n):
        q = rng.integers(0, vocab, size=int(q_len[i]), dtype=np.int64)
        prompt = np.concatenate([docs[owner[i]], q]).astype(np.int32)
        items.append(Item(index=block * 1_000_000 + i, due_s=float(due[i]),
                          prompt=prompt, max_new_tokens=int(ans[i]),
                          measured=block == 0))
    return items


