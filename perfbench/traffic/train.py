"""Training batches: one batch of token ids per optimizer step
(``qat``)."""

from __future__ import annotations

from typing import Dict

import numpy as np

from perfbench.core.traffic import rng_for

#: the training cell draws one batch a step
HARNESS = "train"


def batch(mix: dict, vocab: int, seed: int,
               step: int) -> Dict[str, np.ndarray]:
    """A training batch of Zipf-distributed token ids: the data pipeline's
    rule (Zipf unigrams over [2, vocab), copy motifs planted a short window
    later, a ``pad_fraction`` of positions padded (id 0) and masked out of
    the loss, id 1 first), with its rows drawn from (seed, step) so every
    row of every step differs."""
    rng = rng_for(seed, 3, step)
    b = int(mix["rows"])
    s = int(mix["seq_len"])
    motif = int(mix.get("motif_len", 8))
    toks = rng.zipf(mix.get("zipf_a", 1.2), size=(b, s))
    toks = 2 + (toks - 1) % (vocab - 2)
    if s > 2 * motif + 1:
        for i in range(b):
            for _ in range(max(1, s // (4 * motif))):
                src = rng.integers(0, s - 2 * motif)
                dst = rng.integers(src + motif, s - motif + 1)
                toks[i, dst:dst + motif] = toks[i, src:src + motif]
    mask = rng.random((b, s)) >= mix.get("pad_fraction", 0.0)
    toks = np.where(mask, toks, 0)
    toks[:, 0] = 1
    return {"tokens": toks.astype(np.int32), "loss_mask": mask}
