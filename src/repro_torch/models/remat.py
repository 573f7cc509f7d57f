"""Activation checkpointing of the training forward: the counterpart of
the reference's ``jax.checkpoint(body, policy=nothing_saveable)`` around
each scanned layer (or super-block) body.

:func:`checkpointed` runs a body under ``torch.utils.checkpoint``
(non-reentrant) while grad is enabled: the forward keeps only the body's
inputs, and the backward runs the whole body again.  Early stopping is
off, so a recomputation repeats every kernel launch of the body, and
:data:`RUNS` counts each execution of a checkpointed body, forward and
recomputation alike: a body's kernel launches times ``RUNS["body"]`` is
what a training step launches.  Without grad (serving, ``no_grad``) the
body runs plainly and is not counted.
"""

from __future__ import annotations

import threading

import torch
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

#: executions of checkpointed bodies since the last :func:`reset_runs`
RUNS = {"body": 0}
_LOCK = threading.Lock()


def reset_runs() -> None:
    RUNS["body"] = 0


def checkpointed(fn, *args, enabled: bool = True):
    """``fn(*args)``, checkpointed when ``enabled`` and grad is on."""
    if not (enabled and torch.is_grad_enabled()):
        return fn(*args)

    def counted(*a):
        with _LOCK:
            RUNS["body"] += 1
        return fn(*a)

    with set_checkpoint_early_stop(False):
        return checkpoint(counted, *args, use_reentrant=False,
                          preserve_rng_state=False)
