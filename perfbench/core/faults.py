"""Faults planted under a cell's timed path, to see ``correct`` come out
false (the CPU tests) and to read what each does to the numbers compared
at a cell's own size (``calibrate.py --fault``).  Each takes the cell after
its set-up and before the first step it drives."""

from __future__ import annotations

import copy


def alter_tokens(cell) -> None:
    """Serving: a token altered where it is produced (every decode step's
    tokens moved by one id)."""
    decode = cell.loop._decode_fn

    def broken(cache, step, seeds, counts):
        toks, *rest = decode(cache, step, seeds, counts)
        return ((toks + 1) % cell.arch.vocab_padded, *rest)

    cell.loop._decode_fn = broken


def kv_unchanged(cell) -> None:
    """Serving: a decode step that returns its state unchanged (the KV it
    wrote is put back as it was)."""
    decode = cell.loop._decode_fn

    def broken(cache, step, seeds, counts):
        saved = {k: v.clone() for k, v in cache.items()}
        out = decode(cache, step, seeds, counts)
        for k, v in cache.items():
            v.copy_(saved[k])
        return out

    cell.loop._decode_fn = broken


def step_unchanged(cell) -> None:
    """Training: a step that returns its state unchanged."""
    step = cell.step_fn

    def broken(params, opt, err, batch, median):
        keep = copy.deepcopy((params, opt, err))
        *_, m = step(params, opt, err, batch, median)
        return (*keep, m)

    cell.step_fn = broken


def half_batch(cell) -> None:
    """Training: half of the batch left out, the mean taken over the
    rest."""
    step = cell.step_fn

    def broken(params, opt, err, batch, median):
        half = batch["tokens"].shape[0] // 2
        return step(params, opt, err,
                    {k: v[:half] for k, v in batch.items()}, median)

    cell.step_fn = broken


def update_doubled(cell) -> None:
    """Training: the optimizer's update doubled (twice the learning rate
    the mix states, through the program's own step)."""
    import dataclasses
    from repro_torch.train.train_loop import make_train_step
    tc = cell.tc
    opt = dataclasses.replace(tc.optimizer,
                              peak_lr=2 * tc.optimizer.peak_lr)
    cell.step_fn = make_train_step(cell.arch,
                                   dataclasses.replace(tc, optimizer=opt))


FAULTS = {"alter_tokens": alter_tokens, "kv_unchanged": kv_unchanged,
          "step_unchanged": step_unchanged, "half_batch": half_batch,
          "update_doubled": update_doubled}
