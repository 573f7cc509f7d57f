"""Training loop (port of ``repro/train/train_loop.py``): the train step
(gradient accumulation, optional compressed gradients with error
feedback, NaN/spike step rejection), checkpoint and resume, and a
preemption-safe exit.

The step reads the loss on the host once, after the gradients and before
the update, and commits by the reference's rule: a non-finite loss, or
one above ``spike_factor`` x the running median, keeps the ORIGINAL
params, optimizer state and error state.  The reference computes the new
state and selects old or new on the device (its buffers are donated); the
port decides first and updates in place only when the step commits, so a
rejected step writes nothing and no second copy of the float32 state
exists.  That read is the one sync the reference's ``Trainer`` pays too
(``float(metrics["loss"])``).
"""

from __future__ import annotations

import dataclasses
import logging
import math
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.data.pipeline import DataConfig, PrefetchingLoader
from repro_torch.device import resolve_device
from repro_torch.distributed import compression
from repro_torch.models import api
from repro_torch.runtime.fault_tolerance import PreemptionGuard, with_retries
from repro_torch.train import optimizer as opt_lib
from repro_torch.tree import leaves, tree_map, unflatten

log = logging.getLogger("repro_torch.train")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    total_steps: int = 200
    grad_accum: int = 1
    ckpt_every: int = 50
    ckpt_dir: str = "build/ckpt"     # relative to the working directory
    ckpt_keep: int = 3
    compress_grads: bool = False     # int8 + error-feedback cross-pod model
    log_every: int = 10
    spike_factor: float = 4.0        # reject loss > factor x running median
    max_consecutive_skips: int = 8
    optimizer: opt_lib.OptimizerConfig = opt_lib.OptimizerConfig()


def batch_to_device(batch: Dict, device) -> Dict:
    """A data-pipeline batch (numpy) as tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v), device=device)
            for k, v in batch.items()}


def make_train_step(arch_cfg, train_cfg: TrainConfig) -> Callable:
    """(params, opt_state, err_state, batch, loss_median) -> (params,
    opt_state, err_state, metrics), the state updated in place when the
    step commits and untouched when it does not.

    The batch's leaves are split into ``grad_accum`` micro-batches along
    axis 0; their gradients are summed in float32 and divided by the
    count (with one micro-batch the gradients keep the params' dtype, as
    the reference's).  metrics: the loss function's of the last
    micro-batch, ``lr``, ``grad_norm`` (before clipping), ``loss`` (the
    micro-batches' mean) and ``committed`` (1.0 or 0.0)."""
    accum = train_cfg.grad_accum
    opt_cfg = train_cfg.optimizer

    def grads_of(params, batch):
        flat = leaves(params)
        for p in flat:
            if p.is_floating_point():
                p.requires_grad_(True)
        trained = [p for p in flat if p.requires_grad]
        with torch.enable_grad():
            loss, metrics = api.loss_fn(params, arch_cfg, batch)
            got = iter(torch.autograd.grad(loss, trained, allow_unused=True))
        # an unused leaf (a bp_* dense weight, whose gradient the STE
        # makes zero) gets an exact zero, as in the reference
        grads = []
        for p in flat:
            g = next(got) if p.requires_grad else None
            grads.append(torch.zeros_like(p) if g is None else g)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            grads

    def compute_grads(params, batch):
        if accum == 1:
            return grads_of(params, batch)
        total, acc = None, None
        for i in range(accum):
            mb = {k: v.chunk(accum)[i] for k, v in batch.items()}
            loss, metrics, grads = grads_of(params, mb)
            if acc is None:
                total = loss.to(torch.float32)
                acc = [g.to(torch.float32) for g in grads]
            else:
                total = total + loss
                for a, g in zip(acc, grads):
                    a.add_(g)
        for a in acc:
            a.div_(accum)
        return total / accum, metrics, acc

    @torch.no_grad()
    def step(params, opt_state, err_state, batch, loss_median):
        loss, metrics, grads = compute_grads(params, batch)
        loss_f = float(loss)           # the step's one host read
        median = float(loss_median)
        commit = math.isfinite(loss_f) and (
            median <= 0 or loss_f <= train_cfg.spike_factor * median)
        grads = unflatten(params, grads)
        new_err = None
        if train_cfg.compress_grads:
            # wire-format model of the cross-pod compressed all-reduce:
            # quantize + error-feedback the contribution being reduced
            grads, new_err = compression.compress_tree_with_feedback(
                grads, err_state)
        if commit:
            _, _, opt_metrics = opt_lib.apply_updates(opt_cfg, params,
                                                      opt_state, grads)
            if new_err is not None:
                tree_map(lambda e, n: e.copy_(n), err_state, new_err)
        else:
            lr, gnorm, _ = opt_lib.update_metrics(opt_cfg, opt_state, grads)
            opt_metrics = {"lr": lr, "grad_norm": gnorm}
        metrics = {**metrics, **opt_metrics, "loss": loss,
                   "committed": torch.tensor(float(commit))}
        return params, opt_state, err_state, metrics

    return step


class Trainer:
    """Checkpointed, fault-tolerant driver around the train step.  The
    params are drawn with ``api.init`` from ``init_seed`` on ``device``
    (default the GPU), or given as ``params``."""

    def __init__(self, arch_cfg, train_cfg: TrainConfig, data_cfg: DataConfig,
                 init_seed: int = 0, install_signals: bool = False,
                 device="cuda", params=None):
        self.arch_cfg = arch_cfg
        self.cfg = train_cfg
        self.data_cfg = data_cfg
        self.device = resolve_device(device)
        self.ckpt = CheckpointManager(train_cfg.ckpt_dir,
                                      keep=train_cfg.ckpt_keep)
        self.step_fn = make_train_step(arch_cfg, train_cfg)
        self.params = (params if params is not None else
                       api.init(arch_cfg, seed=init_seed, device=self.device))
        self.opt_state = opt_lib.init_state(self.params)
        self.err_state = (compression.init_error_state(self.params)
                          if train_cfg.compress_grads else
                          torch.zeros((1,), device=self.device))
        self.start_step = 0
        #: seconds the checkpoint restore took (None: a fresh start)
        self.resume_s: Optional[float] = None
        self.guard = PreemptionGuard(install=install_signals)
        self.loss_history: list[float] = []
        self.total_skips = 0
        self._maybe_resume()

    # -- checkpoint plumbing -------------------------------------------------
    def _state_tree(self):
        return {"params": self.params, "opt": self.opt_state,
                "err": self.err_state}

    def _maybe_resume(self):
        latest = self.ckpt.latest_step()
        if latest is None:
            return
        t0 = time.perf_counter()
        restored = with_retries(
            lambda: self.ckpt.restore(latest, self._state_tree()))
        self.params = restored["params"]
        self.opt_state = restored["opt"]
        self.err_state = restored["err"]
        self.start_step = latest
        self.resume_s = time.perf_counter() - t0
        log.info("resumed from step %d in %.1f s", latest, self.resume_s)

    def save(self, step: int, blocking: bool = False):
        with_retries(lambda: self.ckpt.save(step, self._state_tree(),
                                            blocking=blocking))

    # -- main loop ---------------------------------------------------------
    def run(self, on_metrics: Optional[Callable[[int, Dict], None]] = None):
        loader = PrefetchingLoader(self.data_cfg, start_step=self.start_step,
                                   q_depth=2)
        history = []
        consecutive_skips = 0
        try:
            step = self.start_step
            while step < self.cfg.total_steps and not self.guard.requested:
                batch = batch_to_device(next(loader), self.device)
                median = (float(np.median(self.loss_history[-32:]))
                          if len(self.loss_history) >= 16 else 0.0)
                t0 = time.perf_counter()
                self.params, self.opt_state, self.err_state, metrics = (
                    self.step_fn(self.params, self.opt_state, self.err_state,
                                 batch, median))
                loss = float(metrics["loss"])
                committed = bool(metrics["committed"] > 0)
                if committed:
                    self.loss_history.append(loss)
                    consecutive_skips = 0
                else:
                    self.total_skips += 1
                    consecutive_skips += 1
                    log.warning("step rejected (loss=%s)", loss)
                    if consecutive_skips > self.cfg.max_consecutive_skips:
                        raise RuntimeError(
                            "too many consecutive rejected steps; "
                            "restore from an earlier checkpoint")
                step += 1
                metrics["step_time_s"] = time.perf_counter() - t0
                history.append((step, loss))
                if on_metrics and step % self.cfg.log_every == 0:
                    on_metrics(step, {k: float(v) for k, v in metrics.items()
                                      if np.ndim(v) == 0})
                if step % self.cfg.ckpt_every == 0:
                    self.save(step)
            self.save(step, blocking=True)
            return step, history
        finally:
            loader.close()
            self.ckpt.wait()
