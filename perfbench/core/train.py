"""A training cell: quantization-aware fine-tuning of a Qwen2 model through
the port's ``make_train_step``, then checked against the plain reference.

Set-up makes the weights from the seed on the device, the optimizer state
and the train step, and drives that one object through its first steps
(``check_steps``) with the window's own call and feed; their losses, the
first gradient as the optimizer got it (its first moment over 1 - b1) and
every leaf's change after them are what the check compares.  The window
then runs the same object's steps back to back on fresh batches.
"""

from __future__ import annotations

import gc
import statistics
import time
from typing import List

from perfbench.core import run as R
from perfbench.core.program import arch_config
from perfbench.core.run import RunData
from perfbench.core.weights import leaf_specs, make_flat, make_leaf, nest
from perfbench.core.work import Qwen2Work


def _flat_name(path: str) -> str:
    return path.replace("/", ".")


class TrainCell:
    def __init__(self, cell: str, config: dict, mix: dict, *, seed: int,
                 seconds: float, trace: bool, device: str, t_start: float):
        self.cell, self.config, self.mix = cell, config, mix
        self.model = config["model"]
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device = device
        self.t_start = t_start
        self.work = Qwen2Work(self.model)
        self.vocab = int(self.model["vocab_size"])
        self.rows, self.seq = int(mix["rows"]), int(mix["seq_len"])
        self.gen = R.generator(mix["kind"])

    def _sync(self) -> None:
        if self.device != "cpu":
            import torch
            torch.cuda.synchronize()

    def _batch(self, step: int) -> dict:
        import torch
        b = self.gen.batch(self.mix, self.vocab, self.seed, step)
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in b.items()}

    def setup(self, sabotage=None) -> None:
        import torch
        from repro_torch.train import optimizer as opt_lib
        from repro_torch.train.train_loop import TrainConfig, make_train_step
        cfg = dict(self.config,
                   program=dict(self.config["program"],
                                matmul_mode=self.mix["matmul_mode"]))
        self.arch = arch_config(cfg)
        tc = TrainConfig(total_steps=int(self.mix["optimizer"]
                                         ["total_steps"]),
                         grad_accum=int(self.mix["grad_accum"]),
                         ckpt_every=10 ** 9,
                         optimizer=opt_lib.OptimizerConfig(
                             **self.mix["optimizer"]))
        self.tc = tc
        self.b1 = tc.optimizer.b1
        self.params = nest(make_flat(self.model, self.seed, self.device))
        self.opt = opt_lib.init_state(self.params)
        self.err = torch.zeros(1, device=self.device)
        self.step_fn = make_train_step(self.arch, tc)
        if sabotage is not None:
            sabotage(self)
        self.first = self._first_steps()

    def _step(self, step: int):
        self.params, self.opt, self.err, m = self.step_fn(
            self.params, self.opt, self.err, self._batch(step), 0.0)
        return m

    def _first_steps(self) -> dict:
        """The check's steps, through the window's own call."""
        import torch
        from repro_torch.tree import leaf_paths
        losses, first_grad = [], {}
        for step in range(1, int(self.mix["check_steps"]) + 1):
            m = self._step(step)
            losses.append(float(m["loss"]))
            if step == 1:
                first_grad = {
                    _flat_name(p): float(t.norm()) / (1 - self.b1)
                    for p, t in leaf_paths(self.opt["m"])}
        self._sync()
        change = {}
        masters = dict(leaf_paths(self.opt["master"]))
        for i, (path, shape, dtype, kind, std) in enumerate(
                leaf_specs(self.model)):
            p0 = make_leaf(self.seed, i, shape, dtype, kind, std,
                           self.device).to(torch.float32)
            change[path] = float((masters[path.replace(".", "/")]
                                  - p0).norm())
            del p0
        return {"losses": losses, "first_grad": first_grad,
                "change": change}

    def run(self) -> RunData:
        import torch
        step = int(self.mix["check_steps"]) + 1
        tokens = self.rows * self.seq
        self._sync()
        if self.device != "cpu":
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        data = RunData(cell=self.cell, kind="train", config=self.config,
                       mix=self.mix, work=self.work, t0=t0,
                       t1=t0 + self.seconds, setup_s=t0 - self.t_start)
        plan = self.mix["trace"]
        prof, tr = None, [None, None]
        traced_steps: List[tuple] = []
        while True:
            now = time.perf_counter()
            if now >= data.t1:
                break
            if (self.trace and prof is None
                    and now >= t0 + plan["start_share"] * self.seconds):
                from torch.profiler import ProfilerActivity, profile
                acts = [ProfilerActivity.CPU]
                if self.device != "cpu":
                    acts.append(ProfilerActivity.CUDA)
                prof = profile(activities=acts)
                prof.start()
                tr[0] = time.perf_counter()
            self._step(step)
            self._sync()
            end = time.perf_counter()
            data.steps.append((end, tokens))
            step += 1
            if prof is not None and tr[1] is None:
                traced_steps.append((self.rows, self.seq))
                if end >= tr[0] + plan["seconds"]:
                    tr[1] = end
                    prof.stop()
        if prof is not None and tr[1] is None:
            tr[1] = time.perf_counter()
            prof.stop()
        if self.device != "cpu":
            data.window_peak_bytes = int(torch.cuda.max_memory_allocated())
            data.memory_peak_bytes = data.window_peak_bytes
        if prof is not None:
            from perfbench.core.trace import reduce_profile
            data.trace = reduce_profile(prof)
            data.trace["window_s"] = tr[1] - tr[0]
            data.trace["steps"] = traced_steps
        return data

    def release(self) -> None:
        import torch
        self.params = self.opt = self.err = self.step_fn = None
        gc.collect()
        if self.device != "cpu":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    def check(self, data: RunData, control: bool = False) -> dict:
        from perfbench.reference.qwen2_train import train_readings
        flat = make_flat(self.model, self.seed, self.device)
        batches = [self._batch(s)
                   for s in range(1, int(self.mix["check_steps"]) + 1)]
        qmax = int(self.config["check"]["qmax"])
        ref = train_readings(flat, self.model, self.mix, batches, qmax)
        out, self.detail = compare(self.first, ref)
        if control:
            low = train_readings(flat, self.model, self.mix, batches,
                                 int(self.config["check"]["control_qmax"]))
            ctl, _ = compare(low, ref)
            out.update({f"control_{k}": v for k, v in ctl.items()})
        out["sampled"] = float(len(batches))
        return out


def compare(got: dict, ref: dict):
    """(the numbers, what lies behind them).  The numbers: the first
    step's loss gap over the reference's loss (the later steps' are in
    the detail: Adam turns the sign noise of near-zero gradients into
    full-size steps, so the trajectories part by more than rounding); by
    the worst leaf, the gap between the norms of the first gradient, and
    of the change after the check's steps, over the larger of that leaf's
    reference norm and the median leaf's.  Leaves whose reference
    gradient is under a thousandth of the median leaf's (moved by
    round-off alone under Adam) are left out of the change.  A cell's
    limits file names the numbers it compares."""
    losses = [abs(a - b) / abs(b)
              for a, b in zip(got["losses"], ref["losses"])]
    g_ref = ref["first_grad"]
    g_med = statistics.median(g_ref.values())
    grads = {k: abs(got["first_grad"][k] - g) / max(g, g_med)
             for k, g in g_ref.items()}
    moved = [k for k, g in g_ref.items() if g >= 1e-3 * g_med]
    c_ref = ref["change"]
    c_med = statistics.median(c_ref[k] for k in moved)
    changes = {k: abs(got["change"][k] - c_ref[k]) / max(c_ref[k], c_med)
               for k in moved}
    g_worst = max(grads, key=grads.get)
    c_worst = max(changes, key=changes.get)
    detail = {"step_loss_gaps": losses, "worst_grad_leaf": g_worst,
              "worst_change_leaf": c_worst,
              "change_gap": changes[c_worst],
              "left_out_of_change": sorted(set(g_ref) - set(moved))}
    return {"loss_gap": losses[0], "grad_gap": grads[g_worst],
            "change_gap": changes[c_worst]}, detail
