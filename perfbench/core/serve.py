"""A serving cell: a Qwen2 model served by the port's ``ServingEngine``
under one traffic mix, then checked against the plain reference.

Set-up makes the weights from the seed on the device, builds the engine
(which quantizes them once), warms up the largest prefill the mix can send
and the decode step, sizes the paged KV pool to what is left of the card
less the configuration's headroom, and builds one ``ServeLoop``.  The
window drives ``ServeLoop.run_forever``: an open-loop mix from a client
thread that submits each request when it is due, a closed-loop mix from
the loop's step hook.  Latencies are taken from each request's due time
(open loop) and the engine's own token stamps (``wall_token_times``).

With ``trace`` a sub-window of the run is profiled, and the harness's
wrappers log each prefill's row lengths and each decode step's cache
lengths for the work counts; the untraced run carries no wrapper.
"""

from __future__ import annotations

import gc
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from perfbench.core import run as R, traffic as gen
from perfbench.core.program import arch_config, prefill_bucket
from perfbench.core.run import RunData
from perfbench.core.weights import make_flat, nest
from perfbench.core.work import Qwen2Work

#: the longest a window's request is waited for after the window closes:
#: traced docqa runs at 1.3/s drained in 47-58 s (the profiled seconds
#: leave a queue), untraced ones in 18-27 s
DRAIN_CAP_S = 120.0
TERMINAL = ("done", "cancelled", "timed_out", "failed")


class ServeCell:
    def __init__(self, cell: str, config: dict, mix: dict, *, seed: int,
                 seconds: float, trace: bool, device: str, t_start: float):
        self.cell, self.config, self.mix = cell, config, mix
        self.model = config["model"]
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device = device
        self.t_start = t_start
        self.work = Qwen2Work(self.model)
        self.prefill_log: List[tuple] = []
        self.decode_log: List[tuple] = []
        self.gen = R.generator(mix["kind"])

    # -- set-up ---------------------------------------------------------------

    def setup(self, sabotage=None) -> None:
        import torch
        from repro_torch.serving import (SchedulerConfig, ServeConfig,
                                         ServingEngine, Telemetry)
        serving = self.config["serving"]
        self.arch = arch_config(self.config)
        self.vocab = int(self.model["vocab_size"])
        self.tel = None
        if self.trace:
            # spans recorded throughout; entered as profiler ranges only
            # while the profiler runs (each range costs host time)
            self.tel = Telemetry(annotate_device=True)
            self.tel.tracer.annotate_device = False
        scfg = ServeConfig(temperature=0.0, eos_id=None,
                           cache_backend="paged",
                           block_size=int(serving["block_size"]),
                           telemetry=self.tel)
        params = nest(make_flat(self.model, self.seed, self.device))
        self.engine = ServingEngine(self.arch, params, scfg,
                                    device=self.device)
        del params
        gc.collect()
        self._sync()
        if self.device != "cpu":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        # the program's scheduler defaults, but for what the configuration
        # sets
        self.sched = SchedulerConfig(**self.config["serving"].get(
            "scheduler", {}))
        self.n_slots = int(self.mix["n_slots"])
        self.max_context = int(self.mix["max_context"])
        self._warm_up()
        self.num_blocks = self._pool_blocks()
        self.new_loop()
        if sabotage is not None:
            sabotage(self)

    def new_loop(self) -> None:
        """The window's serve loop over a fresh pool of ``num_blocks``."""
        self.loop = None
        gc.collect()
        self.loop = self.engine.make_loop(
            [], n_slots=self.n_slots, cache_T=self.max_context,
            sched_cfg=self.sched, num_blocks=self.num_blocks)
        if self.trace:
            self._wrap_for_counts()

    def _sync(self) -> None:
        if self.device != "cpu":
            import torch
            torch.cuda.synchronize()

    def _warm_up(self) -> None:
        """The largest prefill the mix can send (a full group at the
        longest padded prompt), then a short serve on a small pool: every
        kernel built and loaded, the allocator at its working peak."""
        from repro_torch.serving import Request
        rng = gen.rng_for(self.seed, 9)
        blocks_per_seq = -(-self.max_context
                           // int(self.config["serving"]["block_size"]))
        prefill_T = blocks_per_seq * int(self.config["serving"]["block_size"])
        pad = prefill_bucket(int(self.mix["max_prompt"]), prefill_T)
        rows = int(self.sched.max_prefill_batch)
        toks = rng.integers(0, self.vocab, size=(rows, pad)).astype(np.int32)
        lens = np.full(rows, pad, np.int32)
        out = self.engine.executor.prefill({"tokens": toks}, prefill_T,
                                           prompt_lens=lens)
        del out
        self._sync()
        reqs = [Request(prompt=rng.integers(0, self.vocab, size=48,
                                            dtype=np.int64).astype(np.int32),
                        max_new_tokens=4, request_id=-1 - i)
                for i in range(self.n_slots)]
        warm = self.engine.make_loop(
            reqs, n_slots=self.n_slots, cache_T=self.max_context,
            sched_cfg=self.sched,
            num_blocks=8 * self.n_slots + 2)
        warm.run()
        self._pool_bytes(1)
        del warm
        gc.collect()
        self._sync()

    def _pool_bytes(self, num_blocks: int) -> int:
        from repro_torch.models import api
        per = sum(int(np.prod(shape)) * dtype.itemsize for shape, dtype in
                  api.paged_cache_specs(self.arch, 1,
                                        int(self.config["serving"]
                                            ["block_size"])).values())
        self.block_bytes = per
        return per * num_blocks

    def _pool_blocks(self) -> int:
        """The KV pool gets what is left of the card after the weights and
        the warm-up, less the configuration's headroom: the device's free
        memory with the allocator's segments from the warm-up kept, so
        the window's transients reuse them.  On the CPU (tests) it is the
        configuration's ``cpu_blocks``."""
        serving = self.config["serving"]
        if self.device == "cpu":
            return int(serving["cpu_blocks"])
        import torch
        free, _ = torch.cuda.mem_get_info()
        free -= int(serving["headroom_gib"] * 2 ** 30)
        return int(free // self.block_bytes)

    def _wrap_for_counts(self) -> None:
        """Log each prefill's rows and each decode step's cache lengths
        (traced runs only): the work counts of the traced window."""
        ex = self.engine.executor
        prefill = type(ex).prefill.__get__(ex)
        loop = self.loop

        def logged_prefill(batch, cache_T, prompt_lens=None, **kw):
            toks = batch["tokens"]
            lens = (np.asarray(prompt_lens).tolist() if prompt_lens
                    is not None else [toks.shape[1]] * toks.shape[0])
            self.prefill_log.append((time.perf_counter(), toks.shape[0],
                                     toks.shape[1], lens))
            return prefill(batch, cache_T, prompt_lens=prompt_lens, **kw)

        ex.prefill = logged_prefill
        decode = loop._decode_fn

        def logged_decode(cache, step, seeds, counts):
            self.decode_log.append((time.perf_counter(),
                                    np.asarray(step["cache_len"]).copy(),
                                    np.asarray(counts) > 0))
            return decode(cache, step, seeds, counts)

        loop._decode_fn = logged_decode

    # -- the window -----------------------------------------------------------

    def run(self) -> RunData:
        self.entries: List[dict] = []          # one per submitted request
        self.t0: Optional[float] = None
        self.t1: Optional[float] = None
        self.prof = None
        self.trace_t = [None, None, 0, 0]      # t0, t1, record marks
        if self.gen.HARNESS == "serve_open":
            self._run_open()
        else:
            self._run_closed()
        self._sync()
        return self._collect()

    def _submit(self, item: gen.Item, due: float) -> dict:
        from repro_torch.serving import Request
        req = Request(prompt=item.prompt, max_new_tokens=item.max_new_tokens,
                      request_id=int(item.index))
        e = {"req": req, "due": due, "measured": item.measured}
        self.entries.append(e)
        self.loop.submit(req)
        return e

    def _finished(self, e) -> bool:
        return e["req"].state.value in TERMINAL

    def _run_open(self) -> None:
        loop = self.loop
        blocks = [self.gen.schedule(self.mix, self.vocab, self.seed,
                                    self.seconds, 0)]
        self.t0 = time.perf_counter()
        self.t1 = self.t0 + self.seconds

        def client():
            try:
                b = 0
                while True:
                    for item in blocks[b]:
                        due = self.t0 + item.due_s
                        while True:
                            now = time.perf_counter()
                            if now >= due or self._measured_done(now):
                                break
                            time.sleep(min(due - now, 0.05))
                        if self._measured_done(time.perf_counter()):
                            return
                        self._submit(item, due)
                    b += 1
                    blocks.append(self.gen.schedule(
                        self.mix, self.vocab, self.seed, self.seconds, b))
            finally:
                # the load after the window, and a window request still
                # running at the drain cap, end here
                for e in self.entries:
                    if not self._finished(e):
                        self.engine.cancel(e["req"].request_id)
                loop.close()

        th = threading.Thread(target=client, name="perfbench-client",
                              daemon=True)
        loop.on_step_end = self._hook
        th.start()
        try:
            loop.run_forever(poll_s=0.0005)
        finally:
            th.join(timeout=30)
        if th.is_alive():
            raise RuntimeError("the client thread did not stop")

    def _measured_done(self, now: float) -> bool:
        """After the window: every window request finished, or the drain
        cap passed."""
        if now < self.t1:
            return False
        if now >= self.t1 + DRAIN_CAP_S:
            return True
        return all(self._finished(e) for e in self.entries
                   if e["measured"])

    def _run_closed(self) -> None:
        loop = self.loop
        self.sessions = self.gen.Sessions(self.mix, self.vocab, self.seed)
        self.current: Dict[int, dict] = {}
        for c in range(int(self.mix["clients"])):
            self.current[c] = self._submit(self.sessions.next_turn(c),
                                           time.perf_counter())
        self.ending = False
        loop.on_step_end = self._hook
        loop.run_forever(poll_s=0.0005)

    def _hook(self, loop) -> None:
        now = time.perf_counter()
        if self.gen.HARNESS == "serve_closed":
            self._closed_step(loop, now)
        if self.trace and self.t0 is not None:
            self._trace_step(loop, now)

    def _closed_step(self, loop, now: float) -> None:
        if self.ending:
            return
        if self.t0 is None:
            # the window opens once every client's first turn is decoding
            if all(len(e["req"].tokens) > 0 for e in self.current.values()):
                self.t0 = now
                self.t1 = now + self.seconds
            return
        if now >= self.t1:
            self.ending = True
            for e in self.entries:
                if not self._finished(e):
                    self.engine.cancel(e["req"].request_id)
            loop.close()
            return
        for c, e in list(self.current.items()):
            if self._finished(e):
                self.sessions.answered(c, e["req"].tokens)
                self.current[c] = self._submit(self.sessions.next_turn(c),
                                               now)

    def _trace_step(self, loop, now: float) -> None:
        import torch
        t = self.trace_t
        plan = self.mix["trace"]
        start = self.t0 + plan["start_share"] * self.seconds
        if t[0] is None and now >= start:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if self.device != "cpu":
                acts.append(ProfilerActivity.CUDA)
            self._sync()
            self.prof = profile(activities=acts)
            self.prof.start()
            self.tel.tracer.annotate_device = True
            t[0], t[2] = time.perf_counter(), len(loop.stream)
        elif (t[0] is not None and t[1] is None
              and now >= t[0] + plan["seconds"]):
            self._sync()
            t[1], t[3] = time.perf_counter(), len(loop.stream)
            self.tel.tracer.annotate_device = False
            self.prof.stop()

    # -- results --------------------------------------------------------------

    def _collect(self) -> RunData:
        import torch
        loop = self.loop
        if self.trace and self.prof is not None and self.trace_t[1] is None:
            self._sync()
            self.trace_t[1] = time.perf_counter()
            self.trace_t[3] = len(loop.stream)
            self.prof.stop()
        wall0 = loop._wall0
        recs = [dict(r, t=wall0 + r["ts_s"]) for r in loop.stream]
        data = RunData(cell=self.cell, kind="serve", config=self.config,
                       mix=self.mix, work=self.work, t0=self.t0, t1=self.t1,
                       setup_s=self.t0 - self.t_start)
        data.records = [r for r in recs if self.t0 <= r["t"] < self.t1]
        data.requests = [
            {"due": e["due"], "measured": e["measured"],
             "tokens": list(e["req"].tokens),
             "stamps": list(e["req"].wall_token_times),
             "reason": e["req"].finish_reason,
             "prompt": e["req"].prompt, "state": e["req"].state.value}
            for e in self.entries]
        data.n_slots = self.n_slots
        data.block_size = int(self.config["serving"]["block_size"])
        data.blocks_per_seq = -(-self.max_context // data.block_size)
        if self.tel is not None and self.tel.tracer is not None:
            data.spans = [dict(ev, t=self.tel.tracer._t0 + ev["ts"] / 1e6)
                          for ev in self.tel.tracer.events
                          if ev.get("ph") == "X"]
            data.spans = [s for s in data.spans
                          if self.t0 <= s["t"] < self.t1]
        if self.trace and self.prof is not None:
            from perfbench.core.trace import reduce_profile
            tr0, tr1, i0, i1 = self.trace_t
            names = {ev["name"] for ev in self.tel.tracer.events
                     if ev.get("ph") == "X"}
            data.trace = reduce_profile(self.prof, names)
            data.trace["window_s"] = tr1 - tr0
            data.trace["records"] = recs[i0:i1]
            data.trace["prefills"] = [p for p in self.prefill_log
                                      if tr0 <= p[0] < tr1]
            data.trace["decodes"] = [d for d in self.decode_log
                                     if tr0 <= d[0] < tr1]
            self.prof = None
        if self.device != "cpu":
            data.memory_peak_bytes = int(torch.cuda.max_memory_allocated())
        return data

    def check(self, data: RunData, control: bool = False) -> dict:
        from perfbench.core.check import serve_readings
        out = serve_readings(data.requests, self.config, self.seed,
                             int(self.mix["check"]["requests"]),
                             self.device, control)
        out["sampled"] = out["checked_requests"]
        return out

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        import torch
        self.loop = None
        self.engine = None
        self.tel = None
        gc.collect()
        if self.device != "cpu":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
