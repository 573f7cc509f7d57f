"""Serving execution layer, single device (port of
``repro/serving/executor.py::SingleDeviceExecutor``).

The engine is host-side orchestration; everything device-shaped lives
here: placing inputs on the device, running the model entry points with
gradients off, fused decode + sampling, and cache allocation and surgery.

Where the reference DONATES the pooled cache into the decode step and the
cache surgery ops (slot insert, paged insert, copy-on-write block copy) so
the update aliases the buffer, the port updates the pooled cache tensors IN
PLACE and hands the same tensors back: the same single cache-sized
allocation, with no functional copy.  A caller must treat a cache passed to
an entry point as updated.  This holds for the RWKV-6 family too: its
decode step writes each layer's new recurrent state into the pooled slot
state in place (``rwkv_model.forward``) and ignores ``cache_len``, which
the decode functions below pass for every family.

The matmul backend is the config's ``matmul_backend`` (``auto``: the CUDA
kernel on the GPU, the plain version on the CPU).  The mesh executor is not
ported yet.

Fault injection: a serve loop attaches its ``FaultInjector``
(:meth:`set_faults`); the prefill checks the ``prefill`` site, the decode
and verify functions the ``step`` site and then ``slow`` (a latency
spike), and the cache surgery ops the ``oom`` site, each before any device
work, at the reference's points.  The decode and verify steps take an
optional ``nan_mask`` (n_slots,) bool in ``step`` that poisons the flagged
slots' logits before the finite-logits guard.  The kernel rung of the
degradation ladder takes a copy on the plain backend
(:meth:`with_matmul_backend`) for the rest of its serve.

``probed=True`` selects the sparsity probe's variants of the prefill,
decode-sample and verify-sample functions (``api.*_probed``): the same
forward with a stats collector passed down the layer loop, returning the
``(L[+1], N_STATS)`` activation stats on the device as a third output.  The
unprobed functions are the ones the serve ran before the probe existed.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.serving.faults import NULL_INJECTOR
from repro_torch.serving.telemetry import NULL_TELEMETRY

_SEED_MIX = 1_000_003


def sample_seed(base: int, n: int) -> int:
    """Seed of the ``n``-th sampled token of a request whose base seed is
    ``base`` (one reproducible stream per request)."""
    return (int(base) * _SEED_MIX + int(n)) % (2 ** 63)


def sample_tokens(logits: torch.Tensor, temperature: float, seeds=None
                  ) -> torch.Tensor:
    """(B, V) logits -> (B,) int32 tokens.  Greedy argmax over the whole
    padded vocabulary at ``temperature <= 0``; otherwise one categorical
    draw per row from a ``torch.Generator`` seeded with ``seeds[row]``.
    Rows with a non-finite logit give the -1 sentinel (the reference's NaN
    guard)."""
    ok = torch.isfinite(logits).all(dim=-1)
    if temperature <= 0:
        tok = torch.argmax(logits, dim=-1)
    else:
        probs = torch.softmax(
            torch.where(ok[:, None], logits.to(torch.float32), 0.0)
            / temperature, dim=-1)
        draws = []
        for row, seed in enumerate(seeds):
            g = torch.Generator(device=logits.device).manual_seed(int(seed))
            draws.append(torch.multinomial(probs[row], 1, generator=g))
        tok = torch.cat(draws)
    return torch.where(ok, tok, torch.full_like(tok, -1)).to(torch.int32)


class SingleDeviceExecutor:
    """Runs the model on one device (default the GPU)."""

    def __init__(self, cfg, params=None, *, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.matmul_backend = cfg.matmul_backend
        self.telemetry = NULL_TELEMETRY
        self.faults = NULL_INJECTOR
        self._params = params

    @property
    def params(self):
        return self._params

    def set_telemetry(self, telemetry) -> None:
        self.telemetry = telemetry if telemetry is not None else NULL_TELEMETRY

    def set_faults(self, injector) -> None:
        """Attach a fault injector (None reverts to the no-op handle)."""
        self.faults = injector if injector is not None else NULL_INJECTOR

    def with_matmul_backend(self, backend: str) -> "SingleDeviceExecutor":
        """A copy of this executor whose kernels take ``backend`` (the
        degradation ladder's kernel rung, the reference's
        ``set_matmul_backend``).  The model reads the backend from the
        config, so the copy gets a rebuilt config; this executor, and the
        engine that owns it, keep theirs."""
        ex = copy.copy(self)
        ex.cfg = dataclasses.replace(self.cfg, matmul_backend=backend)
        ex.matmul_backend = backend
        return ex

    @property
    def resolved_matmul_backend(self) -> str:
        """The route the kernels' wrappers take for this device's tensors:
        ``auto`` is the kernel on the GPU and the plain version on the
        CPU."""
        if self.matmul_backend == "auto":
            return "kernel" if self.device.type == "cuda" else "plain"
        return self.matmul_backend

    def _require_params(self):
        if self._params is None:
            raise ValueError("this executor was built without params "
                             "(cache-only use)")

    def put(self, x, dtype=None) -> torch.Tensor:
        """Host array -> device tensor; the bytes count as h2d traffic."""
        arr = np.asarray(x)
        self.telemetry.count("h2d_bytes", arr.nbytes)
        return torch.as_tensor(arr, dtype=dtype, device=self.device)

    def _step_batch(self, cache, step, paged: bool) -> dict:
        """A decode or verify step's model batch: the host ``tokens`` and
        ``cache_len`` put on the device, the cache, and on the paged store
        the device block tables."""
        b = {"tokens": self.put(step["tokens"], torch.long),
             "cache_len": self.put(step["cache_len"], torch.long),
             "cache": cache}
        if paged:
            b["block_tables"] = step["block_tables"]
        return b

    def _poison(self, logits: torch.Tensor, step) -> torch.Tensor:
        """NaN the logit rows of the slots ``step["nan_mask"]`` flags (fault
        injection only; a step without the key is returned untouched)."""
        mask = step.get("nan_mask")
        if mask is None:
            return logits
        m = torch.as_tensor(np.asarray(mask, bool), device=logits.device)
        m = m.reshape(m.shape + (1,) * (logits.ndim - 1))
        return torch.where(m, torch.full_like(logits, float("nan")), logits)

    # -- model entry points -------------------------------------------------

    @torch.no_grad()
    def prefill(self, batch, cache_T: int, prompt_lens=None,
                probed: bool = False):
        """(last-position logits (B, V), prefill cache padded to cache_T).
        ``prompt_lens`` selects the ragged right-padded variant.
        ``probed=True`` also returns the activation stats."""
        self._require_params()
        self.faults.check("prefill")
        b = {"tokens": self.put(batch["tokens"], torch.long)}
        lens = None if prompt_lens is None else self.put(prompt_lens,
                                                         torch.long)
        entry = api.prefill_probed if probed else api.prefill
        return entry(self._params, self.cfg, b, cache_T, prompt_lens=lens)

    def decode_sample_fn(self, temperature: float, paged: bool = False,
                         probed: bool = False):
        """``fn(cache, step, seeds, counts) -> (tokens (n_slots,) int32 on
        the device, cache)``: decode + per-slot sampling in one call; only
        the sampled tokens need to cross to the host.  ``step`` holds host
        arrays ``tokens`` (n_slots, 1) and ``cache_len`` (n_slots,) and,
        when ``paged``, the device ``block_tables`` (put, and so counted as
        h2d bytes, by ``PagedCacheManager.block_tables_device``);
        ``seeds``/``counts`` give each slot's sampling stream.
        ``probed=True``: ``(tokens, cache, stats)``."""
        self._require_params()
        if probed:
            decode = (api.decode_step_paged_probed if paged
                      else api.decode_step_probed)
        else:
            decode = api.decode_step_paged if paged else api.decode_step

        @torch.no_grad()
        def fn(cache, step, seeds, counts):
            self.faults.check("step")
            self.faults.delay()
            b = self._step_batch(cache, step, paged)
            logits, cache, *stats = decode(self._params, self.cfg, b)
            logits = self._poison(logits, step)
            draw = (None if temperature <= 0 else
                    [sample_seed(s, c) for s, c in zip(seeds, counts)])
            return (sample_tokens(logits, temperature, draw), cache, *stats)

        return fn

    def verify_sample_fn(self, paged: bool = False, probed: bool = False):
        """``fn(cache, step) -> (greedy (B, S) int32 tokens on the device,
        cache)`` for the multi-token verify step (speculation and chunked
        prefill): ONE forward appends the S fed tokens at per-slot
        positions, and the per-position argmax runs on the device, so only
        the (B, S) grid needs to cross to the host, never the (B, S, V)
        logits.  A (slot, position) whose logits are not all finite gives
        -1.  ``step`` is as for :meth:`decode_sample_fn`, with ``tokens``
        (B, S).  ``probed=True``: ``(tokens, cache, stats)``."""
        self._require_params()
        if probed:
            verify = (api.verify_step_paged_probed if paged
                      else api.verify_step_probed)
        else:
            verify = api.verify_step_paged if paged else api.verify_step

        @torch.no_grad()
        def fn(cache, step):
            self.faults.check("step")
            self.faults.delay()
            b = self._step_batch(cache, step, paged)
            logits, cache, *stats = verify(self._params, self.cfg, b)
            logits = self._poison(logits, step)
            B, S, V = logits.shape
            tok = sample_tokens(logits.reshape(B * S, V), 0.0)
            return (tok.reshape(B, S), cache, *stats)

        return fn

    def decode_scan_fn(self, chunk: int, temperature: float,
                       eos_id: Optional[int]):
        """``fn(tok, cache, done, seed, pos0, i0) -> (tok, cache, done,
        tokens (chunk, B))`` for the static path: ``chunk`` decode steps at
        one shared position (a Python loop where the reference scans), with
        sampling and EOS masking folded in."""
        self._require_params()

        @torch.no_grad()
        def fn(tok, cache, done, seed, pos0, i0):
            out = []
            for j in range(chunk):
                if eos_id is not None:
                    done = done | (tok == eos_id)
                b = {"tokens": tok[:, None].long(), "cache": cache,
                     "cache_len": int(pos0) + j}
                logits, cache = api.decode_step(self._params, self.cfg, b)
                draw = (None if temperature <= 0 else
                        [sample_seed(seed, (int(i0) + j) * tok.shape[0] + r)
                         for r in range(tok.shape[0])])
                new = sample_tokens(logits, temperature, draw)
                if eos_id is not None:
                    new = torch.where(done, torch.full_like(new, eos_id), new)
                tok = new
                out.append(new)
            return tok, cache, done, torch.stack(out)

        return fn

    # -- cache allocation / surgery -----------------------------------------

    def zeros_cache(self, n_slots: int, cache_T: int):
        """Allocate the pooled slab decode cache on this device."""
        return api.zeros_cache(self.cfg, n_slots, cache_T, self.device)

    @torch.no_grad()
    def slot_insert(self, pool, src, slot: int, src_index: int = 0):
        """Install request ``src_index`` of a prefill cache into ``slot`` of
        the pooled cache, in place; returns the pool."""
        self.faults.check("oom")
        return api.slot_insert(self.cfg, pool, src, slot, src_index)

    def zeros_paged_cache(self, num_blocks: int, block_size: int):
        """Allocate the block-paged decode cache on this device."""
        return api.zeros_paged_cache(self.cfg, num_blocks, block_size,
                                     self.device)

    @torch.no_grad()
    def paged_insert(self, pages, src, block_ids, src_index: int = 0):
        """Scatter request ``src_index`` of a prefill cache into physical
        pages through ``block_ids`` (trash-redirected entries skip shared
        blocks), in place; returns the pages."""
        self.faults.check("oom")
        ids = torch.as_tensor(np.asarray(block_ids), dtype=torch.long,
                              device=self.device)
        return api.paged_insert(self.cfg, pages, src, ids, src_index)

    @torch.no_grad()
    def copy_block(self, pages, dst: int, src: int):
        """Copy physical page ``src`` -> ``dst`` in every leaf
        (copy-on-write), in place; returns the pages."""
        self.faults.check("oom")
        for p in pages.values():
            p[:, dst].copy_(p[:, src])
        return pages


def make_executor(cfg, params=None, *, device="cuda",
                  mesh_shape=None) -> SingleDeviceExecutor:
    if mesh_shape is not None:
        raise NotImplementedError("mesh (tensor-parallel) serving is not "
                                  "ported yet")
    return SingleDeviceExecutor(cfg, params, device=device)
