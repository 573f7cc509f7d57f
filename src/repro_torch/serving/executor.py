"""Serving execution layer, single device (port of
``repro/serving/executor.py::SingleDeviceExecutor``).

The engine is host-side orchestration; everything device-shaped lives
here: placing inputs on the device, running the model entry points with
gradients off, fused decode + sampling, and cache allocation and surgery.

Where the reference DONATES the pooled cache into the decode step and the
slot insert (``donate_argnums``) so the update aliases the buffer, the port
updates the pooled cache tensors IN PLACE and hands the same tensors back:
the same single cache-sized allocation, with no functional copy.  A caller
must treat a cache passed to an entry point as updated.

The matmul backend is the config's ``matmul_backend`` (``auto``: the CUDA
kernel on the GPU, the plain version on the CPU).  The mesh executor is not
ported yet.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import api
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
        self._params = params

    @property
    def params(self):
        return self._params

    def set_telemetry(self, telemetry) -> None:
        self.telemetry = telemetry if telemetry is not None else NULL_TELEMETRY

    def _require_params(self):
        if self._params is None:
            raise ValueError("this executor was built without params "
                             "(cache-only use)")

    def put(self, x, dtype=None) -> torch.Tensor:
        """Host array -> device tensor; the bytes count as h2d traffic."""
        arr = np.asarray(x)
        self.telemetry.count("h2d_bytes", arr.nbytes)
        return torch.as_tensor(arr, dtype=dtype, device=self.device)

    # -- model entry points -------------------------------------------------

    @torch.no_grad()
    def prefill(self, batch, cache_T: int, prompt_lens=None):
        """(last-position logits (B, V), prefill cache padded to cache_T).
        ``prompt_lens`` selects the ragged right-padded variant."""
        self._require_params()
        b = {"tokens": self.put(batch["tokens"], torch.long)}
        lens = None if prompt_lens is None else self.put(prompt_lens,
                                                         torch.long)
        return api.prefill(self._params, self.cfg, b, cache_T,
                           prompt_lens=lens)

    def decode_sample_fn(self, temperature: float):
        """``fn(cache, step, seeds, counts) -> (tokens (n_slots,) int32 on
        the device, cache)``: decode + per-slot sampling in one call; only
        the sampled tokens need to cross to the host.  ``step`` holds host
        arrays ``tokens`` (n_slots, 1) and ``cache_len`` (n_slots,);
        ``seeds``/``counts`` give each slot's sampling stream."""
        self._require_params()

        @torch.no_grad()
        def fn(cache, step, seeds, counts):
            b = {"tokens": self.put(step["tokens"], torch.long),
                 "cache_len": self.put(step["cache_len"], torch.long),
                 "cache": cache}
            logits, cache = api.decode_step(self._params, self.cfg, b)
            draw = (None if temperature <= 0 else
                    [sample_seed(s, c) for s, c in zip(seeds, counts)])
            return sample_tokens(logits, temperature, draw), cache

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
        return api.slot_insert(self.cfg, pool, src, slot, src_index)


def make_executor(cfg, params=None, *, device="cuda",
                  mesh_shape=None) -> SingleDeviceExecutor:
    if mesh_shape is not None:
        raise NotImplementedError("mesh (tensor-parallel) serving is not "
                                  "ported yet")
    return SingleDeviceExecutor(cfg, params, device=device)
