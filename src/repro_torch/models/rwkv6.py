"""RWKV-6 "Finch" blocks (port of ``repro/models/rwkv6.py``): attention-free
time mixing with data-dependent decay, and channel mixing.

Per head (k-dim = v-dim = N):                        [arXiv:2404.05892]

    out_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)
    S_t   = diag(w_t) S_{t-1} + k_t v_t^T,   w_t = exp(-exp(wx_t))

Two evaluation paths of the recurrence, chosen as the reference chooses:

  * ``wkv_chunked`` (a sequence of S > 1 steps with S a multiple of the
    chunk): the chunked WKV6 kernel of ``repro_torch.kernels.wkv6`` on the
    GPU, or its plain version, per ``cfg.matmul_backend`` (the one switch
    that also drives the BitParticle matmul and paged attention; the
    reference's module-level ``WKV_IMPL`` has no counterpart here);
  * ``wkv_sequential`` (every other length, decode's S = 1 included): the
    step recurrence ``wkv_step``, plain PyTorch.

The r/k/v/g/o and channel-mix projections are quantizable dense layers
(the BitParticle matmul in the bp_* modes); the low-rank maa and decay
projections stay bf16 / float32 products, as in the reference.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.wkv6 import ops as wkv6_ops
from repro_torch.models import layers

MAA_RANK = 32
DECAY_RANK = 64
#: WKV chunk length: a sequence of S > 1 steps with S a multiple of it takes
#: the chunked form, every other one the step recurrence
CHUNK = 64


def init_time_mix(gen, cfg, lead=(), device=None):
    d = cfg.d_model
    n_heads = d // cfg.rwkv_head_dim
    tn = layers.truncated_normal
    return {
        "mu": tn(gen, (*lead, 5, d), 0.02, torch.float32, device),
        "maa_w1": tn(gen, (*lead, d, 5 * MAA_RANK), 0.02, device=device),
        "maa_w2": tn(gen, (*lead, 5, MAA_RANK, d), 0.02, device=device),
        "decay_base": torch.full((*lead, d), -1.0, dtype=torch.float32,
                                 device=device),
        "decay_w1": tn(gen, (*lead, d, DECAY_RANK), 0.02, device=device),
        "decay_w2": tn(gen, (*lead, DECAY_RANK, d), 0.02, device=device),
        "bonus_u": tn(gen, (*lead, n_heads, cfg.rwkv_head_dim), 0.02,
                      torch.float32, device),
        "wr": layers.init_dense(gen, d, d, lead=lead, device=device),
        "wk": layers.init_dense(gen, d, d, lead=lead, device=device),
        "wv": layers.init_dense(gen, d, d, lead=lead, device=device),
        "wg": layers.init_dense(gen, d, d, lead=lead, device=device),
        "wo": layers.init_dense(gen, d, d, lead=lead, device=device),
        "ln_x": layers.init_layernorm(d, lead, device),
    }


def init_channel_mix(gen, cfg, lead=(), device=None):
    d, f = cfg.d_model, cfg.d_ff
    return {
        "mu_k": layers.truncated_normal(gen, (*lead, d), 0.02, torch.float32,
                                        device),
        "wk": layers.init_dense(gen, d, f, lead=lead, device=device),
        "wv": layers.init_dense(gen, f, d, lead=lead, device=device),
    }


def _token_shift(x: torch.Tensor, x_prev: torch.Tensor) -> torch.Tensor:
    """Shift right by one along the sequence; position 0 sees x_prev
    (B, D)."""
    return torch.cat([x_prev[:, None, :], x[:, :-1, :]], dim=1)


def _ddlerp(p, x: torch.Tensor, xx: torch.Tensor) -> torch.Tensor:
    """Data-dependent lerp producing the 5 mixed inputs (r, k, v, w, g),
    stacked on a leading axis."""
    B, S, D = x.shape
    dx = xx - x
    base = x[None] + dx[None] * p["mu"][:, None, None, :]
    low = torch.tanh(torch.einsum("bsd,dr->bsr", dx,
                                  p["maa_w1"].to(x.dtype)))
    low = low.reshape(B, S, 5, MAA_RANK)
    delta = torch.einsum("bsnr,nrd->nbsd", low, p["maa_w2"].to(x.dtype))
    return base.to(x.dtype) + (dx[None] * delta).to(x.dtype)


def _decay_logits(p, xw: torch.Tensor) -> torch.Tensor:
    """Per-channel decay exponent wx (float32): w = exp(-exp(wx)), clipped
    for numerical safety."""
    low = torch.tanh(torch.einsum("bsd,dr->bsr", xw,
                                  p["decay_w1"].to(xw.dtype)))
    wx = p["decay_base"] + torch.einsum(
        "bsr,rd->bsd", low.to(torch.float32),
        p["decay_w2"].to(torch.float32))
    return torch.clamp(wx, -8.0, 2.0)


def time_mix_inputs(p, x, x_prev, cfg, mode):
    """Shared preamble: projections r, k, v, g and the per-channel
    log-decay."""
    B, S, D = x.shape
    N = cfg.rwkv_head_dim
    H = D // N
    backend = cfg.matmul_backend
    xx = _token_shift(x, x_prev)
    mr, mk, mv, mw, mg = _ddlerp(p, x, xx)
    r = layers.dense(p["wr"], mr, mode, backend).reshape(B, S, H, N)
    k = layers.dense(p["wk"], mk, mode, backend).reshape(B, S, H, N)
    v = layers.dense(p["wv"], mv, mode, backend).reshape(B, S, H, N)
    g = layers.dense(p["wg"], mg, mode, backend)
    log_w = -torch.exp(_decay_logits(p, mw))      # (B, S, D) float32, <= 0
    return r, k, v, g, log_w.reshape(B, S, H, N), x[:, -1, :]


def _finalize(p, out, g, cfg, mode):
    B, S, H, N = out.shape
    y = layers.layer_norm(p["ln_x"], out.reshape(B, S, H * N))
    y = y * F.silu(g.to(torch.float32)).to(y.dtype)
    return layers.dense(p["wo"], y, mode, cfg.matmul_backend)


def wkv_step(r, k, v, log_w, u, state):
    """One-token recurrence.  r, k, v, log_w (B, H, N); u (H, N); state
    (B, H, N, N).  Returns (out (B, H, N) float32, new_state)."""
    rf, kf, vf = (t.to(torch.float32) for t in (r, k, v))
    kv = kf[..., :, None] * vf[..., None, :]              # (B, H, N, N)
    out = torch.einsum("bhk,bhkv->bhv", rf, state + u[..., :, None] * kv)
    new_state = torch.exp(log_w)[..., :, None] * state + kv
    return out, new_state


def wkv_sequential(r, k, v, log_w, u, state):
    """Step loop over the sequence (decode, and prefills whose length is
    not a multiple of the chunk).  r, k, v, log_w (B, S, H, N); state
    (B, H, N, N).  Returns (out (B, S, H, N) float32, state)."""
    outs = []
    for t in range(r.shape[1]):
        out, state = wkv_step(r[:, t], k[:, t], v[:, t], log_w[:, t], u,
                              state)
        outs.append(out)
    return torch.stack(outs, dim=1), state


def wkv_chunked(r, k, v, log_w, u, state, chunk: int = CHUNK,
                backend: str = "auto"):
    """Chunk-parallel evaluation, exactly equal to ``wkv_sequential`` up to
    float32 rounding: the WKV6 kernel in model layout, or its plain version
    (``backend`` as for the kernel's wrapper).  ``S % chunk == 0``."""
    if r.shape[1] % chunk:
        raise ValueError(f"sequence length {r.shape[1]} is not a multiple "
                         f"of the chunk {chunk}")
    return wkv6_ops.wkv6(r, k, v, log_w, u, state, chunk=chunk,
                         backend=backend)


def time_mix(p, x, x_prev, wkv_state, cfg, mode, chunk: int = CHUNK,
             wkv_backend=None):
    """Full time-mix sub-block over a sequence (prefill or decode).
    ``wkv_backend`` overrides ``cfg.matmul_backend`` for the chunked WKV
    (the training forward names ``plain``: the kernel has no backward).
    Returns (y, last input row for the next token shift, new WKV state)."""
    r, k, v, g, log_w, x_last = time_mix_inputs(p, x, x_prev, cfg, mode)
    u = p["bonus_u"]
    S = x.shape[1]
    if S % chunk == 0 and S > 1:
        out, new_state = wkv_chunked(r, k, v, log_w, u, wkv_state, chunk,
                                     wkv_backend or cfg.matmul_backend)
    else:
        out, new_state = wkv_sequential(r, k, v, log_w, u, wkv_state)
    y = _finalize(p, out.to(x.dtype), g, cfg, mode)
    return y, x_last, new_state


def channel_mix(p, x, x_prev, mode, backend: str = "auto"):
    xx = _token_shift(x, x_prev)
    xk = x + (xx - x) * p["mu_k"].to(x.dtype)
    h = layers.dense(p["wk"], xk, mode, backend)
    h = torch.square(torch.relu(h.to(torch.float32))).to(x.dtype)
    return layers.dense(p["wv"], h, mode, backend), x[:, -1, :]
