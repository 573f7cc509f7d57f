"""Shared model layers (port of ``repro/models/layers.py``): norms, dense
(BitParticle-backed), embeddings, RoPE, feed-forward, and ``init_*``
functions driven by an explicit ``torch.Generator``.

Parameters are nested dicts of tensors with the same structure and names as
the JAX package's pytrees, so the weight bridge (``repro_torch.convert``) is
a leaf-by-leaf conversion.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from repro_torch.core import quant
from repro_torch.core.bp_matmul import dense_apply, quantized_matmul
from repro_torch.kernels.bitparticle_matmul.ops import kmajor

DTYPE = torch.bfloat16


def truncated_normal(gen: torch.Generator, shape: Sequence[int],
                     stddev: float, dtype=DTYPE,
                     device=None) -> torch.Tensor:
    """Normal(0, stddev) truncated at +/- 2 stddev (the reference's
    ``truncated_normal(-2, 2) * stddev``)."""
    t = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, stddev, -2.0 * stddev, 2.0 * stddev,
                                generator=gen)
    return t.to(dtype)


def stack_slice(tree, *idx):
    """Slice ``idx`` of every leaf of a stacked parameter subtree (views,
    no copies): layer ``l`` of a scan-stacked tree is ``stack_slice(tree,
    l)``."""
    if isinstance(tree, dict):
        return {k: stack_slice(v, *idx) for k, v in tree.items()}
    return tree[idx]


# --- norms -----------------------------------------------------------------

def init_rmsnorm(d: int, lead=(), device=None):
    return {"scale": torch.ones(*lead, d, dtype=torch.float32, device=device)}


def rms_norm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * params["scale"]
    return out.to(x.dtype)


def init_layernorm(d: int, lead=(), device=None):
    return {"scale": torch.ones(*lead, d, dtype=torch.float32, device=device),
            "bias": torch.zeros(*lead, d, dtype=torch.float32,
                                device=device)}


def layer_norm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """float32 mean and variance over the last axis, cast back to x's
    dtype."""
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps) * params["scale"] \
        + params["bias"]
    return out.to(x.dtype)


# --- dense -----------------------------------------------------------------

def init_dense(gen, d_in: int, d_out: int, bias: bool = False,
               stddev=None, lead=(), device=None):
    stddev = stddev if stddev is not None else d_in ** -0.5
    p = {"w": truncated_normal(gen, (*lead, d_in, d_out), stddev,
                               device=device)}
    if bias:
        p["b"] = torch.zeros(*lead, d_out, dtype=torch.float32, device=device)
    return p


def dense(params, x: torch.Tensor, mode: str = "bf16",
          backend: str = "auto", probe=None) -> torch.Tensor:
    """``probe``: a ``core.probe.StatsCollector`` that records the
    activation of a quantized matmul (None records nothing)."""
    w = params["w"]
    if w.dtype == torch.int8:
        # pre-quantized serving weights (int8 in device memory)
        int_mode = mode if mode in ("bp_exact", "bp_approx") else "bp_exact"
        if probe is not None:
            probe.record(x)
        y = quantized_matmul(x, w, params["w_scale"], int_mode, backend)
    else:
        y = dense_apply(x, w.to(x.dtype), mode, backend)
    if "b" in params:
        y = y + params["b"].to(y.dtype)
    return y


def quantize_dense_params(params):
    """Convert every dense kernel ("w", ndim >= 2, float) to int8 + per-
    output-channel float32 scale, stored K-major for the CUDA kernel (the
    logical shape stays (..., K, N)).  Embedding tables and 1-D params are
    untouched; already-int8 weights pass through."""
    def rec(node):
        if not isinstance(node, dict):
            return node
        node = {k: rec(v) for k, v in node.items()}
        w = node.get("w")
        if (isinstance(w, torch.Tensor) and w.ndim >= 2
                and w.is_floating_point()):
            # leading dims (stacked layers) keep their own scales:
            # (..., K, N) -> (..., N)
            scale_shape = w.shape[:-2] + (w.shape[-1],)
            wf = w.to(torch.float32)
            scale = quant.compute_scale(wf, axis=(w.ndim - 2,))
            node["w"] = kmajor(quant.quantize(wf, scale))
            node["w_scale"] = scale.reshape(scale_shape)
        return node

    return rec(params)


# --- embeddings ------------------------------------------------------------

def init_embedding(gen, vocab: int, d: int, device=None):
    return {"table": truncated_normal(gen, (vocab, d), d ** -0.5,
                                      device=device)}


def embed(params, tokens: torch.Tensor) -> torch.Tensor:
    return params["table"][tokens]


def unembed(params, x: torch.Tensor) -> torch.Tensor:
    """Logits against the (possibly tied) embedding table: a bf16 product,
    not a BitParticle matmul."""
    return x @ params["table"].to(x.dtype).t()


# --- rotary position embeddings ---------------------------------------------

def rope_angles(positions: torch.Tensor, head_dim: int, theta: float):
    """positions (..., S) int -> cos/sin (..., S, head_dim//2) float32."""
    half = head_dim // 2
    ar = torch.arange(0, half, dtype=torch.float32, device=positions.device)
    inv = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                 device=positions.device), -ar / half)
    ang = positions.to(torch.float32)[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def mrope_angles(positions3: torch.Tensor, head_dim: int, theta: float,
                 sections: Sequence[int]):
    """Qwen2-VL M-RoPE: positions3 (3, B, S); frequency band h takes its
    angles from the (t, h, w) position row of its section (the reference's
    one-hot contraction over the rows, which picks one term exactly).
    Returns cos/sin (B, S, head_dim//2) float32."""
    half = head_dim // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not sum to "
                         f"head_dim/2 = {half}")
    cos, sin = rope_angles(positions3, head_dim, theta)   # (3, B, S, half)
    sec_id = torch.repeat_interleave(
        torch.arange(len(sections), device=positions3.device),
        torch.as_tensor(list(sections), device=positions3.device),
        output_size=half)        # a meta tensor cannot count it
    band = torch.arange(half, device=positions3.device)
    return cos[sec_id, ..., band].movedim(0, -1), \
        sin[sec_id, ..., band].movedim(0, -1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, D); cos/sin (B, S, D/2) — rotate-half convention."""
    d2 = x.shape[-1] // 2
    c = cos[..., None, :].to(torch.float32)
    s = sin[..., None, :].to(torch.float32)
    x1f = x[..., :d2].to(torch.float32)
    x2f = x[..., d2:].to(torch.float32)
    out = torch.cat([x1f * c - x2f * s, x2f * c + x1f * s], dim=-1)
    return out.to(x.dtype)


# --- feed-forward ----------------------------------------------------------

def init_ffn(gen, d: int, d_ff: int, ffn_type: str, lead=(), device=None):
    if ffn_type == "swiglu":
        return {"w_gate": init_dense(gen, d, d_ff, lead=lead, device=device),
                "w_up": init_dense(gen, d, d_ff, lead=lead, device=device),
                "w_down": init_dense(gen, d_ff, d, lead=lead, device=device)}
    return {"w_up": init_dense(gen, d, d_ff, lead=lead, device=device),
            "w_down": init_dense(gen, d_ff, d, lead=lead, device=device)}


def ffn(params, x: torch.Tensor, ffn_type: str, mode: str = "bf16",
        backend: str = "auto", probe=None) -> torch.Tensor:
    if ffn_type == "swiglu":
        g = dense(params["w_gate"], x, mode, backend, probe)
        u = dense(params["w_up"], x, mode, backend, probe)
        h = F.silu(g.to(torch.float32)).to(x.dtype) * u
    else:
        u = dense(params["w_up"], x, mode, backend, probe)
        h = F.gelu(u.to(torch.float32), approximate="tanh").to(x.dtype)
    return dense(params["w_down"], h, mode, backend, probe)
