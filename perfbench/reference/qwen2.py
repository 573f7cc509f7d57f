"""Plain reference of a Qwen2 decoder (arXiv:2407.10671) with W8A8 dense
layers, in float32 with TF32 off.

It follows the published equations: RMSNorm, q/k/v projections with bias,
rotary embeddings (rotate-half, ``rope_theta``), grouped-query causal
softmax attention, SwiGLU, a final RMSNorm and the unembedding (tied to
the embedding table or a separate head).  The quantization the
configuration states is applied as plain arithmetic: every dense weight
per output channel and every activation row to ``qmax`` levels each side,
the product of the integers taken in float32 and scaled back.  The tied
unembedding is not quantized; a separate head is, like every dense layer.

Departures, each shared with the program by the configuration: the
vocabulary is padded to a multiple of 256 and the padded rows get logits.

It imports nothing of the program and takes nothing it made: the weights
come from ``perfbench.core.weights`` for the same seed, and the int8
weights and scales are worked out again here.  It runs one sequence at a
time, layer by layer, attention in blocks of query rows, so that a 7B
model at several thousand positions fits beside nothing else.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import torch
import torch.nn.functional as F


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale


def quant_dense(x: torch.Tensor, w: torch.Tensor, qmax: int) -> torch.Tensor:
    """x (S, K) float32 against w (K, N): both sides quantized
    symmetrically to [-qmax, qmax] (w per output channel, x per row),
    round half to even, the integer product scaled back."""
    wf = w.to(torch.float32)
    ws = wf.abs().amax(dim=0, keepdim=True).clamp_min(1e-8) / qmax
    wq = torch.clamp(torch.round(wf / ws), -qmax, qmax)
    del wf
    xs = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) / qmax
    xq = torch.clamp(torch.round(x / xs), -qmax, qmax)
    return (xq @ wq) * xs * ws


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, heads, hd), positions 0..S-1, rotate-half; angles in float64."""
    S, _, hd = x.shape
    half = hd // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float64,
                                  device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float64, device=x.device)[:, None] * inv
    cos = torch.cos(ang).to(torch.float32)[:, None, :]
    sin = torch.sin(ang).to(torch.float32)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q, k, v, block_bytes: int = 1 << 30) -> torch.Tensor:
    """q (S, H, hd), k/v (S, KH, hd) -> (S, H * hd), exact softmax over
    the causal prefix, in blocks of query rows."""
    S, H, hd = q.shape
    KH = k.shape[1]
    G = H // KH
    rows = max(1, min(S, block_bytes // (4 * H * S)))
    kh = k.permute(1, 2, 0)                       # (KH, hd, S)
    vh = v.permute(1, 0, 2)                       # (KH, S, hd)
    keys = torch.arange(S, device=q.device)
    out = torch.empty((S, H * hd), dtype=torch.float32, device=q.device)
    for r0 in range(0, S, rows):
        r1 = min(S, r0 + rows)
        b = r1 - r0
        qb = q[r0:r1].reshape(b, KH, G, hd).permute(1, 2, 0, 3).reshape(
            KH, G * b, hd)
        s = (qb @ kh) * hd ** -0.5                # (KH, G*b, S)
        qpos = (r0 + torch.arange(b, device=q.device)).repeat(G)
        s.masked_fill_(keys[None, None, :] > qpos[None, :, None], -math.inf)
        p = torch.softmax(s, dim=-1)
        o = (p @ vh).reshape(KH, G, b, hd).permute(2, 0, 1, 3)
        out[r0:r1] = o.reshape(b, H * hd)
    return out


def logits_at(w: Dict[str, torch.Tensor], model: dict, tokens: torch.Tensor,
              rows: Sequence[int], qmax: int = 127) -> torch.Tensor:
    """float32 logits (len(rows), V_padded) at positions ``rows`` of the
    sequence ``tokens`` (1-D, on the weights' device)."""
    eps = float(model["rms_norm_eps"])
    theta = float(model["rope_theta"])
    H = model["num_attention_heads"]
    KH = model["num_key_value_heads"]
    d = model["hidden_size"]
    hd = model.get("head_dim", d // H)
    S = tokens.shape[0]
    x = w["embed.table"][tokens.long()].to(torch.float32)
    for l in range(model["num_hidden_layers"]):
        def g(name):
            return w[f"layers.{name}"][l]
        h = rms_norm(x, g("attn_norm.scale"), eps)
        q = quant_dense(h, g("attn.wq.w"), qmax) + g("attn.wq.b")
        k = quant_dense(h, g("attn.wk.w"), qmax) + g("attn.wk.b")
        v = quant_dense(h, g("attn.wv.w"), qmax) + g("attn.wv.b")
        q = rope(q.reshape(S, H, hd), theta)
        k = rope(k.reshape(S, KH, hd), theta)
        a = causal_attention(q, k, v.reshape(S, KH, hd))
        del q, k, v
        x = x + quant_dense(a, g("attn.wo.w"), qmax)
        h = rms_norm(x, g("ffn_norm.scale"), eps)
        f = F.silu(quant_dense(h, g("ffn.w_gate.w"), qmax)) \
            * quant_dense(h, g("ffn.w_up.w"), qmax)
        x = x + quant_dense(f, g("ffn.w_down.w"), qmax)
        del h, f, a
    idx = torch.as_tensor(list(rows), device=x.device, dtype=torch.long)
    h = rms_norm(x[idx], w["final_norm.scale"], eps)
    if model["tie_word_embeddings"]:
        return h @ w["embed.table"].to(torch.float32).t()
    return quant_dense(h, w["lm_head.w"], qmax)


def served_gaps(w, model: dict, prompt, served, qmax: int = 127,
                control_qmax: int = 0):
    """For a prompt and the tokens served after it: per served token, the
    gap by which its reference logit lies below the reference's best at
    that position.  With ``control_qmax``, also the gap of the token that
    the reference computed at that coarser quantization puts first (the
    control).  Returns (gaps, control_gaps or None) as float lists."""
    dev = w["embed.table"].device
    seq = torch.as_tensor(list(prompt) + list(served[:-1]), device=dev)
    P, n = len(prompt), len(served)
    rows = range(P - 1, P - 1 + n)
    with torch.no_grad():
        ref = logits_at(w, model, seq, rows, qmax)
        best = ref.max(dim=-1).values
        tok = torch.as_tensor(list(served), device=dev).long()
        gaps = (best - ref.gather(1, tok[:, None])[:, 0]).tolist()
        ctl = None
        if control_qmax:
            low = logits_at(w, model, seq, rows, control_qmax)
            pick = low.argmax(dim=-1)
            ctl = (best - ref.gather(1, pick[:, None])[:, 0]).tolist()
    return gaps, ctl
