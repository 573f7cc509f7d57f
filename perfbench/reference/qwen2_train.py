"""Plain reference of quantization-aware training of a Qwen2 decoder
(arXiv:2407.10671), in float32 with TF32 off.

The forward is ``qwen2.py``'s block with the configuration's fake
quantization in place of the integer product: every dense weight rounded
to ``qmax`` levels per output channel and every dense layer's input to
``qmax`` levels with one scale per tensor (per micro-batch), both with a
straight-through gradient; the tied unembedding is not quantized, a
separate head is.  The loss is the mean next-token cross-entropy over the
valid positions (the last masked), with the padded vocabulary masked out.
The step accumulates the micro-batches' gradients (the mean of their mean
losses), clips the whole gradient to a global norm, and applies AdamW
(bias-corrected moments, decoupled weight decay on every leaf but the
RMSNorm scales, a linear warm-up of the rate) to float32 weights.

It imports nothing of the program; the weights come from
``perfbench.core.weights`` for the same seed, the batches from the same
generator as the program's.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.reference.qwen2 import no_tf32, rms_norm, rope


def fake_quant(x: torch.Tensor, scale: torch.Tensor, qmax: int):
    """Round to ``qmax`` levels each side, straight-through gradient."""
    q = torch.clamp(torch.round(x / scale), -qmax, qmax) * scale
    return x + (q - x).detach()


def fq_dense(x: torch.Tensor, w: torch.Tensor, qmax: int) -> torch.Tensor:
    ws = w.detach().abs().amax(dim=0, keepdim=True).clamp_min(1e-8) / qmax
    xs = x.detach().abs().amax().clamp_min(1e-8) / qmax
    return fake_quant(x, xs, qmax) @ fake_quant(w, ws, qmax)


def _layer(x, ws, model, qmax):
    (an, wq, bq, wk, bk, wv, bv, wo, fn, wg, wu, wd) = ws
    B, S, d = x.shape
    H = model["num_attention_heads"]
    KH = model["num_key_value_heads"]
    hd = model.get("head_dim", d // H)
    eps, theta = float(model["rms_norm_eps"]), float(model["rope_theta"])
    h = rms_norm(x, an, eps)
    q = (fq_dense(h, wq, qmax) + bq).reshape(B * S, H, hd)
    k = (fq_dense(h, wk, qmax) + bk).reshape(B * S, KH, hd)
    v = (fq_dense(h, wv, qmax) + bv).reshape(B, S, KH, hd)
    q = torch.stack([rope(q.reshape(B, S, H, hd)[b], theta)
                     for b in range(B)])
    k = torch.stack([rope(k.reshape(B, S, KH, hd)[b], theta)
                     for b in range(B)])
    G = H // KH
    k = k.repeat_interleave(G, dim=2)
    v = v.repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * hd ** -0.5
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).triu(1)
    s = s.masked_fill(causal, -math.inf)
    a = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)
    x = x + fq_dense(a.reshape(B, S, H * hd), wo, qmax)
    h = rms_norm(x, fn, eps)
    f = F.silu(fq_dense(h, wg, qmax)) * fq_dense(h, wu, qmax)
    return x + fq_dense(f, wd, qmax)


LAYER_LEAVES = ("attn_norm.scale", "attn.wq.w", "attn.wq.b", "attn.wk.w",
                "attn.wk.b", "attn.wv.w", "attn.wv.b", "attn.wo.w",
                "ffn_norm.scale", "ffn.w_gate.w", "ffn.w_up.w",
                "ffn.w_down.w")


def loss(w: Dict[str, torch.Tensor], model: dict, tokens: torch.Tensor,
         mask: torch.Tensor, vocab: int, qmax: int) -> torch.Tensor:
    x = w["embed.table"][tokens.long()]
    for l in range(model["num_hidden_layers"]):
        ws = [w[f"layers.{n}"][l] for n in LAYER_LEAVES]
        x = checkpoint(_layer, x, ws, model, qmax, use_reentrant=False)
    h = rms_norm(x, w["final_norm.scale"], float(model["rms_norm_eps"]))
    B, S, d = h.shape
    h = h.reshape(B * S, d)
    if model["tie_word_embeddings"]:
        logits = h @ w["embed.table"].t()
    else:
        logits = fq_dense(h, w["lm_head.w"], qmax)
    pad = torch.arange(logits.shape[1], device=h.device) >= vocab
    logits = logits.masked_fill(pad[None, :], -1e9)
    targets = torch.roll(tokens, -1, dims=1).reshape(-1).long()
    valid = torch.ones(B, S, dtype=torch.bool, device=h.device)
    valid[:, -1] = False
    valid = (valid & mask.bool()).reshape(-1)
    ce = F.cross_entropy(logits, targets, reduction="none")
    return (ce * valid).sum() / valid.sum()


def decays(path: str) -> bool:
    return not path.endswith("norm.scale")


def train_readings(flat: Dict[str, torch.Tensor], model: dict, mix: dict,
                   batches: List[dict], qmax: int = 127) -> dict:
    """Three (or ``len(batches)``) AdamW steps from ``flat``: each step's
    loss, every leaf's first gradient norm (after clipping) and every
    leaf's change after the last step."""
    no_tf32()
    opt = mix["optimizer"]
    w = {k: t.detach().to(torch.float32).requires_grad_(True)
         for k, t in flat.items()}
    start = {k: t.detach().clone() for k, t in w.items()}
    m = {k: torch.zeros_like(t) for k, t in w.items()}
    v = {k: torch.zeros_like(t) for k, t in w.items()}
    accum = int(mix["grad_accum"])
    losses, first_grad = [], {}
    for step, batch in enumerate(batches, start=1):
        grads = {k: torch.zeros_like(t) for k, t in w.items()}
        total = 0.0
        for toks, mask in zip(batch["tokens"].chunk(accum),
                              batch["loss_mask"].chunk(accum)):
            lo = loss(w, model, toks, mask, int(model["vocab_size"]), qmax)
            got = torch.autograd.grad(lo, list(w.values()))
            for k, g in zip(w, got):
                grads[k] += g / accum
            total += lo.item() / accum
        losses.append(total)
        gnorm = math.sqrt(sum(float(g.double().pow(2).sum())
                              for g in grads.values()))
        scale = min(1.0, opt["clip_norm"] / max(gnorm, 1e-9))
        lr = opt["peak_lr"] * min(step / max(opt["warmup_steps"], 1), 1.0)
        if step > opt["warmup_steps"]:
            t = min(max((step - opt["warmup_steps"])
                        / max(opt["total_steps"] - opt["warmup_steps"], 1),
                        0.0), 1.0)
            lr = opt["peak_lr"] * (opt["min_lr_ratio"] + (
                1 - opt["min_lr_ratio"]) * 0.5 * (1 + math.cos(math.pi * t)))
        bc1 = 1 - opt["b1"] ** step
        bc2 = 1 - opt["b2"] ** step
        with torch.no_grad():
            for k, p in w.items():
                g = grads[k] * scale
                if step == 1:
                    first_grad[k] = float(g.norm())
                m[k].mul_(opt["b1"]).add_((1 - opt["b1"]) * g)
                v[k].mul_(opt["b2"]).add_((1 - opt["b2"]) * g * g)
                u = (m[k] / bc1) / (torch.sqrt(v[k] / bc2) + opt["eps"])
                if decays(k):
                    u = u + opt["weight_decay"] * p
                p.sub_(lr * u)
        del grads
    change = {k: float((w[k].detach() - start[k]).norm()) for k in w}
    return {"losses": losses, "first_grad": first_grad, "change": change}
