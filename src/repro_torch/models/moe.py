"""Mixture-of-Experts FFN: grouped, sort-based, capacity-bounded dispatch
(port of ``repro/models/moe.py``).

Tokens reshape to (G, T_g, D) groups; top-k routing, the stable sort,
per-expert capacity and the scatter run per group, so which tokens an
expert drops depends on the group a token falls in and on its place there
(GShard semantics: a group's earlier rows win).  ``G`` and the capacity
``C`` follow from the token count T = B * S alone, padding rows and idle
decode slots included, exactly as in the reference.

The reference's expert-parallel resharding is a single-device no-op here.
The grouped products run expert-major: the dispatch buffer is laid out as
(E, G * C, D), so each expert's weights are read once per call by one
batched product over all of its G * C rows.  Casts sit where the reference
has them: the router's logits and probabilities in float32, the expert
products in the activation dtype, ``silu`` / ``gelu`` in float32 cast back
before the gate product, the combine weight cast from float32 once.
"""

from __future__ import annotations

import itertools

import torch
import torch.nn.functional as F

from repro_torch.models import layers


def _experts(gen, shape, stddev, lead, device) -> torch.Tensor:
    """A stacked expert leaf (*lead, *shape) in bf16, drawn one leading
    index (one layer) at a time: the float32 draw of the whole stack would
    not fit beside the model at full width."""
    out = torch.empty((*lead, *shape), dtype=layers.DTYPE, device=device)
    for idx in itertools.product(*(range(n) for n in lead)):
        out[idx] = layers.truncated_normal(gen, shape, stddev, device=device)
    return out


def init_moe(gen, cfg, lead=(), device=None):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    p = {"router": layers.init_dense(gen, d, e, stddev=0.02, lead=lead,
                                     device=device)}
    std_in, std_out = d ** -0.5, f ** -0.5
    if cfg.ffn_type == "swiglu":
        p["experts_gate"] = _experts(gen, (e, d, f), std_in, lead, device)
    p["experts_up"] = _experts(gen, (e, d, f), std_in, lead, device)
    p["experts_down"] = _experts(gen, (e, f, d), std_out, lead, device)
    return p


def _num_groups(n_tokens: int) -> int:
    """Largest G in {512, 256, ..., 2} dividing T with T / G >= 8, else 1
    (the reference's rule, kept for identical capacity drops)."""
    for g in (512, 256, 128, 64, 32, 16, 8, 4, 2):
        if n_tokens % g == 0 and n_tokens // g >= 8:
            return g
    return 1


def _capacity(tokens_per_group: int, cfg) -> int:
    c = int(tokens_per_group * cfg.top_k * cfg.capacity_factor
            / cfg.num_experts)
    return max(8, -(-c // 8) * 8)


def _dispatch_indices(top_e: torch.Tensor, C: int, E: int):
    """Per-group dispatch, batched over the leading group axis.  top_e:
    (G, Tg, K) expert ids.

    Returns (slot, order, keep), each (G, Tg * K): ``order`` the stable
    sort of the group's flattened picks by expert, ``slot`` in [0, E * C]
    the sorted pick's place in its group's buffer (E * C = dropped),
    ``keep`` whether it fitted its expert's capacity C."""
    G = top_e.shape[0]
    flat_e = top_e.reshape(G, -1)
    n = flat_e.shape[1]
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    counts = torch.zeros((G, E), dtype=torch.long, device=top_e.device)
    counts.scatter_add_(1, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, dim=1) - counts
    pos = (torch.arange(n, device=top_e.device)[None]
           - torch.gather(starts, 1, sorted_e))
    keep = pos < C
    slot = torch.where(keep, sorted_e * C + pos,
                       torch.full_like(pos, E * C))
    return slot, order, keep


def route(params, xg: torch.Tensor, cfg, probe=None):
    """Router probabilities and each token's top-k: (probs (G, Tg, E)
    float32, top_p (G, Tg, K) renormalised, top_e (G, Tg, K)).  The router
    is a bf16 dense layer, so once its weight is int8 it runs the
    BitParticle matmul in exact mode whatever the model's mode.  Ties go to
    the lower expert id, as ``jax.lax.top_k`` breaks them (a stable
    descending sort)."""
    logits = layers.dense(params["router"], xg, "bf16", cfg.matmul_backend,
                          probe).to(torch.float32)
    # the reference's softmax: exp(x - max) over its sum, not a fused kernel
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    probs = e / e.sum(dim=-1, keepdim=True)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[..., :cfg.top_k], top_e[..., :cfg.top_k]
    top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)
    return probs, top_p, top_e


def moe_ffn(params, x: torch.Tensor, cfg, mode: str = "bf16", probe=None):
    """x (B, S, D) -> (B, S, D), plus the load-balancing aux loss (a
    float32 scalar).  ``mode`` is the model's matmul mode; as in the
    reference, neither the router nor the bf16 experts depend on it."""
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.top_k
    T = B * S
    G = _num_groups(T)
    Tg = T // G
    C = _capacity(Tg, cfg)
    dev, dt = x.device, x.dtype
    xg = x.reshape(G, Tg, D)

    probs, top_p, top_e = route(params, xg, cfg, probe)

    # load-balancing aux loss (Switch Transformer), over all tokens
    me = probs.mean(dim=(0, 1))
    picks = top_e.reshape(-1)
    # a scatter, not ``bincount``: that one reads the largest id back to
    # the host, a sync in every layer
    counts = torch.zeros(E, dtype=torch.long, device=dev).scatter_add_(
        0, picks, torch.ones_like(picks))
    ce = counts.to(torch.float32) * (1.0 / (T * K))
    aux = E * torch.sum(me * ce)

    # per-group dispatch, laid out expert-major: group g's slot e * C + p
    # becomes row e * (G * C) + g * C + p of one (E * G * C + 1, D) buffer,
    # whose last row collects the drops and stays zero for the combine
    slot, order, keep = _dispatch_indices(top_e, C, E)
    gc = (torch.arange(G, device=dev) * C)[:, None]
    rows = torch.where(keep, (slot // C) * (G * C) + gc + slot % C,
                       torch.full_like(slot, E * G * C))
    token_of = order // K + (torch.arange(G, device=dev) * Tg)[:, None]
    buf = torch.zeros((E * G * C + 1, D), dtype=dt, device=dev)
    buf[rows.reshape(-1)] = x.reshape(T, D)[token_of.reshape(-1)]
    buf = buf[:-1].view(E, G * C, D)

    # grouped expert FFN: one batched product per weight over all rows
    if cfg.ffn_type == "swiglu":
        g = torch.bmm(buf, params["experts_gate"].to(dt))
        u = torch.bmm(buf, params["experts_up"].to(dt))
        h = F.silu(g.to(torch.float32)).to(dt) * u
    else:
        h = F.gelu(torch.bmm(buf, params["experts_up"].to(dt)).to(
            torch.float32), approximate="tanh").to(dt)
    out_buf = torch.bmm(h, params["experts_down"].to(dt))
    out_buf = torch.cat([out_buf.reshape(E * G * C, D),
                         torch.zeros((1, D), dtype=dt, device=dev)])

    # combine: each sorted pick's row times its weight, back in token order
    weight = (torch.gather(top_p.reshape(G, Tg * K), 1, order)
              * keep).to(dt)
    gathered = out_buf[rows] * weight[..., None]          # (G, Tg * K, D)
    contrib = torch.empty_like(gathered).scatter_(
        1, order[..., None].expand(-1, -1, D), gathered)
    out = contrib.reshape(G, Tg, K, D).sum(dim=2)
    return out.reshape(B, S, D), aux
