"""Mamba-2 (SSD) blocks for the Zamba2 hybrid backbone (port of
``repro/models/mamba2.py``)  [arXiv:2405.21060].

State-space duality form with scalar-per-head decay:

    h_t = a_t h_{t-1} + dt_t (B_t (x) x_t)        h: (heads, P, N)
    y_t = C_t . h_t + D x_t                        a_t = exp(-dt_t * A_head)

``ssd_chunked`` is the matmul-parallel chunked evaluation (prefill);
``ssd_step`` the O(1) recurrence (decode), ``ssd_sequential`` the step
scan (prefill lengths that are not a multiple of the chunk).  A short
causal conv runs on (x, B, C) first.

The SSD is XLA in the reference, with no Pallas kernel, so these are plain
PyTorch: float32 einsums in the reference's order (TF32 stays off, the
PyTorch default for float32 products on the GPU).  ``mamba2_block`` takes
the chunked form exactly where the reference does, since the two forms
round differently.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers


def d_inner(cfg) -> int:
    return 2 * cfg.d_model


def n_ssm_heads(cfg) -> int:
    return d_inner(cfg) // cfg.ssm_head_dim


def conv_dim(cfg) -> int:
    return d_inner(cfg) + 2 * cfg.ssm_state


def init_mamba2(gen, cfg, lead=(), device=None):
    """One mixer's parameters (every leaf with leading ``lead`` axes)."""
    d, di, n, h = cfg.d_model, d_inner(cfg), cfg.ssm_state, n_ssm_heads(cfg)
    cd = conv_dim(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        # projects to [z (di), x (di), B (n), C (n), dt (h)]
        "in_proj": layers.init_dense(gen, d, 2 * di + 2 * n + h, lead=lead,
                                     device=device),
        "conv_w": layers.truncated_normal(gen, (*lead, cfg.ssm_conv_width,
                                                cd), cd ** -0.5,
                                          torch.float32, device),
        "conv_b": torch.zeros(*lead, cd, **f32),
        "A_log": torch.zeros(*lead, h, **f32),     # A = exp(A_log) > 0
        "D": torch.ones(*lead, h, **f32),
        "dt_bias": torch.full((*lead, h), -2.0, **f32),
        "norm": layers.init_rmsnorm(di, lead, device),
        "out_proj": layers.init_dense(gen, di, d, lead=lead, device=device),
    }


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                state=None):
    """Depthwise causal conv: x (B, S, C); w (W, C); ``state`` (B, W-1, C)
    the carry of a streaming decode (zeros when None).  Sums the taps in
    x's dtype from 0, adds the bias, then SiLU in float32, as the
    reference does.  Returns (y, new_state)."""
    W = w.shape[0]
    S = x.shape[1]
    if state is None:
        state = torch.zeros(x.shape[0], W - 1, x.shape[-1], dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state, x], dim=1)
    y = 0
    for i in range(W):
        y = y + xp[:, i:i + S, :] * w[i].to(x.dtype)
    y = y + b.to(x.dtype)
    new_state = xp[:, -(W - 1):, :]
    return F.silu(y.to(torch.float32)).to(x.dtype), new_state


def ssd_step(xh, Bt, Ct, dt, A, state):
    """xh (B,H,P); Bt/Ct (B,N); dt (B,H); state (B,H,P,N), all float32.
    Returns (y (B,H,P), new state)."""
    a = torch.exp(-dt * A)                                    # (B,H)
    upd = (dt[..., None] * xh)[..., :, None] * Bt[:, None, None, :]
    state = a[..., None, None] * state + upd
    y = torch.einsum("bhpn,bn->bhp", state, Ct)
    return y, state


def ssd_sequential(xh, Bseq, Cseq, dt, A, state):
    """Step scan.  xh (B,S,H,P); Bseq/Cseq (B,S,N); dt (B,S,H)."""
    ys = []
    for t in range(xh.shape[1]):
        y, state = ssd_step(xh[:, t], Bseq[:, t], Cseq[:, t], dt[:, t], A,
                            state)
        ys.append(y)
    return torch.stack(ys, dim=1), state


def ssd_chunked(xh, Bseq, Cseq, dt, A, state, chunk: int = 64):
    """Chunked-parallel SSD, equal to ``ssd_sequential`` up to rounding.

    The scalar-per-head log-decay lc makes the pairwise factor an (L, L)
    matrix per head: y_intra = (M ⊙ (C B^T)) (dt*x)."""
    B, S, H, P = xh.shape
    N = Bseq.shape[-1]
    if S % chunk:
        raise ValueError(f"S={S} is not a multiple of the chunk {chunk}")
    L, nc = chunk, S // chunk
    f32 = torch.float32
    xs = xh.to(f32).reshape(B, nc, L, H, P)
    bs = Bseq.to(f32).reshape(B, nc, L, N)
    cs = Cseq.to(f32).reshape(B, nc, L, N)
    dts = dt.reshape(B, nc, L, H)
    tri = torch.tril(torch.ones(L, L, dtype=torch.bool, device=xh.device))
    ys = []
    for c in range(nc):
        xc, bc, cc, dtc = xs[:, c], bs[:, c], cs[:, c], dts[:, c]
        la = -dtc * A                                         # (B,L,H)
        lc = torch.cumsum(la, dim=1)                          # inclusive
        # cross-chunk: y_i += exp(lc_i) C_i . S_prev
        y = torch.einsum("bln,bhpn,blh->blhp", cc, state, torch.exp(lc))
        # intra-chunk: decay from j to i is exp(lc_i - lc_j) for j <= i
        pair = torch.exp(lc[:, :, None] - lc[:, None, :])     # (B,L,L,H)
        pair = torch.where(tri[None, :, :, None], pair, 0.0)
        score = torch.einsum("bln,bmn->blm", cc, bc)          # (B,L,L)
        xdt = xc * dtc[..., None]                             # (B,L,H,P)
        y = y + torch.einsum("blm,blmh,bmhp->blhp", score, pair, xdt)
        lc_end = lc[:, -1]                                    # (B,H)
        bdec = torch.exp(lc_end[:, None] - lc)                # (B,L,H)
        state = (torch.exp(lc_end)[..., None, None] * state
                 + torch.einsum("blh,bln,blhp->bhpn", bdec, bc, xdt))
        ys.append(y)
    return torch.stack(ys, dim=1).reshape(B, S, H, P), state


def mamba2_block(p, x: torch.Tensor, cfg, mode: str, *, conv_state=None,
                 ssm_state=None, chunk: int = 64, single_step: bool = False):
    """The full Mamba-2 mixer.  Returns (y, conv_state, ssm_state)."""
    Bsz, S, _ = x.shape
    di, n, h = d_inner(cfg), cfg.ssm_state, n_ssm_heads(cfg)
    P = cfg.ssm_head_dim
    be = cfg.matmul_backend
    zxbcdt = layers.dense(p["in_proj"], x, mode, be)
    z, xi, Bf, Cf, dt = torch.split(zxbcdt, [di, di, n, n, h], dim=-1)
    conv_in = torch.cat([xi, Bf, Cf], dim=-1)
    conv_out, conv_state = causal_conv(conv_in, p["conv_w"], p["conv_b"],
                                       conv_state)
    xi, Bf, Cf = torch.split(conv_out, [di, n, n], dim=-1)
    f32 = torch.float32
    dt = torch.logaddexp(dt.to(f32) + p["dt_bias"],
                         torch.zeros((), dtype=f32, device=x.device))
    A = torch.exp(p["A_log"])
    xh = xi.reshape(Bsz, S, h, P)
    if ssm_state is None:
        ssm_state = torch.zeros(Bsz, h, P, n, dtype=f32, device=x.device)
    if single_step:
        y, ssm_state = ssd_step(xh[:, 0].to(f32), Bf[:, 0].to(f32),
                                Cf[:, 0].to(f32), dt[:, 0], A, ssm_state)
        y = y[:, None]
    elif S % chunk == 0 and S > 1:
        y, ssm_state = ssd_chunked(xh, Bf, Cf, dt, A, ssm_state, chunk)
    else:
        y, ssm_state = ssd_sequential(xh.to(f32), Bf.to(f32), Cf.to(f32),
                                      dt, A, ssm_state)
    y = y + p["D"][:, None] * xh.to(f32)
    y = y.reshape(Bsz, S, di).to(x.dtype)
    y = layers.rms_norm(p["norm"], y) * F.silu(z.to(f32)).to(x.dtype)
    return layers.dense(p["out_proj"], y, mode, be), conv_state, ssm_state
