"""Plain PyTorch versions of the WKV6 kernel, in kernel layout: rows
R = batch * heads, each with its own (N, N) float32 state.

  * :func:`wkv6_chunked_plain` is a straight port of the reference's
    chunk-parallel form (``repro/models/rwkv6.py::wkv_chunked``) with rows
    in place of (batch, heads) and the strictly-lower (L, L, N) pair tensor
    built one chunk at a time.  The serving path runs it for tensors on the
    CPU, or when the ``plain`` backend is asked for by name;
    ``chip_smoke.py`` holds the CUDA kernel against it on the card.
  * :func:`wkv6_step_ref` is the token-by-token recurrence (the reference's
    ``repro/kernels/wkv6/ref.py::wkv6_ref`` oracle), an independent check
    of the chunked form.

Shapes: r/k/v/log_w (R, T, N) (r/k/v any float dtype, upcast to float32;
log_w <= 0 float32); u (R, N); state (R, N, N).  Both return (out (R, T, N)
float32, state_out (R, N, N) float32) and leave ``state`` untouched.
"""

from __future__ import annotations

import torch


def wkv6_chunked_plain(r, k, v, log_w, u, state, chunk: int = 64):
    """Per chunk of L = ``chunk`` steps, lc_i = sum_{s<i} log_w_s per
    channel:

        out_i = (r_i e^{lc_i}) . S + sum_{j<i} (r_i . k_j e^{lc_i - lc_{j+1}})
                v_j + (r_i . u k_i) v_i
        S'    = diag(e^{lc_end}) S + sum_j (k_j e^{lc_end - lc_{j+1}}) v_j^T

    Every exponent is <= 0.  ``T % chunk == 0``."""
    R, T, N = r.shape
    if T % chunk:
        raise ValueError(f"sequence length {T} is not a multiple of the "
                         f"chunk {chunk}")
    L = chunk
    nc = T // L
    rs = tuple(t.to(torch.float32).reshape(R, nc, L, N)
               for t in (r, k, v, log_w))
    uf = u.to(torch.float32)
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=r.device),
                     diagonal=-1)                         # strict: j < i
    s = state.to(torch.float32)
    outs = []
    for c in range(nc):
        rc, kc, vc, wc = (t[:, c] for t in rs)            # (R, L, N)
        lc = torch.cumsum(wc, dim=1) - wc                 # lc_i = sum_{s<i}
        lc_end = lc[:, -1] + wc[:, -1]                    # (R, N)
        # cross-chunk: (r_i * e^{lc_i}) . S_prev
        r_dec = rc * torch.exp(lc)
        out = torch.einsum("rlk,rkv->rlv", r_dec, s)
        # intra-chunk pairs: A[i, j] = sum_d r_i k_j e^{lc_i - lc_{j+1}}
        lcs = lc + wc                                     # lc_{j+1}
        pair = torch.exp(lc[:, :, None, :] - lcs[:, None, :, :])
        pair = torch.where(tri[None, :, :, None], pair, 0.0)
        a_mat = (rc[:, :, None, :] * kc[:, None, :, :] * pair).sum(-1)
        out = out + torch.einsum("rlm,rmv->rlv", a_mat, vc)
        # current-token bonus: (r_i . u k_i) v_i
        bonus = (rc * uf[:, None, :] * kc).sum(-1)        # (R, L)
        out = out + bonus[..., None] * vc
        # state update
        k_dec = kc * torch.exp(lc_end[:, None, :] - lcs)
        s = torch.exp(lc_end)[..., None] * s + torch.einsum(
            "rlk,rlv->rkv", k_dec, vc)
        outs.append(out)
    return torch.stack(outs, dim=1).reshape(R, T, N), s


def wkv6_step_ref(r, k, v, log_w, u, state):
    """The token-by-token recurrence:

        out_t = r_t . (S + diag(u) k_t v_t^T)
        S     = diag(e^{log_w_t}) S + k_t v_t^T
    """
    s = state.to(torch.float32)
    uf = u.to(torch.float32)
    outs = []
    for t in range(r.shape[1]):
        rt, kt, vt = (x[:, t].to(torch.float32) for x in (r, k, v))
        kv = kt[:, :, None] * vt[:, None, :]              # (R, N, N)
        outs.append(torch.einsum("rk,rkv->rv", rt,
                                 s + uf[:, :, None] * kv))
        s = torch.exp(log_w[:, t].to(torch.float32))[:, :, None] * s + kv
    return torch.stack(outs, dim=1), s
