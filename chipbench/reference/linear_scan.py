"""Chunked forms of the two linear recurrences, in plain PyTorch, exact
in float32 up to rounding: each chunk's inner part as a masked product of
decays taken in log space (no division, nothing overflows), the chunks
chained by a short loop over their states."""
from __future__ import annotations

import torch

BLOCK_ELEMS = 1 << 26      # elements of the largest temporary in a block


def wkv6(r, k, v, logw, u, chunk: int = 16):
    """RWKV-6's recurrence from a zero state.  r, k, v, logw: (B, T, H,
    D) float32, logw = log of the decay (< 0); u: (H, D).  Per (b, h):
    o_t = r_t (S_{t-1} + diag(u) k_t^T v_t), S_t = diag(w_t) S_{t-1} +
    k_t^T v_t.  Returns o (B, T, H, D)."""
    B, T, H, D = r.shape
    pad = (-T) % chunk
    if pad:
        z = r.new_zeros(B, pad, H, D)
        r, k, v, logw = (torch.cat([a, z], 1) for a in (r, k, v, logw))
    n = (T + pad) // chunk

    def blocks(a):                                # (B, H, n, C, D)
        return a.reshape(B, n, chunk, H, D).permute(0, 3, 1, 2, 4)

    r, k, v, logw = blocks(r), blocks(k), blocks(v), blocks(logw)
    cum = torch.cumsum(logw, dim=3)               # through step t
    before = cum - logw                           # through step t - 1
    total = cum[:, :, :, -1:]                     # (B, H, n, 1, D)
    mask = torch.ones(chunk, chunk, dtype=torch.bool,
                      device=r.device).tril(-1)  # s < t
    per_chunk = B * H * chunk * chunk * D
    step = max(1, BLOCK_ELEMS // per_chunk)
    inner = []
    for c0 in range(0, n, step):
        sl = slice(c0, c0 + step)
        expo = before[:, :, sl, :, None, :] - cum[:, :, sl, None, :, :]
        expo = expo.masked_fill(~mask[:, :, None], float("-inf"))
        a = (r[:, :, sl, :, None, :] * k[:, :, sl, None, :, :]
             * torch.exp(expo)).sum(-1)           # (B, H, c, t, s)
        inner.append(a @ v[:, :, sl])
    out = torch.cat(inner, 2)
    out = out + (r * u[None, :, None, None, :] * k).sum(-1, keepdim=True) * v
    # chunk c's contribution to the state after it, then the chain
    contrib = (k * torch.exp(total - cum)).transpose(-1, -2) @ v
    decay = torch.exp(total[:, :, :, 0, :, None])  # (B, H, n, D, 1)
    S = r.new_zeros(B, H, D, D)
    entry = []
    for c in range(n):
        entry.append(S)
        S = decay[:, :, c] * S + contrib[:, :, c]
    entry = torch.stack(entry, 2)                 # (B, H, n, D, D)
    out = out + (r * torch.exp(before)) @ entry
    out = out.permute(0, 2, 3, 1, 4).reshape(B, T + pad, H, D)
    return out[:, :T]


def ssd(x, Bm, Cm, loga, dt, chunk: int = 64):
    """Mamba-2's scalar-decay recurrence from a zero state.  x: (B, T, nh,
    hp); Bm, Cm: (B, T, ds) shared by the heads; loga, dt: (B, T, nh),
    loga = log of the decay.  Per head: S_t = a_t S_{t-1} + dt_t x_t^T
    B_t, y_t = S_t C_t.  Returns y (B, T, nh, hp)."""
    Bsz, T, nh, hp = x.shape
    ds = Bm.shape[-1]
    pad = (-T) % chunk
    if pad:
        x = torch.cat([x, x.new_zeros(Bsz, pad, nh, hp)], 1)
        Bm, Cm = (torch.cat([a, a.new_zeros(Bsz, pad, ds)], 1)
                  for a in (Bm, Cm))
        loga, dt = (torch.cat([a, a.new_zeros(Bsz, pad, nh)], 1)
                    for a in (loga, dt))
    n = (T + pad) // chunk
    x = x.reshape(Bsz, n, chunk, nh, hp)
    Bm = Bm.reshape(Bsz, n, chunk, ds)
    Cm = Cm.reshape(Bsz, n, chunk, ds)
    loga = loga.reshape(Bsz, n, chunk, nh)
    dt = dt.reshape(Bsz, n, chunk, nh)
    cum = torch.cumsum(loga, dim=2)                        # (B, n, C, nh)
    mask = torch.ones(chunk, chunk, dtype=torch.bool,
                      device=x.device).tril()              # s <= t
    expo = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (B,n,t,s,nh)
    expo = expo.masked_fill(~mask[:, :, None], float("-inf"))
    cb = Cm @ Bm.transpose(-1, -2)                         # (B, n, t, s)
    w = torch.exp(expo) * cb[..., None] * dt[:, :, None, :, :]
    y = torch.einsum("bntsh,bnshp->bnthp", w, x)
    total = cum[:, :, -1]                                  # (B, n, nh)
    contrib = torch.einsum("bnsh,bnshp,bnsd->bnhpd",
                           torch.exp(total[:, :, None] - cum) * dt, x, Bm)
    S = x.new_zeros(Bsz, nh, hp, ds)
    entry = []
    for c in range(n):
        entry.append(S)
        S = torch.exp(total[:, c])[..., None, None] * S + contrib[:, c]
    entry = torch.stack(entry, 1)                          # (B,n,nh,hp,ds)
    y = y + torch.einsum("bnth,bnhpd,bntd->bnthp", torch.exp(cum), entry,
                         Cm)
    return y.reshape(Bsz, n * chunk, nh, hp)[:, :T]
