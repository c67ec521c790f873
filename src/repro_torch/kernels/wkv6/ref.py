"""Plain PyTorch version of the RWKV6 (Finch) WKV recurrence with
data-dependent decay.

Per (batch, head), with state S in R^{D x D}:
    o_t = r_t @ (S_{t-1} + diag(u) (k_t^T v_t))
    S_t = diag(w_t) S_{t-1} + k_t^T v_t
"""
from __future__ import annotations

from typing import Optional

import torch


def wkv6_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor,
             state0: Optional[torch.Tensor] = None):
    """r/k/v/w: (B, T, H, D); u: (H, D); state0: (B, H, D, D) or None
    (zeros).  Steps over T in float32 (in float64 for float64 r, as an
    exact yardstick); returns (out (B, T, H, D) in r's dtype, final state
    (B, H, D, D) float32, or float64 for float64 r)."""
    B, T, H, D = r.shape
    wide = torch.float64 if r.dtype == torch.float64 else torch.float32
    if state0 is None:
        S = torch.zeros((B, H, D, D), dtype=wide, device=r.device)
    else:
        S = state0.to(wide)
    uf = u.to(wide)[None, :, :, None]
    rf, kf, vf, wf = (a.to(wide) for a in (r, k, v, w))
    outs = []
    for t in range(T):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]
        outs.append((rf[:, t, :, :, None] * (S + uf * kv)).sum(-2))
        S = wf[:, t, :, :, None] * S + kv
    return torch.stack(outs, 1).to(r.dtype), S


def wkv6_chunked_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     w: torch.Tensor, u: torch.Tensor,
                     state0: Optional[torch.Tensor] = None, ct: int = 64):
    """The chunked route's algorithm in plain PyTorch (for tests and the
    card's checks; the serving path never calls it).  T is cut into chunks
    of ``ct`` steps.  Chunk 0 runs the recurrence from state0; every other
    chunk c from zeros, giving local outputs and an end state L_c.  Then
    S_{c+1} = diag(W_c) S_c + L_c with W_c the product of the chunk's
    decays, and out_t = local_t + (r_t * p_t) S_c with p_t the product of
    the chunk's decays before step t.  No division.  Returns (out in r's
    dtype, final state float32), as ``wkv6_ref``."""
    T = r.shape[1]
    rf, kf, vf, wf = (a.float() for a in (r, k, v, w))
    S = None if state0 is None else state0.float()
    outs = []
    for c0 in range(0, T, ct):
        sl = slice(c0, min(T, c0 + ct))
        local, L = wkv6_ref(rf[:, sl], kf[:, sl], vf[:, sl], wf[:, sl], u,
                            S if c0 == 0 else None)
        if c0 == 0:
            S = L
        else:
            wc = wf[:, sl]                                  # (B, n, H, D)
            p = torch.cumprod(torch.cat([torch.ones_like(wc[:, :1]),
                                         wc[:, :-1]], 1), 1)
            local = local + torch.einsum("bthd,bhde->bthe", rf[:, sl] * p, S)
            S = torch.cumprod(wc, 1)[:, -1, :, :, None] * S + L
        outs.append(local)
    return torch.cat(outs, 1).to(r.dtype), S
