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
    (zeros).  Steps over T in float32; returns (out (B, T, H, D) in r's
    dtype, final state (B, H, D, D) float32)."""
    B, T, H, D = r.shape
    if state0 is None:
        S = torch.zeros((B, H, D, D), dtype=torch.float32, device=r.device)
    else:
        S = state0.float()
    uf = u.float()[None, :, :, None]
    rf, kf, vf, wf = (a.float() for a in (r, k, v, w))
    outs = []
    for t in range(T):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]
        outs.append((rf[:, t, :, :, None] * (S + uf * kv)).sum(-2))
        S = wf[:, t, :, :, None] * S + kv
    return torch.stack(outs, 1).to(r.dtype), S
