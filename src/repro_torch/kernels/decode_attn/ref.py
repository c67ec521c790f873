"""Plain PyTorch version of single-token GQA decode attention."""
from __future__ import annotations

import torch


def decode_attn_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    lengths: torch.Tensor, scale=None) -> torch.Tensor:
    """q: (B, H, D); k/v: (B, Hkv, S, D); lengths: (B,) valid cache length.
    Returns (B, H, D).  H must be a multiple of Hkv (GQA)."""
    B, H, D = q.shape
    _, Hkv, S, _ = k.shape
    G = H // Hkv
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    qf = q.reshape(B, Hkv, G, D).float()
    logits = torch.einsum("bhgd,bhsd->bhgs", qf, k.float()) * scale
    mask = torch.arange(S, device=q.device)[None, :] < lengths[:, None]
    logits = logits.masked_fill(~mask[:, None, None, :], -1e30)
    probs = torch.exp(logits - logits.amax(-1, keepdim=True))
    probs = probs / probs.sum(-1, keepdim=True)
    out = torch.einsum("bhgs,bhsd->bhgd", probs, v.float())
    return out.reshape(B, H, D).to(q.dtype)
