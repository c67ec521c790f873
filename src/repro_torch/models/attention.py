"""Grouped-query attention with RoPE (PyTorch port of the GQA half of
``repro.models.attention``; MLA is not ported yet).

Shapes: x (B, T, d); caches (B, Hkv, S, hd).  Decode takes `positions` /
`lengths` for cache bookkeeping and runs the decode-attention kernel.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..kernels.decode_attn.ops import decode_attn
from .common import ModelConfig, apply_rope, causal_mask, rope_angles, \
    weight

NEG = -1e30


class GQA(nn.Module):
    """Parameters of one attention layer (``init_gqa``), weights [in, out]
    as in the reference."""

    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator],
                 device=None):
        super().__init__()
        d, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
        self.wq = weight(gen, (d, H * hd), cfg.dtype, device)
        self.wk = weight(gen, (d, Hkv * hd), cfg.dtype, device)
        self.wv = weight(gen, (d, Hkv * hd), cfg.dtype, device)
        self.wo = weight(gen, (H * hd, d), cfg.dtype, device)


def _sdpa(q, k, v, mask):
    """q: (B,T,H,hd); k/v: (B,S,Hkv,hd); mask: (T,S) or (B,T,S)."""
    B, T, H, hd = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    qf = q.reshape(B, T, Hkv, G, hd).float()
    logits = torch.einsum("bthgd,bshd->bhgts", qf, k.float()) / (hd ** 0.5)
    if mask.ndim == 2:
        mask = mask[None]
    logits = logits.masked_fill(~mask[:, None, None], NEG)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgts,bshd->bthgd", p, v.float())
    return out.reshape(B, T, H, hd).to(q.dtype)


def gqa_forward(p: GQA, cfg: ModelConfig, x, positions,
                cache: Optional[Tuple] = None,
                lengths: Optional[torch.Tensor] = None):
    """Prefill when cache is None (causal over x itself); decode when
    cache=(k_cache, v_cache): x is the new token(s), written into the cache
    at `positions` and attended with `lengths` masking.
    Returns (out, new_cache)."""
    B, T, _ = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = (x @ p.wq).reshape(B, T, H, hd)
    k = (x @ p.wk).reshape(B, T, Hkv, hd)
    v = (x @ p.wv).reshape(B, T, Hkv, hd)
    cos, sin = rope_angles(positions, hd, cfg.rope_theta)   # (B,T,hd/2)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    if cache is None:
        out = _sdpa(q, k, v, causal_mask(T, T, device=x.device))
        new_cache = (k.transpose(1, 2), v.transpose(1, 2))
    else:
        kc, vc = cache                                   # (B, Hkv, S, hd)
        # The cache is written in place, by assignment: the port's one
        # departure from the reference's pure style.  The reference adds a
        # one-hot scatter instead, which on a reused slot sums the new K/V
        # onto the previous request's; on a slot never used before the two
        # agree.
        rows = torch.arange(B, device=x.device)[:, None].expand(B, T)
        pos = positions.long()
        kc[rows, :, pos] = k                      # kc[b, :, pos[b, t]] = k[b, t]
        vc[rows, :, pos] = v
        out = torch.stack([decode_attn(q[:, t].contiguous(), kc, vc, lengths)
                           for t in range(T)], dim=1)
        new_cache = (kc, vc)
    return out.reshape(B, T, H * hd) @ p.wo, new_cache
