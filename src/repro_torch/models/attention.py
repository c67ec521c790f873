"""Attention variants (PyTorch port of ``repro.models.attention``):
GQA/MQA/MHA with RoPE, and DeepSeek-style MLA (latent-compressed KV).

Shapes: x (B, T, d); caches (B, Hkv, S, hd) (GQA) or latent (B, S, r+rope)
(MLA).  Decode takes `positions` / `lengths` for cache bookkeeping; GQA
decode runs the decode-attention kernel, MLA is plain PyTorch as in the
reference (which has no kernel for it).
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


# ------------------------------------------------------------------ MLA
class MLA(nn.Module):
    """Parameters of one MLA layer (``init_mla``), weights [in, out]."""

    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator],
                 device=None):
        super().__init__()
        d, H = cfg.d_model, cfg.n_heads
        rq, rkv = cfg.q_lora_rank, cfg.kv_lora_rank
        dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        self.wq_a = weight(gen, (d, rq), cfg.dtype, device)
        self.wq_b = weight(gen, (rq, H * (dn + dr)), cfg.dtype, device)
        self.wkv_a = weight(gen, (d, rkv + dr), cfg.dtype, device)
        self.wkv_b = weight(gen, (rkv, H * (dn + dv)), cfg.dtype, device)
        self.wo = weight(gen, (H * dv, d), cfg.dtype, device)


def mla_forward(p: MLA, cfg: ModelConfig, x, positions,
                cache: Optional[torch.Tensor] = None,
                lengths: Optional[torch.Tensor] = None):
    """MLA with latent-KV caching: the cache holds (c_kv, k_rope), (B, S,
    rkv + dr).  Prefill when cache is None (causal over x, which returns
    the latents as the new cache); decode writes the new latents into the
    cache at `positions`, by assignment as ``gqa_forward`` does, and
    attends with `lengths` masking.  Returns (out, new_cache)."""
    B, T, _ = x.shape
    H = cfg.n_heads
    rkv, dn, dr, dv = (cfg.kv_lora_rank, cfg.qk_nope_dim, cfg.qk_rope_dim,
                       cfg.v_head_dim)
    q = ((x @ p.wq_a) @ p.wq_b).reshape(B, T, H, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    cos, sin = rope_angles(positions, dr, cfg.rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)

    ckv = x @ p.wkv_a                                     # (B,T,rkv+dr)
    c_lat, k_rope = ckv[..., :rkv], ckv[..., rkv:]
    k_rope = apply_rope(k_rope[:, :, None, :], cos, sin)[:, :, 0, :]
    lat = torch.cat([c_lat, k_rope], dim=-1)              # (B,T,rkv+dr)

    if cache is None:
        full = lat
        S = T
        mask = causal_mask(T, S, device=x.device)[None]  # (1,T,S)
    else:
        full = cache
        S = cache.shape[1]
        rows = torch.arange(B, device=x.device)[:, None].expand(B, T)
        full[rows, positions.long()] = lat
        mask = (torch.arange(S, device=x.device)[None, :]
                < lengths[:, None])[:, None, :]           # (B,1,S)
    c_all, kr_all = full[..., :rkv], full[..., rkv:]

    # up-project the latents to per-head keys and values
    kv = (c_all @ p.wkv_b).reshape(B, S, H, dn + dv)
    k_nope, v = kv[..., :dn], kv[..., dn:]
    logits = (torch.einsum("bthd,bshd->bhts", q_nope.float(),
                           k_nope.float())
              + torch.einsum("bthd,bsd->bhts", q_rope.float(),
                             kr_all.float())) / ((dn + dr) ** 0.5)
    logits = logits.masked_fill(~mask[:, None], NEG)
    pattn = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhts,bshd->bthd", pattn, v.float())
    out = out.reshape(B, T, H * dv).to(x.dtype)
    return out @ p.wo, full
