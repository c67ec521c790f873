"""Mixture-of-Experts FFN with top-k routing (PyTorch port of
``repro.models.moe``): llama4-style top-1 and DeepSeek-V3-style 1 shared
+ top-8.

Capacity-based dispatch, step for step as the reference: per-expert
buffers of ``C`` token slots, choices ranked k-major within each expert,
choices past ``C`` dropped, and the Switch-style load-balance aux loss.
The expert products are batched over the expert axis.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .common import ModelConfig, weight


class SharedExpert(nn.Module):
    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator],
                 device=None):
        super().__init__()
        d, fs = cfg.d_model, cfg.moe_d_ff * cfg.n_shared_experts
        self.wi_gate = weight(gen, (d, fs), cfg.dtype, device)
        self.wi_up = weight(gen, (d, fs), cfg.dtype, device)
        self.wo = weight(gen, (fs, d), cfg.dtype, device)


class MoE(nn.Module):
    """Parameters of one MoE FFN (``init_moe``): the router in float32,
    the experts stacked on a leading axis E, weights [in, out]."""

    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator],
                 device=None):
        super().__init__()
        d, E, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
        self.router = weight(gen, (d, E), torch.float32, device, scale=0.02)
        self.wi_gate = weight(gen, (E, d, f), cfg.dtype, device)
        self.wi_up = weight(gen, (E, d, f), cfg.dtype, device)
        self.wo = weight(gen, (E, f, d), cfg.dtype, device)
        self.shared = SharedExpert(cfg, gen, device) \
            if cfg.n_shared_experts else None


def capacity(n_tokens: int, cfg: ModelConfig,
             capacity_factor: Optional[float] = None) -> int:
    """Token slots per expert.  The reference's docstring says ceil; its
    code truncates, and so does this."""
    cf = (capacity_factor if capacity_factor is not None
          else cfg.moe_capacity_factor)
    return max(1, min(n_tokens, int((n_tokens * cfg.top_k / cfg.n_experts)
                                    * cf)))


def moe_route(router: torch.Tensor, xf: torch.Tensor, k: int, C: int):
    """Routes the tokens ``xf`` (N, d) to their top-``k`` experts.

    Returns (probs (N, E) float32, gates (N, k) float32 renormalised, idx
    (N, k) expert ids, keep (N, k) bool, slot (N, k)): a choice's slot is
    its rank among the choices of its expert, counted k-major (every
    token's first choice before any second choice), and a choice ranked
    ``C`` or later is dropped and sent to slot ``C``."""
    E = router.shape[1]
    probs = torch.softmax(xf.float() @ router, dim=-1)
    gates, idx = torch.topk(probs, k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    onehot = F.one_hot(idx, E)                              # (N, k, E)
    flat = onehot.transpose(0, 1).reshape(-1, E)             # k-major
    ranks = torch.cumsum(flat, dim=0) - flat
    rank_of = (ranks * flat).sum(-1).reshape(k, -1).T        # (N, k)
    keep = rank_of < C
    slot = torch.where(keep, rank_of, C)
    return probs, gates, idx, keep, slot


def moe_forward(p: MoE, cfg: ModelConfig, x: torch.Tensor,
                capacity_factor: Optional[float] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, T, d) -> (out, aux_loss)."""
    B, T, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    N = B * T
    C = capacity(N, cfg, capacity_factor)
    xf = x.reshape(N, d)
    probs, gates, idx, keep, slot = moe_route(p.router, xf, k, C)

    # Token slots (E, C + 1, d); slot C is the drop bucket.  Kept choices
    # have distinct (expert, slot) pairs, so they are assigned; only the
    # bucket receives duplicates, and it is thrown away.
    exp_idx = idx.reshape(-1)
    slot_idx = slot.reshape(-1)
    xe = torch.zeros((E, C + 1, d), dtype=x.dtype, device=x.device)
    xe[exp_idx, slot_idx] = xf.repeat_interleave(k, dim=0)
    xe = xe[:, :C]

    g = torch.bmm(xe, p.wi_gate)
    u = torch.bmm(xe, p.wi_up)
    h = F.silu(g.float()).to(x.dtype) * u
    ye = torch.bmm(h, p.wo)                                  # (E, C, d)

    gathered = ye[exp_idx, slot_idx.clamp_max(C - 1)]        # (N*k, d)
    gathered = gathered * keep.reshape(-1, 1).to(x.dtype)
    out = (gathered * gates.reshape(-1, 1).to(x.dtype)).reshape(N, k, d) \
        .sum(1)
    if p.shared is not None:
        s = p.shared
        hs = F.silu((xf @ s.wi_gate).float()).to(x.dtype) * (xf @ s.wi_up)
        out = out + hs @ s.wo

    # Switch-style load-balance aux loss
    me = probs.mean(0)
    ce = F.one_hot(idx[:, 0], E).float().mean(0)
    aux = E * torch.sum(me * ce)
    return out.reshape(B, T, d), aux
