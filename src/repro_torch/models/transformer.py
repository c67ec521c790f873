"""Dense decoder-only transformer (PyTorch port of the dense path of
``repro.models.transformer``; MoE and MTP are not ported yet).

Parameters are ``nn.Module`` containers laid out like the reference's
pytree; the forward passes are plain functions over them.  A Python loop
over the layers takes the place of the reference's ``lax.scan``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from .attention import GQA, gqa_forward
from .common import ModelConfig, rms_norm, swiglu, weight


class FFN(nn.Module):
    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator],
                 device=None):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        self.wi_gate = weight(gen, (d, f), cfg.dtype, device)
        self.wi_up = weight(gen, (d, f), cfg.dtype, device)
        self.wo = weight(gen, (f, d), cfg.dtype, device)


class Block(nn.Module):
    """One dense layer (``init_block``); norms stay in float32."""

    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator],
                 device=None):
        super().__init__()
        device = gen.device if gen is not None else device
        d = cfg.d_model
        self.ln1 = nn.Parameter(torch.ones(d, device=device),
                                requires_grad=False)
        self.ln2 = nn.Parameter(torch.ones(d, device=device),
                                requires_grad=False)
        self.attn = GQA(cfg, gen, device)
        self.ffn = FFN(cfg, gen, device)


class Transformer(nn.Module):
    """All parameters of a dense model (``init_transformer``)."""

    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator],
                 device=None):
        super().__init__()
        device = gen.device if gen is not None else device
        d = cfg.d_model
        self.embed = weight(gen, (cfg.vocab, d), cfg.dtype, device,
                            scale=0.02)
        self.ln_f = nn.Parameter(torch.ones(d, device=device),
                                 requires_grad=False)
        self.head = None if cfg.tie_embeddings else \
            weight(gen, (d, cfg.vocab), cfg.dtype, device)
        self.layers = nn.ModuleList(Block(cfg, gen, device)
                                    for _ in range(cfg.n_layers))


def block_forward(p: Block, cfg: ModelConfig, x, positions, cache, lengths):
    """Returns (x, new_cache)."""
    h = rms_norm(x, p.ln1, cfg.rms_eps)
    attn_out, new_cache = gqa_forward(p.attn, cfg, h, positions, cache,
                                      lengths)
    x = x + attn_out
    h = rms_norm(x, p.ln2, cfg.rms_eps)
    f = swiglu(h, p.ffn.wi_gate, p.ffn.wi_up, p.ffn.wo)
    return x + f, new_cache


def transformer_apply(params: Transformer, cfg: ModelConfig, tokens,
                      positions, caches: Optional[Dict] = None,
                      lengths: Optional[torch.Tensor] = None):
    """caches=None: prefill, causal self-attention over the inputs, which
    returns the new K/V stacked per layer; caches given: decode, writing
    the caches in place.  Returns (hidden, caches)."""
    x = params.embed[tokens]
    if caches is not None:
        kc, vc = caches["dense"]
        for i, layer in enumerate(params.layers):
            x, _ = block_forward(layer, cfg, x, positions, (kc[i], vc[i]),
                                 lengths)
    else:
        ks, vs = [], []
        for layer in params.layers:
            x, (k, v) = block_forward(layer, cfg, x, positions, None, None)
            ks.append(k)
            vs.append(v)
        caches = {"dense": (torch.stack(ks), torch.stack(vs))}
    return rms_norm(x, params.ln_f, cfg.rms_eps), caches


def logits_from_hidden(params: Transformer, cfg: ModelConfig, x):
    if cfg.tie_embeddings:
        return x @ params.embed.T
    return x @ params.head
