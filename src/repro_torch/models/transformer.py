"""Decoder-only transformer (PyTorch port of ``repro.models.transformer``):
GQA or MLA attention, dense SwiGLU or MoE FFN (with ``first_k_dense``
dense layers before the MoE stack), token or embedding inputs, and the
optional MTP head.

Parameters are ``nn.Module`` containers laid out like the reference's
pytree; the forward passes are plain functions over them.  A Python loop
over the layers takes the place of the reference's ``lax.scan``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from .attention import GQA, MLA, gqa_forward, mla_forward
from .common import ModelConfig, constant, rms_norm, swiglu, weight
from .moe import MoE, moe_forward


class FFN(nn.Module):
    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator],
                 device=None):
        super().__init__()
        d = cfg.d_model
        f = cfg.dense_d_ff if (cfg.moe and cfg.first_k_dense) else cfg.d_ff
        self.wi_gate = weight(gen, (d, f), cfg.dtype, device)
        self.wi_up = weight(gen, (d, f), cfg.dtype, device)
        self.wo = weight(gen, (f, d), cfg.dtype, device)


class Block(nn.Module):
    """One layer (``init_block``): MLA or GQA attention, a MoE or dense
    FFN; norms stay in float32."""

    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator],
                 device=None, moe: bool = False):
        super().__init__()
        device = gen.device if gen is not None else device
        d = cfg.d_model
        self.ln1 = constant((d,), 1.0, torch.float32, device)
        self.ln2 = constant((d,), 1.0, torch.float32, device)
        self.attn = (MLA if cfg.mla else GQA)(cfg, gen, device)
        self.ffn = (MoE if moe else FFN)(cfg, gen, device)


class MTP(nn.Module):
    """DeepSeek's multi-token-prediction head: a projection of
    [hidden ; next token's embedding] and one dense block."""

    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator],
                 device=None):
        super().__init__()
        d = cfg.d_model
        self.proj = weight(gen, (2 * d, d), cfg.dtype, device)
        self.block = Block(cfg, gen, device)


def stack_sizes(cfg: ModelConfig):
    """(dense layers, MoE layers): a MoE model's first ``first_k_dense``
    layers are dense, a dense model's all are."""
    n_moe = cfg.n_layers - cfg.first_k_dense if cfg.moe else 0
    return cfg.n_layers - n_moe, n_moe


class Transformer(nn.Module):
    """All parameters of a transformer (``init_transformer``)."""

    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator],
                 device=None):
        super().__init__()
        device = gen.device if gen is not None else device
        d = cfg.d_model
        n_dense, n_moe = stack_sizes(cfg)
        self.embed = weight(gen, (cfg.vocab, d), cfg.dtype, device,
                            scale=0.02)
        self.ln_f = constant((d,), 1.0, torch.float32, device)
        self.head = None if cfg.tie_embeddings else \
            weight(gen, (d, cfg.vocab), cfg.dtype, device)
        self.dense_layers = nn.ModuleList(Block(cfg, gen, device)
                                          for _ in range(n_dense))
        self.moe_layers = nn.ModuleList(Block(cfg, gen, device, moe=True)
                                        for _ in range(n_moe))
        self.mtp = MTP(cfg, gen, device) if cfg.mtp else None


def block_forward(p: Block, cfg: ModelConfig, x, positions, cache, lengths):
    """Returns (x, new_cache)."""
    h = rms_norm(x, p.ln1, cfg.rms_eps)
    attend = mla_forward if cfg.mla else gqa_forward
    attn_out, new_cache = attend(p.attn, cfg, h, positions, cache, lengths)
    x = x + attn_out
    h = rms_norm(x, p.ln2, cfg.rms_eps)
    if isinstance(p.ffn, MoE):
        f, _aux = moe_forward(p.ffn, cfg, h)
    else:
        f = swiglu(h, p.ffn.wi_gate, p.ffn.wi_up, p.ffn.wo)
    return x + f, new_cache


def _cache_slice(cache, i: int):
    """Layer ``i`` of a stacked cache: MLA's one tensor or GQA's (k, v)."""
    if isinstance(cache, torch.Tensor):
        return cache[i]
    return tuple(c[i] for c in cache)


def _stack(per_layer):
    if isinstance(per_layer[0], torch.Tensor):
        return torch.stack(per_layer)
    return tuple(torch.stack(c) for c in zip(*per_layer))


def transformer_apply(params: Transformer, cfg: ModelConfig,
                      tokens_or_embeds, positions,
                      caches: Optional[Dict] = None,
                      lengths: Optional[torch.Tensor] = None):
    """caches=None: prefill, causal self-attention over the inputs, which
    returns the new caches stacked per layer group ({"dense": ..., "moe":
    ...}, each GQA's (k, v) or MLA's latents); caches given: decode,
    writing the caches in place.  Returns (hidden, caches)."""
    if cfg.input_mode == "tokens":
        x = params.embed[tokens_or_embeds]
    else:
        x = tokens_or_embeds.to(cfg.dtype)
    new_caches: Dict = {}
    for key, layers in (("dense", params.dense_layers),
                        ("moe", params.moe_layers)):
        if not len(layers):
            continue
        if caches is not None:
            for i, layer in enumerate(layers):
                x, _ = block_forward(layer, cfg, x, positions,
                                     _cache_slice(caches[key], i), lengths)
            new_caches[key] = caches[key]
        else:
            per_layer = []
            for layer in layers:
                x, c = block_forward(layer, cfg, x, positions, None, None)
                per_layer.append(c)
            new_caches[key] = _stack(per_layer)
    return rms_norm(x, params.ln_f, cfg.rms_eps), new_caches


def logits_from_hidden(params: Transformer, cfg: ModelConfig, x):
    if cfg.tie_embeddings:
        return x @ params.embed.T
    return x @ params.head


def mtp_logits(params: Transformer, cfg: ModelConfig, hidden, tokens):
    """DeepSeek MTP: predict token t+2 from [h_t ; emb(token_{t+1})]."""
    emb_next = params.embed[tokens[:, 1:]]                # (B,T-1,d)
    h = torch.cat([hidden[:, :-1], emb_next], dim=-1)
    h = h.to(cfg.dtype) @ params.mtp.proj
    B, Tm1, _ = h.shape
    pos = torch.arange(Tm1, device=h.device)[None].expand(B, Tm1)
    out, _ = block_forward(params.mtp.block, cfg, h, pos, None, None)
    return logits_from_hidden(params, cfg, out)
