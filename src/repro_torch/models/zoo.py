"""Unified model API (PyTorch port of ``repro.models.zoo``).

    model = build_model(cfg)                  # on cuda; device="cpu" to opt out
    params = model.init(torch.Generator(device=model.device).manual_seed(0))
    logits, caches = model.prefill(params, inputs, lengths)
    caches = model.init_cache(batch, max_len)
    logits, caches = model.decode(params, caches, inputs, positions, lengths)

Ported families: the dense transformer, with the reference's cache layout
``{"dense": (k (L, B, Hkv, S, hd), v)}``, and rwkv6 (``ssm``), whose cache
is the reference's state tuple ``(last (L, B, 1, d), wkv (L, B, H, D, D)
float32, last_cm (L, B, 1, d))``.  ``decode`` writes the caches in place
and returns the same tensors.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List

import torch

from ..device import DeviceLike, resolve_device
from .common import ModelConfig, rms_norm
from .rwkv6 import RWKV6, rwkv6_block
from .transformer import Transformer, logits_from_hidden, transformer_apply


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    device: torch.device
    init: Callable                  # (generator) -> params
    prefill: Callable               # (params, inputs, lengths) -> (logits, caches)
    decode: Callable                # (params, caches, inputs, positions, lengths)
    init_cache: Callable            # (batch, max_len) -> caches


def _build_transformer(cfg: ModelConfig, device: torch.device) -> Model:
    def init(gen: torch.Generator) -> Transformer:
        if torch.device(gen.device).type != device.type:
            raise ValueError(f"generator on {gen.device}, model on {device}")
        return Transformer(cfg, gen)

    @torch.no_grad()
    def prefill(params, inputs, lengths):
        B, T = inputs.shape[0], inputs.shape[1]
        pos = torch.arange(T, device=device)[None].expand(B, T)
        h, caches = transformer_apply(params, cfg, inputs, pos)
        return logits_from_hidden(params, cfg, h[:, -1:]), caches

    @torch.no_grad()
    def decode(params, caches, inputs, positions, lengths):
        h, caches = transformer_apply(params, cfg, inputs, positions,
                                      caches=caches, lengths=lengths)
        return logits_from_hidden(params, cfg, h), caches

    def init_cache(batch: int, max_len: int) -> Dict[str, Any]:
        shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.hd)
        return {"dense": (torch.zeros(shape, dtype=cfg.dtype, device=device),
                          torch.zeros(shape, dtype=cfg.dtype, device=device))}

    return Model(cfg, device, init, prefill, decode, init_cache)


def _build_rwkv(cfg: ModelConfig, device: torch.device) -> Model:
    H = cfg.n_heads
    D = cfg.d_model // H

    def init(gen: torch.Generator) -> RWKV6:
        if torch.device(gen.device).type != device.type:
            raise ValueError(f"generator on {gen.device}, model on {device}")
        return RWKV6(cfg, gen)

    @torch.no_grad()
    def prefill(params, inputs, lengths):
        x = params.embed[inputs]
        new = []
        for layer in params.layers:
            x, st = rwkv6_block(layer, cfg, x, None)
            new.append(st)
        h = rms_norm(x, params.ln_f, cfg.rms_eps)
        states = tuple(torch.stack(s) for s in zip(*new))
        return h[:, -1:] @ params.head, states

    @torch.no_grad()
    def decode(params, states, inputs, positions, lengths):
        x = params.embed[inputs]
        for i, layer in enumerate(params.layers):
            x, new = rwkv6_block(layer, cfg, x, tuple(s[i] for s in states))
            for full, s in zip(states, new):
                full[i] = s
        h = rms_norm(x, params.ln_f, cfg.rms_eps)
        return h @ params.head, states

    def init_cache(batch: int, max_len: int):
        L = cfg.n_layers        # O(1) state: max_len-independent
        return (torch.zeros((L, batch, 1, cfg.d_model), dtype=cfg.dtype,
                            device=device),
                torch.zeros((L, batch, H, D, D), dtype=torch.float32,
                            device=device),
                torch.zeros((L, batch, 1, cfg.d_model), dtype=cfg.dtype,
                            device=device))

    return Model(cfg, device, init, prefill, decode, init_cache)


def cache_tensors(caches: Any) -> List[torch.Tensor]:
    """The tensors of a cache of either family, in a fixed order."""
    if isinstance(caches, torch.Tensor):
        return [caches]
    if isinstance(caches, dict):
        caches = [caches[key] for key in sorted(caches)]
    return [t for c in caches for t in cache_tensors(c)]


def build_model(cfg: ModelConfig, device: DeviceLike = None) -> Model:
    device = resolve_device(device)
    if cfg.family == "ssm":
        return _build_rwkv(cfg, device)
    if cfg.family == "hybrid":
        raise NotImplementedError(
            f"{cfg.name}: the zamba2 hybrid family is not ported yet "
            "(ROADMAP queue A, item 4)")
    if cfg.moe or cfg.mla or cfg.mtp:
        raise NotImplementedError(
            f"{cfg.name}: MoE, MLA and MTP are not ported yet "
            "(ROADMAP queue A, item 4)")
    if cfg.input_mode != "tokens":
        raise NotImplementedError(
            f"{cfg.name}: embedding inputs (audio/vlm backbones) are not "
            "ported yet (ROADMAP queue A, item 4)")
    return _build_transformer(cfg, device)
