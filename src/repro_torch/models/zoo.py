"""Unified model API (PyTorch port of ``repro.models.zoo``).

    model = build_model(cfg)                  # on cuda; device="cpu" to opt out
    params = model.init(torch.Generator(device=model.device).manual_seed(0))
    logits, caches = model.prefill(params, inputs, lengths)
    caches = model.init_cache(batch, max_len)
    logits, caches = model.decode(params, caches, inputs, positions, lengths)

Only the dense transformer family is ported; the cache layout is the
reference's, ``{"dense": (k (L, B, Hkv, S, hd), v)}``.  ``decode`` writes
the caches in place and returns the same tensors.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict

import torch

from ..device import DeviceLike, resolve_device
from .common import ModelConfig
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


def build_model(cfg: ModelConfig, device: DeviceLike = None) -> Model:
    device = resolve_device(device)
    if cfg.family == "ssm":
        raise NotImplementedError(
            f"{cfg.name}: the rwkv6 family is not ported yet "
            "(ROADMAP queue A, item 1)")
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
