"""Unified model API (PyTorch port of ``repro.models.zoo``).

    model = build_model(cfg)                  # on cuda; device="cpu" to opt out
    params = model.init(torch.Generator(device=model.device).manual_seed(0))
    logits, aux = model.train_logits(params, tokens_or_embeds)
    logits, caches = model.prefill(params, inputs, lengths)
    caches = model.init_cache(batch, max_len)
    logits, caches = model.decode(params, caches, inputs, positions, lengths)

Families, each with the reference's cache layout:
  dense/moe/audio/vlm -> transformer.py (GQA or MLA, dense or MoE FFN,
                         tokens or embeddings in): ``{"dense": ..., "moe":
                         ...}``, each GQA's ``(k (n, B, Hkv, S, hd), v)``
                         or MLA's latents ``(n, B, S, kv_lora_rank +
                         qk_rope_dim)``; ``mtp_logits`` when ``cfg.mtp``
  ssm                 -> rwkv6: ``(last (L, B, 1, d), wkv (L, B, H, D, D)
                         float32, last_cm (L, B, 1, d))``
  hybrid              -> zamba2: Mamba2 layers with one *shared* attention
                         block applied after every ``cfg.attn_every``-th:
                         ``((conv (L, B, K-1, C), ssm (L, B, nh, hp, ds)
                         float32), (k (n_apps, B, Hkv, S, hd), v))``, one
                         K/V slot per application
``decode`` writes the caches in place and returns the same tensors.
``prefill`` and ``decode`` run without gradients; ``train_logits`` records
them for whichever parameters require them (``Model.init`` leaves every
parameter frozen; ``repro_torch.train`` turns gradients on for the module
it trains).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from .common import ModelConfig, constant, rms_norm, weight
from .mamba2 import Mamba2Block, mamba2_block, mamba_dims
from .rwkv6 import RWKV6, rwkv6_block
from .transformer import (Block, Transformer, block_forward,
                          logits_from_hidden, mtp_logits, stack_sizes,
                          transformer_apply, transformer_train)


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    device: torch.device
    init: Callable                  # (generator) -> params
    train_logits: Callable          # (params, inputs, remat) -> (logits, aux)
    prefill: Callable               # (params, inputs, lengths) -> (logits, caches)
    decode: Callable                # (params, caches, inputs, positions, lengths)
    init_cache: Callable            # (batch, max_len) -> caches
    mtp_logits: Optional[Callable] = None   # (params, hidden, tokens)


def _positions(B: int, T: int, device: torch.device) -> torch.Tensor:
    return torch.arange(T, device=device)[None].expand(B, T)


def _no_aux(device: torch.device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=device)


def _check_gen(gen: torch.Generator, device: torch.device) -> None:
    if torch.device(gen.device).type != device.type:
        raise ValueError(f"generator on {gen.device}, model on {device}")


def _build_transformer(cfg: ModelConfig, device: torch.device) -> Model:
    def init(gen: torch.Generator) -> Transformer:
        _check_gen(gen, device)
        return Transformer(cfg, gen)

    def train_logits(params, inputs, remat: bool = True):
        B, T = inputs.shape[0], inputs.shape[1]
        h, aux = transformer_train(params, cfg, inputs,
                                   _positions(B, T, device), remat=remat)
        return logits_from_hidden(params, cfg, h), aux

    @torch.no_grad()
    def prefill(params, inputs, lengths):
        B, T = inputs.shape[0], inputs.shape[1]
        h, caches = transformer_apply(params, cfg, inputs,
                                      _positions(B, T, device))
        return logits_from_hidden(params, cfg, h[:, -1:]), caches

    @torch.no_grad()
    def decode(params, caches, inputs, positions, lengths):
        h, caches = transformer_apply(params, cfg, inputs, positions,
                                      caches=caches, lengths=lengths)
        return logits_from_hidden(params, cfg, h), caches

    def init_cache(batch: int, max_len: int) -> Dict[str, Any]:
        def zeros(*shape):
            return torch.zeros(shape, dtype=cfg.dtype, device=device)

        def one(n: int):
            if cfg.mla:
                return zeros(n, batch, max_len,
                             cfg.kv_lora_rank + cfg.qk_rope_dim)
            return tuple(zeros(n, batch, cfg.n_kv_heads, max_len, cfg.hd)
                         for _ in "kv")

        return {key: one(n) for key, n in zip(("dense", "moe"),
                                              stack_sizes(cfg)) if n}

    mtp = None
    if cfg.mtp:
        @torch.no_grad()
        def mtp(params, hidden, tokens):  # noqa: F811
            return mtp_logits(params, cfg, hidden, tokens)

    return Model(cfg, device, init, train_logits, prefill, decode,
                 init_cache, mtp_logits=mtp)


def _build_rwkv(cfg: ModelConfig, device: torch.device) -> Model:
    H = cfg.n_heads
    D = cfg.d_model // H

    def init(gen: torch.Generator) -> RWKV6:
        _check_gen(gen, device)
        return RWKV6(cfg, gen)

    def train_logits(params, inputs, remat: bool = True):
        """From the zero state, the head on every position; the reference
        takes ``remat`` here and does not use it, nor does this."""
        del remat
        x = params.embed[inputs]
        for layer in params.layers:
            x, _state = rwkv6_block(layer, cfg, x, None)
        h = rms_norm(x, params.ln_f, cfg.rms_eps)
        return h @ params.head, _no_aux(device)

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

    return Model(cfg, device, init, train_logits, prefill, decode,
                 init_cache)


class Zamba2(nn.Module):
    """All parameters of a zamba2 model (the zoo's zamba ``init``): an
    untied head, the Mamba2 layers and the one shared transformer
    block."""

    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator],
                 device=None):
        super().__init__()
        device = gen.device if gen is not None else device
        d = cfg.d_model
        self.embed = weight(gen, (cfg.vocab, d), cfg.dtype, device,
                            scale=0.02)
        self.ln_f = constant((d,), 1.0, torch.float32, device)
        self.head = weight(gen, (d, cfg.vocab), cfg.dtype, device)
        self.layers = nn.ModuleList(Mamba2Block(cfg, gen, device)
                                    for _ in range(cfg.n_layers))
        self.shared = Block(cfg, gen, device)


def _build_zamba(cfg: ModelConfig, device: torch.device) -> Model:
    every = cfg.attn_every
    n_apps = cfg.n_layers // every

    def init(gen: torch.Generator) -> Zamba2:
        _check_gen(gen, device)
        return Zamba2(cfg, gen)

    def _apply(params, x, m_states, a_caches, positions, lengths):
        """Decode when ``a_caches`` is given: every state and cache is
        written in place.  Prefill otherwise, from zero states: returns
        the new states and the shared block's K/V of each application,
        stacked."""
        new_m, new_a = [], []
        for i, layer in enumerate(params.layers):
            mst = None if m_states is None else (m_states[0][i],
                                                 m_states[1][i])
            x, mst = mamba2_block(layer, cfg, x, mst)
            if m_states is None:
                new_m.append(mst)
            else:
                for full, s in zip(m_states, mst):
                    full[i] = s
            if (i + 1) % every == 0:
                slot = i // every
                cache = None if a_caches is None else \
                    (a_caches[0][slot], a_caches[1][slot])
                x, kv, _ = block_forward(params.shared, cfg, x, positions,
                                         cache, lengths)
                new_a.append(kv)
        h = rms_norm(x, params.ln_f, cfg.rms_eps)
        if a_caches is not None:
            return h, (m_states, a_caches)
        return h, (tuple(torch.stack(s) for s in zip(*new_m)),
                   tuple(torch.stack(c) for c in zip(*new_a)))

    def train_logits(params, inputs, remat: bool = True):
        """The reference's ``"train"`` mode of ``_apply``: zero Mamba2
        states, the shared block causal over the inputs, no cache kept;
        ``remat`` is taken and not used, as in the reference."""
        del remat
        B, T = inputs.shape
        pos = _positions(B, T, device)
        x = params.embed[inputs]
        for i, layer in enumerate(params.layers):
            x, _state = mamba2_block(layer, cfg, x, None)
            if (i + 1) % every == 0:
                x, _kv, _ = block_forward(params.shared, cfg, x, pos, None,
                                          None)
        h = rms_norm(x, params.ln_f, cfg.rms_eps)
        return h @ params.head, _no_aux(device)

    @torch.no_grad()
    def prefill(params, inputs, lengths):
        B, T = inputs.shape
        h, caches = _apply(params, params.embed[inputs], None, None,
                           _positions(B, T, device), lengths)
        return h[:, -1:] @ params.head, caches

    @torch.no_grad()
    def decode(params, caches, inputs, positions, lengths):
        m_states, a_caches = caches
        h, caches = _apply(params, params.embed[inputs], m_states, a_caches,
                           positions, lengths)
        return h @ params.head, caches

    def init_cache(batch: int, max_len: int):
        d_inner, nh, hp, ds = mamba_dims(cfg)
        L, K = cfg.n_layers, cfg.conv_kernel
        conv_dim = d_inner + 2 * ds
        kv = (n_apps, batch, cfg.n_kv_heads, max_len, cfg.hd)
        return ((torch.zeros((L, batch, K - 1, conv_dim), dtype=cfg.dtype,
                             device=device),
                 torch.zeros((L, batch, nh, hp, ds), dtype=torch.float32,
                             device=device)),
                (torch.zeros(kv, dtype=cfg.dtype, device=device),
                 torch.zeros(kv, dtype=cfg.dtype, device=device)))

    return Model(cfg, device, init, train_logits, prefill, decode,
                 init_cache)


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
        return _build_zamba(cfg, device)
    return _build_transformer(cfg, device)
