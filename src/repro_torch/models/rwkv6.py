"""RWKV6 "Finch" block (PyTorch port of ``repro.models.rwkv6``): time-mix
with data-dependent decay (the WKV6 recurrence) and channel-mix.

The recurrence runs in ``kernels.wkv6.ops.wkv6`` (the Hopper kernel on a
card, the plain version on the CPU) where the reference runs
``_wkv6_scan``.  The cast points follow the reference exactly, because
they decide bf16 results: the decay LoRA's tanh, the decay and the
channel mix's squared relu run in float32 and cast to ``x.dtype``; the
recurrence takes the decay in ``x.dtype`` and returns its output in it.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..kernels.wkv6.ops import wkv6
from .common import ModelConfig, constant, rms_norm, weight


class RWKV6Block(nn.Module):
    """Parameters of one layer (``init_rwkv6_block``), weights [in, out];
    ``ln1``, ``ln2``, ``w_base`` and ``u`` in float32, the rest in
    ``cfg.dtype``."""

    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator],
                 device=None):
        super().__init__()
        device = gen.device if gen is not None else device
        d, f, H = cfg.d_model, cfg.d_ff, cfg.n_heads
        D, lora, dt = d // H, cfg.decay_lora_rank, cfg.dtype
        self.ln1 = constant((d,), 1.0, torch.float32, device)
        self.ln2 = constant((d,), 1.0, torch.float32, device)
        for name in ("mix_r", "mix_k", "mix_v", "mix_w"):
            setattr(self, name, constant((d,), 0.5, dt, device))
        for name in ("wr", "wk", "wv", "wo"):
            setattr(self, name, weight(gen, (d, d), dt, device))
        # data-dependent decay LoRA (the Finch contribution)
        self.w_a = weight(gen, (d, lora), dt, device, scale=0.02)
        self.w_b = weight(gen, (lora, d), dt, device, scale=0.02)
        self.w_base = constant((d,), -6.0, torch.float32, device)
        self.u = weight(gen, (H, D), torch.float32, device, scale=0.5)
        self.ck = weight(gen, (d, f), dt, device)
        self.cv = weight(gen, (f, d), dt, device)
        self.mix_c = constant((d,), 0.5, dt, device)


def _token_shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """prev: (B, 1, d), the previous segment's last token (zeros at start)."""
    return torch.cat([prev, x[:, :-1]], dim=1)


def rwkv6_block(p: RWKV6Block, cfg: ModelConfig, x: torch.Tensor,
                state: Optional[Tuple] = None):
    """x: (B, T, d).  state = (last (B, 1, d), wkv (B, H, D, D) float32,
    last_cm (B, 1, d)), or None for zeros.  Returns (x, new_state), where
    the token-shift entries hold the *normalised* last token."""
    B, T, d = x.shape
    H = cfg.n_heads
    D = d // H
    if state is None:
        last = torch.zeros((B, 1, d), dtype=x.dtype, device=x.device)
        S0 = None                                   # wkv6 starts from zeros
        last_cm = last
    else:
        last, S0, last_cm = state

    # ---- time mix (WKV6)
    xn = rms_norm(x, p.ln1, cfg.rms_eps)
    prev = _token_shift(xn, last)

    def mix(m):
        return xn + (prev - xn) * m

    r = mix(p.mix_r) @ p.wr
    k = mix(p.mix_k) @ p.wk
    v = mix(p.mix_v) @ p.wv
    wl = mix(p.mix_w) @ p.w_a
    wl = torch.tanh(wl.float()).to(x.dtype) @ p.w_b
    decay = torch.exp(-torch.exp(p.w_base + wl.float()))   # (B,T,d) in (0,1)

    def heads(a):
        return a.reshape(B, T, H, D)

    out, S = wkv6(heads(r), heads(k), heads(v), heads(decay.to(x.dtype)),
                  p.u, S0)
    x = x + out.reshape(B, T, d) @ p.wo          # out is in x.dtype

    # ---- channel mix
    xn2 = rms_norm(x, p.ln2, cfg.rms_eps)
    prev2 = _token_shift(xn2, last_cm)
    xc = xn2 + (prev2 - xn2) * p.mix_c
    h = xc @ p.ck
    h = torch.square(torch.relu(h.float())).to(x.dtype)
    x = x + h @ p.cv

    return x, (xn[:, -1:], S, xn2[:, -1:])


class RWKV6(nn.Module):
    """All parameters of an rwkv6 model (the zoo's rwkv ``init``): an
    untied head, layers in a list where the reference stacks them on L."""

    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator],
                 device=None):
        super().__init__()
        device = gen.device if gen is not None else device
        d = cfg.d_model
        self.embed = weight(gen, (cfg.vocab, d), cfg.dtype, device,
                            scale=0.02)
        self.ln_f = constant((d,), 1.0, torch.float32, device)
        self.head = weight(gen, (d, cfg.vocab), cfg.dtype, device)
        self.layers = nn.ModuleList(RWKV6Block(cfg, gen, device)
                                    for _ in range(cfg.n_layers))
